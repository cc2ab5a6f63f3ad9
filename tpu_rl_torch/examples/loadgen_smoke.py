"""Load-plane smoke — the port of ``tpu_rl``'s ``examples/loadgen_smoke.py``:
a real two-replica inference fleet under a synthetic 12000-client open-loop
sweep, with a SIGKILL of one replica mid-sweep.

- two :func:`~tpu_rl_torch.fleet.replica_main` processes (continuous
  batching, version-keyed swaps fed by a live model PUB publishing rising
  versions) serve the checked ``inference_base_port`` range, each act step
  through kernel B3 (``act_kernel="pallas"``; its plain version on the CPU);
- :func:`~tpu_rl_torch.loadgen.run_loadgen` sweeps three offered-load
  plateaus from 2 driver processes standing for 12000 synthetic clients,
  grading each stage through a fresh SLO engine and writing
  ``<result-dir>/loadgen.json``;
- one replica is SIGKILLed mid-sweep: hedged retries absorb the loss.
  The victim is the replica that served more of the sweep so far (its
  snapshots' ``inference-replies``), so that the kill bites: with two
  lanes, power-of-two choices sends everything to the lane of lower RTT,
  and ``tpu_rl``'s fixed victim (replica 1) may be carrying nothing.

``tpu_rl``'s bars: overall success >= 99.9%; the per-stage version floor
never decreases (and rises above 0); the first stage GREEN on
``p99:inference-rtt<250ms``; every stage's ``counter:inference-xla-
recompiles==0`` a hard GREEN against the replicas' own snapshots (the
replicas serve a bucket ladder, [8, 16], with telemetry on, and the
per-bucket signature watch must read 0 after warm-up); and hedges or
failovers after the kill. :func:`run` returns the document, the replicas'
last snapshots and the failed bars; ``kill_at=None`` runs a sweep without
a kill and without bars (a saturation curve).

The replicas run on the card, or on the CPU with ``--device cpu``
(``learner_device="cpu"``). Exits nonzero on any failure.

Run:
  python -m tpu_rl_torch.examples.loadgen_smoke \\
      [--clients 12000] [--base-port 31400] [--kill-at 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import tempfile
import threading
import time

SLO_SPEC = "p99:inference-rtt<250ms@window=60s,counter:inference-xla-recompiles==0"


def fleet_config(base_port: int, result_dir: str, device: str = "cuda"):
    """``tpu_rl``'s loadgen-smoke config (IMPALA, obs 4, 2 actions, H 32,
    ladder [8, 16], 1500 ms timeout, 150 ms hedge, telemetry on through
    ``result_dir``), acting through B3."""
    from tpu_rl_torch.config import Config

    return Config.from_dict(dict(
        algo="IMPALA", obs_shape=(4,), action_space=2, hidden_size=32,
        worker_num_envs=1, act_mode="remote", act_kernel="pallas",
        inference_replicas=2, inference_base_port=base_port,
        inference_batch=16, inference_flush_us=500,
        inference_timeout_ms=1500, inference_hedge_ms=150,
        inference_retries=1, inference_buckets=8, result_dir=result_dir,
        telemetry_interval_s=1.0, learner_device="cpu" if device == "cpu" else "auto",
    ))


def run(
    clients: int = 12_000,
    base_port: int = 31400,
    rates: tuple[float, ...] = (100.0, 250.0, 600.0),
    duration: float = 6.0,
    kill_at: float | None = 8.0,
    result_dir: str | None = None,
    device: str = "cuda",
) -> tuple[dict, dict[int, dict], list[str]]:
    """One sweep against a fresh two-replica fleet: ``(loadgen document,
    {rid: the replica's last telemetry snapshot}, failed bars)``; the
    document also names the replica killed (``killed_replica``)."""
    from tpu_rl_torch.bridge import state_dict_to_flax
    from tpu_rl_torch.fleet import replica_main
    from tpu_rl_torch.loadgen import probe_ready, run_loadgen
    from tpu_rl_torch.models.families import build_family
    from tpu_rl_torch.runtime.protocol import Protocol
    from tpu_rl_torch.runtime.transport import MODEL_HWM, Pub, Sub

    import torch

    model_port, stat_port = base_port + 10, base_port + 11
    result_dir = result_dir or tempfile.mkdtemp(prefix="loadgen-smoke-")
    cfg = fleet_config(base_port, result_dir, device)
    ports = [base_port, base_port + 1]
    endpoints = [("127.0.0.1", p) for p in ports]
    out_path = os.path.join(result_dir, "loadgen.json")

    # The stand-in learner: a live model PUB raising the policy version
    # every 2 s, so the sweep exercises the replicas' version-keyed swaps and
    # the drivers' floor with real rollout churn.
    family = build_family(cfg, device="cpu")
    actor = state_dict_to_flax(family.init_params(torch.Generator().manual_seed(0))["actor"])
    pub = Pub("*", model_port, bind=True, hwm=MODEL_HWM)
    stop_pub = threading.Event()

    def _publish() -> None:
        ver = 0
        while not stop_pub.is_set():
            ver += 1
            pub.send(Protocol.Model, {"actor": actor, "ver": ver})
            stop_pub.wait(2.0)

    ctx = mp.get_context("spawn")
    replicas = [
        ctx.Process(
            target=replica_main,
            args=(cfg, i, ports[i], "127.0.0.1", model_port, stat_port, None, None),
            kwargs={"seed": 0}, daemon=True,
        )
        for i in range(2)
    ]
    # Server-side telemetry tap: the replicas' stat PUBs connect to
    # stat_port; keep each replica's latest snapshot, the extra grading
    # input of the recompile rule (a killed replica's last one keeps
    # counting).
    stat_sub = Sub("*", stat_port, bind=True)
    latest: dict[int, dict] = {}
    stop_stats = threading.Event()

    def _collect_stats() -> None:
        while not stop_stats.is_set():
            for proto, snap in stat_sub.drain(max_msgs=256):
                if proto == Protocol.Telemetry and isinstance(snap, dict):
                    latest[int(snap.get("rid", -1))] = snap
            stop_stats.wait(0.1)

    def replies() -> dict[int, float]:
        return {rid: next((v for n, _l, v in snap.get("counters", ())
                           if n == "inference-replies"), 0.0)
                for rid, snap in list(latest.items())}

    killed: list[int] = []
    stop_kill = threading.Event()

    def _kill_busiest() -> None:
        """``kill_at`` seconds after the sweep began, SIGKILL the replica
        that served more of it. The drivers take a few seconds to start, so
        the start is read from the replicas' snapshots (every second): 20
        replies more than once the readiness probes are all counted (a
        replica answers every probe queued while it booted)."""
        if stop_kill.wait(cfg.telemetry_interval_s + 0.5):
            return
        before = replies()
        while sum(replies().values()) < sum(before.values()) + 20:
            if stop_kill.wait(0.1):
                return
        if stop_kill.wait(kill_at):
            return
        now = replies()
        rid = max(range(2), key=lambda r: now.get(r, 0.0) - before.get(r, 0.0))
        killed.append(rid)
        print(f"[loadgen] SIGKILL replica {rid} (replies since the sweep began: "
              f"{ {r: now.get(r, 0.0) - before.get(r, 0.0) for r in range(2)} })", flush=True)
        replicas[rid].kill()

    killer = None
    failures: list[str] = []
    doc: dict = {"stages": [], "overall": {"success_rate": 0.0}}
    try:
        for proc in replicas:
            proc.start()
        print(f"[loadgen] fleet booting on {ports} ({device}) ...", flush=True)
        if not probe_ready(endpoints, cfg, timeout_s=180.0):
            return doc, latest, ["fleet never became ready"]
        threading.Thread(target=_publish, daemon=True).start()
        threading.Thread(target=_collect_stats, daemon=True).start()
        # The replicas' first snapshots must land before grading starts, so
        # the recompile rule never grades no-data on stage 0.
        t_wait = time.monotonic() + 30.0
        while len(latest) < 2 and time.monotonic() < t_wait:
            time.sleep(0.2)
        if len(latest) < 2:
            return doc, latest, ["replica telemetry never arrived"]
        if kill_at is not None:
            # No respawn: the surviving replica carries the load.
            killer = threading.Thread(target=_kill_busiest, daemon=True)
            killer.start()
        print(f"[loadgen] sweep: {clients} clients, rates {list(rates)} rps"
              + (f", kill the busier replica at t+{kill_at}s" if kill_at is not None else ""),
              flush=True)
        doc = run_loadgen(
            cfg, endpoints, n_clients=clients, rates=list(rates), duration_s=duration,
            out_path=out_path, n_procs=2, rows=1, slo_spec=SLO_SPEC,
            extra_snapshots=lambda: list(latest.values()),
        )
        if kill_at is None:
            time.sleep(1.5)  # one more snapshot of each replica after the last stage
    finally:
        stop_kill.set()
        if killer is not None:
            killer.join(timeout=5)
        stop_pub.set()
        stop_stats.set()
        pub.close()
        stat_sub.close()
        for proc in replicas:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=10)
    for stage in doc["stages"]:
        print(json.dumps(stage), flush=True)
    if kill_at is not None:
        failures = check(doc, rates, out_path)
        if not killed:
            failures.append("the SIGKILL never fired")
    doc["killed_replica"] = killed[0] if killed else None
    return doc, latest, failures


def check(doc: dict, rates, out_path: str) -> list[str]:
    """``tpu_rl``'s bars over a sweep with a kill."""
    failures = []
    if not os.path.exists(out_path):
        failures.append(f"{out_path} was never written")
    if len(doc["stages"]) != len(rates):
        failures.append(f"expected {len(rates)} stages, got {len(doc['stages'])}")
    success = doc["overall"]["success_rate"]
    if success < 0.999:
        failures.append(f"overall success {success} < 0.999: the kill was not absorbed")
    floors = [s["version_floor"] for s in doc["stages"]]
    if any(b < a for a, b in zip(floors, floors[1:])):
        failures.append(f"version floor regressed across stages: {floors}")
    if floors and floors[-1] < 1:
        failures.append(f"floor never rose ({floors}): the model broadcast never landed")
    first_slo = doc["stages"][0].get("slo") if doc["stages"] else None
    if not (first_slo and first_slo["ok"]):
        failures.append(f"sub-saturation stage SLO not green: {first_slo}")
    # Every stage's recompile rule must grade a hard GREEN: ok=None (no
    # data) would mean the replicas' snapshots never reached the grading set.
    for i, stage in enumerate(doc["stages"]):
        rules = (stage.get("slo") or {}).get("rules", [])
        rule = next((r for r in rules if r["metric"] == "inference-xla-recompiles"), None)
        if rule is None or rule["ok"] is not True:
            failures.append(f"stage {i}: recompile watch not green: {rule}")
    if sum(s["hedges"] + s["failovers"] for s in doc["stages"][1:]) == 0:
        failures.append("no hedges/failovers after the kill: the kill never bit")
    return failures


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--clients", type=int, default=12_000)
    p.add_argument("--base-port", type=int, default=31400)
    p.add_argument("--rates", default="100,250,600", help="aggregate offered rps per stage")
    p.add_argument("--duration", type=float, default=6.0)
    p.add_argument("--kill-at", type=float, default=8.0,
                   help="seconds into the sweep the SIGKILL of the busier replica fires")
    p.add_argument("--result-dir", default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args()
    rates = tuple(float(r) for r in args.rates.split(","))
    doc, _snaps, failures = run(args.clients, args.base_port, rates, args.duration,
                                args.kill_at, args.result_dir, args.device)
    if failures:
        for f in failures:
            print(f"[loadgen] FAIL: {f}", flush=True)
        return 1
    floors = [s["version_floor"] for s in doc["stages"]]
    print(f"[loadgen] OK: {doc['overall']['ok']}/{doc['overall']['sent']} ok "
          f"({doc['overall']['success_rate']:.4%}), floors {floors}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
