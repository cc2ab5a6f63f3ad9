"""Autopilot smoke — the port of ``tpu_rl``'s ``examples/autopilot_smoke.py``:
the closed control loop end to end, on one host.

One :class:`~tpu_rl_torch.autopilot.AutopilotController` (``manage_all``:
it owns the whole replica range) supervises an elastic inference fleet
while a diurnal loadgen schedule sweeps offered load 20 -> 205 -> 20 rps:

- every replica stalls 40 ms a flush (``stall:inference@40ms`` service
  chaos), pinning one replica's capacity near ``batch / stall`` ~190 rps,
  so the peak saturates one replica and the valleys never do;
- a probe client and a 1 Hz SLO engine grade ``p99:inference-rtt`` over a
  sliding window of the probe's own round trips; the controller scrapes
  that ``/slo`` (and ``/metrics``) off a smoke-local telemetry server and
  must scale out to >= 2 replicas under the peak and back in when the
  valley returns;
- ``kill:inference-1@t+5s`` stays armed until the first scaled-out replica
  exists, then SIGKILLs it: the controller's supervision pass must respawn
  it;
- the drivers start with lanes planned for the whole capacity range, so a
  scaled-out replica is adopted through the lane re-probe (the stages must
  show ``reprobes``).

``tpu_rl``'s bars: zero failed requests; the version floor never
decreases; both 20 rps valleys GREEN on ``p99:inference-rtt``; scale out to
>= 2 and back in; the killed replica respawned; every ``autopilot.jsonl``
action valid against :data:`ACTION_SCHEMA`; an ``AUTOPILOT`` panel in
:func:`tpu_rl_torch.obs.top.build_frame`. The port's replicas act through
kernel B3 (``act_kernel="pallas"``, as the port's loadgen smoke), on the
card, or on the CPU (its plain version) with ``device="cpu"``; the
controller and this process never open a CUDA context.

:func:`run` returns ``(loadgen document, {replica pid: its last telemetry
snapshot}, failed bars)``; the schedule is an argument (``SCHEDULE``, 179 s
of stages, by default).

Run:
  python -m tpu_rl_torch.examples.autopilot_smoke \\
      [--clients 6000] [--base-port 31500] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
from collections import deque

import numpy as np

# The controller's policy: scale out on sustained p99 burn, back in when
# the burn window is clean; bounds [1, 3] replicas. Scale-in demands a much
# longer clean streak (25 s at the 0.5 s poll) than scale-out's 2 s: burn
# saturates at 0 whenever capacity is comfortable, so an impatient scale-in
# would hunt the floor even under the peak.
AUTOPILOT_SPEC = (
    "scale_out:replicas?burn:inference-rtt>0.5"
    "@sustain=4@cooldown=6s@max=3,"
    "scale_in:replicas?burn:inference-rtt<0.02"
    "@sustain=50@cooldown=6s@min=1,"
    "limit=12/60s"
)
# The live engine the autopilot scrapes (1 Hz over the probe's sliding
# window) and the per-stage grading rule of the loadgen document.
LIVE_SLO = "p99:inference-rtt<500ms@window=15s"
STAGE_SLO = "p99:inference-rtt<500ms@window=600s"
# Service chaos: the deterministic saturation lever, and the kill armed
# from the start (it fires once the first scaled-out replica exists).
CHAOS_SPEC = "stall:inference@40ms,kill:inference-1@t+5s"
# Diurnal ramp (aggregate rps, dwell seconds): 20 -> 205 -> 20; the 120
# shoulders stay under one replica's ~190 rps, the 205 peak saturates it.
SCHEDULE = [(20, 20), (120, 12), (205, 80), (120, 12), (20, 55)]

# Every `ev: action` line in autopilot.jsonl carries exactly these typed
# fields.
ACTION_SCHEMA = {
    "action": str,
    "target": str,
    "rule": str,
    "signal": str,
    "value": (int, float),
    "reason": str,
    "step": int,
    "from": int,
    "to": int,
    "replicas": int,
    "workers": int,
    "t": (int, float),
}


def validate_action(rec: dict) -> str | None:
    """None when the record matches ACTION_SCHEMA, else the complaint."""
    for key, typ in ACTION_SCHEMA.items():
        if key not in rec:
            return f"missing key {key!r}"
        if not isinstance(rec[key], typ) or isinstance(rec[key], bool):
            return f"key {key!r} has {type(rec[key]).__name__}"
    if rec["action"] not in ("scale_out", "scale_in", "respawn"):
        return f"unknown action {rec['action']!r}"
    return None


def fleet_config(base_port: int, result_dir: str, device: str = "cuda"):
    """``tpu_rl``'s autopilot-smoke config (IMPALA, obs 4, 2 actions, H 32,
    batch 8, one bucket, 15 s timeout, 3 s hedge, fast lane re-probe, the
    specs above), acting through B3."""
    from tpu_rl_torch.config import Config

    return Config.from_dict(dict(
        algo="IMPALA", obs_shape=(4,), action_space=2, hidden_size=32,
        worker_num_envs=1, act_mode="remote", act_kernel="pallas",
        learner_device="cpu" if device == "cpu" else "auto",
        inference_replicas=1, inference_base_port=base_port,
        inference_batch=8, inference_flush_us=2000, inference_buckets=8,
        # Generous timeout: the open-loop peak briefly queues multi-second
        # waits while a scaled-out replica starts; hedges stay a recovery
        # tool (killed-lane failover), not a load amplifier.
        inference_timeout_ms=15_000, inference_hedge_ms=3_000,
        inference_retries=1,
        # Fast lane re-probe: clients adopt a scaled-out replica within
        # seconds of it binding.
        inference_reprobe_s=0.5, inference_reprobe_max_s=4.0,
        autopilot_spec=AUTOPILOT_SPEC, autopilot_poll_s=0.5,
        autopilot_drain_s=0.3,
        chaos_spec=CHAOS_SPEC,
        result_dir=result_dir, telemetry_interval_s=0.5,
    ))


def run(
    clients: int = 6_000,
    base_port: int = 31500,
    schedule=None,
    result_dir: str | None = None,
    device: str = "cuda",
) -> tuple[dict, dict[int, dict], list[str]]:
    """One diurnal sweep against an autopilot-managed fleet: ``(loadgen
    document, {replica pid: its last telemetry snapshot}, failed bars)``.
    The document also carries the controller's summary (``autopilot``),
    the audit's action records (``actions``) and whether this process
    opened a CUDA context (``cuda_initialized``)."""
    import torch

    from tpu_rl_torch.autopilot import AutopilotController
    from tpu_rl_torch.bridge import state_dict_to_flax
    from tpu_rl_torch.config import MachinesConfig
    from tpu_rl_torch.fleet import FleetClient
    from tpu_rl_torch.loadgen import probe_ready, run_loadgen
    from tpu_rl_torch.models.families import build_family
    from tpu_rl_torch.obs import MetricsRegistry, TelemetryAggregator, TelemetryHTTPServer
    from tpu_rl_torch.obs.registry import diff_snapshots
    from tpu_rl_torch.obs.slo import SloEngine
    from tpu_rl_torch.obs.top import build_frame, fetch_json
    from tpu_rl_torch.runtime.protocol import Protocol
    from tpu_rl_torch.runtime.transport import MODEL_HWM, Pub, Sub

    schedule = list(schedule or SCHEDULE)
    stat_port = base_port + 10  # machines.learner_port: the stat SUB
    http_port = base_port + 12  # smoke-local telemetry server
    result_dir = result_dir or tempfile.mkdtemp(prefix="autopilot-smoke-")
    machines = MachinesConfig(learner_ip="127.0.0.1", learner_port=stat_port)
    cfg = fleet_config(base_port, result_dir, device)
    capacity_ports = machines.inference_ports(cfg.replace(inference_replicas=3))
    endpoints = [("127.0.0.1", prt) for prt in capacity_ports]
    out_path = os.path.join(result_dir, "loadgen.json")

    # Stand-in learner: a rising-version model PUB (the replicas'
    # version-keyed swap and the clients' floor ratchet need live
    # broadcasts), in tpu_rl's flax layout, made on the CPU.
    family = build_family(cfg, device="cpu")
    actor = state_dict_to_flax(family.init_params(torch.Generator().manual_seed(0))["actor"])
    pub = Pub("*", machines.model_port, bind=True, hwm=MODEL_HWM)
    stop = threading.Event()

    def _publish() -> None:
        ver = 0
        while not stop.is_set():
            ver += 1
            pub.send(Protocol.Model, {"actor": actor, "ver": ver})
            stop.wait(2.0)

    # Stat plane: replica and controller registries PUB here; the
    # aggregator behind /metrics is what the autopilot's scraper reads back.
    # Each replica process's newest snapshot is kept (by pid: a respawned
    # index is a new process).
    stat_sub = Sub("*", stat_port, bind=True)
    agg = TelemetryAggregator()
    replicas: dict[int, dict] = {}

    def _collect_stats() -> None:
        while not stop.is_set():
            for proto, snap in stat_sub.drain(max_msgs=256):
                if proto == Protocol.Telemetry and isinstance(snap, dict):
                    agg.ingest(snap)
                    if snap.get("role") == "inference":
                        replicas[int(snap.get("pid", -1))] = snap
            stop.wait(0.1)

    # Probe plane: a closed-loop client across the whole planned range
    # records real round trips; the 1 Hz engine grades a sliding window of
    # them (cumulative histograms would never recover after the peak).
    probe_reg = MetricsRegistry(role="autopilot-probe")
    rtt_hist = probe_reg.histogram("inference-rtt")
    engine = SloEngine(LIVE_SLO)
    # Short probe hedge: a probe that picks a lane the autopilot just
    # retired must be rescued well under the 500 ms threshold, or every
    # scale-in pollutes the burn signal that decided it and the controller
    # flaps.
    probe_cl = FleetClient(cfg.replace(inference_hedge_ms=300), endpoints, wid=7)

    def _probe() -> None:
        obs = np.zeros((1, 4), np.float32)
        first = np.ones((1,), np.float32)
        while not stop.is_set():
            t0 = time.perf_counter()
            got = probe_cl.act(obs, first, retries=0)
            rtt = time.perf_counter() - t0
            # a timed-out probe is a violation at the timeout bound
            rtt_hist.observe(rtt if got is not None else rtt + 1.0)
            stop.wait(0.1)

    def _grade() -> None:
        ring: deque = deque()  # (t, cumulative snapshot)
        while not stop.is_set():
            now = time.monotonic()
            snap = probe_reg.snapshot()
            ring.append((now, snap))
            while ring and now - ring[0][0] > 16.0:
                ring.popleft()
            win = diff_snapshots(snap, ring[0][1]) if len(ring) > 1 else snap
            engine.evaluate([win], now=now)
            stop.wait(1.0)

    ctrl = AutopilotController(
        cfg, machines=machines, manage_all=True,
        scrape_url=f"http://127.0.0.1:{http_port}", http_port=0, seed=0,
    )
    server = TelemetryHTTPServer(agg, http_port, slo=engine.report, autopilot=ctrl.status_doc)
    result: dict = {}

    def _run_ctrl() -> None:
        result["autopilot"] = ctrl.run()

    ap_live = None
    probe_thread = None
    frame: list = []
    doc: dict = {"stages": [], "overall": {"success_rate": 0.0, "sent": 0, "ok": 0}}
    failures: list[str] = []
    ctrl_thread = threading.Thread(target=_run_ctrl, daemon=True)
    try:
        threading.Thread(target=_publish, daemon=True).start()
        threading.Thread(target=_collect_stats, daemon=True).start()
        ctrl_thread.start()
        print(f"[autopilot-smoke] booting replica 0 on {capacity_ports[0]} ({device}; "
              f"capacity range {capacity_ports}) ...", flush=True)
        t_boot = time.monotonic()
        if not probe_ready(endpoints[:1], cfg, timeout_s=240.0):
            failures.append("replica 0 never became ready")
        else:
            print(f"[autopilot-smoke] replica 0 ready in {time.monotonic() - t_boot:.1f}s",
                  flush=True)
            # Probe and grading start against a ready fleet: boot-time
            # timeouts must not pre-burn the scale-out rule.
            probe_thread = threading.Thread(target=_probe, daemon=True)
            probe_thread.start()
            threading.Thread(target=_grade, daemon=True).start()
            time.sleep(2.0)
            print(f"[autopilot-smoke] diurnal sweep {schedule} rps ({clients} clients)",
                  flush=True)
            doc = run_loadgen(
                cfg, endpoints, n_clients=clients, schedule=schedule,
                out_path=out_path, n_procs=2, rows=1, slo_spec=STAGE_SLO,
            )
            # The dashboard leg while the controller is live: the frame an
            # operator would see must carry the AUTOPILOT panel.
            ap_live = fetch_json(f"http://127.0.0.1:{http_port}/autopilot", 3.0)
            if isinstance(ap_live, dict) and "error" in ap_live:
                ap_live = None
            frame = build_frame([], None, None, autopilot_doc=ap_live)
    finally:
        ctrl.sup.stop_event.set()
        time.sleep(0.1)
        stop.set()
    ctrl_thread.join(timeout=60.0)
    server.close()
    # The probe thread may be mid-act: let it see `stop` before its
    # client's sockets go away under it.
    if probe_thread is not None:
        probe_thread.join(timeout=20.0)
    probe_cl.close()
    pub.close()
    stat_sub.close()

    for stage in doc["stages"]:
        print(json.dumps(stage), flush=True)
    events = []
    audit_path = os.path.join(result_dir, "autopilot.jsonl")
    if os.path.exists(audit_path):
        with open(audit_path) as f:
            events = [json.loads(line) for line in f if line.strip()]
    actions = [e for e in events if e.get("ev") == "action"]
    ap_doc = result.get("autopilot") or {}
    doc["autopilot"] = ap_doc
    doc["actions"] = actions
    doc["cuda_initialized"] = torch.cuda.is_initialized()
    if failures:
        return doc, replicas, failures
    failures = check(doc, schedule, events, frame, ctrl_thread.is_alive(), ap_live)
    return doc, replicas, failures


def check(doc: dict, schedule, events: list[dict], frame: list[str], ctrl_alive: bool,
          ap_live) -> list[str]:
    """``tpu_rl``'s autopilot-smoke bars."""
    failures = []
    actions = [e for e in events if e.get("ev") == "action"]
    ap_doc = doc.get("autopilot") or {}
    if ctrl_alive:
        failures.append("controller never stopped")
    if not ap_doc.get("ok"):
        failures.append(f"autopilot run not ok: {ap_doc}")
    if len(doc["stages"]) != len(schedule):
        failures.append(f"expected {len(schedule)} stages, got {len(doc['stages'])}")
    success = doc["overall"]["success_rate"]
    if success < 1.0:
        failures.append(f"overall success {success} < 1.0 — "
                        f"{doc['overall']['sent'] - doc['overall']['ok']} requests failed")
    floors = [s["version_floor"] for s in doc["stages"]]
    if any(b < a for a, b in zip(floors, floors[1:])):
        failures.append(f"version floor regressed across stages: {floors}")
    if floors and floors[-1] < 1:
        failures.append(f"floor never rose ({floors})")
    for idx in (0, len(doc["stages"]) - 1):
        slo = doc["stages"][idx].get("slo") if doc["stages"] else None
        if not (slo and slo["ok"]):
            failures.append(f"valley stage {idx} SLO not green: {slo}")
    # the closed loop itself: out under the peak, back in after it
    outs = [a for a in actions if a["action"] == "scale_out"]
    ins = [a for a in actions if a["action"] == "scale_in"]
    peak = max((a["replicas"] for a in actions), default=1)
    final = ap_doc.get("replicas", peak)
    if not outs or peak < 2:
        failures.append(f"never scaled out (peak {peak}): {actions}")
    if not ins:
        failures.append("never scaled back in")
    if final >= peak:
        failures.append(f"final replicas {final} not below peak {peak}")
    for a in actions:
        complaint = validate_action(a)
        if complaint:
            failures.append(f"action record {a}: {complaint}")
    kills = [e for e in events if e.get("ev") == "chaos" and e.get("action") == "kill"]
    if not kills:
        failures.append("chaos kill never fired")
    if not [e for e in events if e.get("ev") == "respawn"]:
        failures.append("killed replica was never respawned")
    if sum(s.get("reprobes", 0) for s in doc["stages"]) < 1:
        failures.append("drivers never re-probed a lane — scale-out adoption untested")
    if not any("AUTOPILOT" in line for line in frame):
        failures.append(f"dashboard frame has no AUTOPILOT panel: {ap_live}")
    return failures


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--clients", type=int, default=6_000)
    p.add_argument("--base-port", type=int, default=31500)
    p.add_argument("--result-dir", default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--schedule", default=None,
                   help="stages as 'rps:seconds,...' (default: the 179 s diurnal ramp)")
    p.add_argument("--out", default=None,
                   help="write {doc, replicas, failures} as JSON to this file")
    args = p.parse_args()
    schedule = None
    if args.schedule:
        schedule = [tuple(float(x) for x in s.split(":")) for s in args.schedule.split(",")]
    doc, snaps, failures = run(args.clients, args.base_port, schedule, args.result_dir,
                               args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"doc": doc, "replicas": {str(k): v for k, v in snaps.items()},
                       "failures": failures}, f)
    if failures:
        for f in failures:
            print(f"[autopilot-smoke] FAIL: {f}", flush=True)
        return 1
    actions = doc["actions"]
    peak = max((a["replicas"] for a in actions), default=1)
    print(f"[autopilot-smoke] OK: success {doc['overall']['success_rate']:.4%}, floors "
          f"{[s['version_floor'] for s in doc['stages']]}, replicas peaked at {peak} and "
          f"settled at {doc['autopilot'].get('replicas')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
