"""Open-loop synthetic load driver and multi-process sweep — the port of
``tpu_rl.loadgen.driver``.

:class:`LoadDriver` is one driver process's engine: it replays ObsRequest
frames for ``n_clients`` synthetic client identities over one DEALER lane
per replica, on an open-loop schedule (a request is sent when the schedule
says so, regardless of how many are still in flight — the only load shape
that can push a server past saturation). Fleet semantics match
:class:`~tpu_rl_torch.fleet.client.FleetClient`: power-of-two lane
selection, hedges after ``Config.inference_hedge_ms``, late/duplicate
replies discarded + counted, and a pinned monotonic version floor.

:func:`run_loadgen` fans a stage sweep across N driver processes (spawn
context, each started with no card visible), merges the per-stage
telemetry snapshots with the registry's elementwise merge, grades each
stage through a fresh :class:`~tpu_rl_torch.obs.slo.SloEngine`, and writes
the saturation curve to ``loadgen.json`` in ``tpu_rl``'s schema.

Numpy and the standard library over the port's wire: driver processes
make no tensor and open no CUDA context, so 10k+ synthetic clients cost a
few MB.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import random
import time
import uuid

import numpy as np

from tpu_rl_torch.config import Config
from tpu_rl_torch.obs.registry import MetricsRegistry, hist_quantile, merge_snapshots
from tpu_rl_torch.runtime.protocol import Protocol
from tpu_rl_torch.runtime.transport import Dealer

# A lane silent past its first hedge window (or a piggyback probe) is
# benched this long before the next probe considers it; consecutive silent
# probes double the bench up to the cap. Short base on purpose: the loadgen
# must notice a killed replica fast AND re-admit a recovered (or freshly
# scaled-out) one fast, or the saturation curve measures the bench, not
# the fleet.
_LANE_DEAD_S = 1.0
_LANE_DEAD_MAX_S = 8.0
# Doublings of a backoff past which it is at its cap whatever the base.
_MAX_DOUBLINGS = 32

# Adaptive hedge window: a request hedges once it has waited this multiple
# of its primary lane's RTT EWMA (floored/capped below). A fixed
# `inference_hedge_ms` is a dilemma at both ends — large, and every request
# riding a freshly-retired lane eats the full window before rescue; small,
# and a saturated fleet hedge-storms itself. Scaling with the lane's own
# EWMA rescues dead-lane picks in ~4 healthy RTTs while a genuinely slow
# fleet (EWMA already high) hedges no earlier than it used to.
_HEDGE_FLOOR_S = 0.25
_HEDGE_EWMA_MULT = 4.0


class _Lane:
    __slots__ = ("dealer", "ewma_ms", "dead_until", "fails")

    def __init__(self, dealer: Dealer):
        self.dealer = dealer
        self.ewma_ms = 0.0
        # Lanes start in probation (benched but immediately probe-due): an
        # endpoint in the planned port range may not have a replica behind
        # it yet (capacity the fleet has not scaled into), and
        # real traffic must never ride a lane that has not answered at
        # least one frame. The first reply revives the lane for selection.
        self.dead_until = 0.0
        self.fails = 1  # consecutive silent benches (backoff exponent)

    def observe(self, rtt_ms: float) -> None:
        self.ewma_ms = (
            rtt_ms if self.ewma_ms == 0.0
            else 0.8 * self.ewma_ms + 0.2 * rtt_ms
        )

    def condemn(self) -> None:
        self.fails += 1
        # The exponent is capped: a lane benched over a thousand times (a
        # hedge storm past saturation) overflowed tpu_rl's float power.
        self.dead_until = time.monotonic() + min(
            _LANE_DEAD_S * 2.0 ** min(self.fails - 1, _MAX_DOUBLINGS), _LANE_DEAD_MAX_S
        )

    def revive(self) -> None:
        self.fails = 0
        self.dead_until = 0.0


class _InFlight:
    __slots__ = (
        "t_send", "primary", "lanes", "n_hedges", "next_hedge", "hedge_s"
    )

    def __init__(self, t_send: float, primary: int, hedge_s: float):
        self.t_send = t_send
        self.primary = primary
        self.lanes = [primary]  # every lane this seq ever rode
        self.n_hedges = 0
        self.hedge_s = hedge_s
        self.next_hedge = t_send + hedge_s if hedge_s > 0 else float("inf")


class LoadDriver:
    """One process's synthetic clients. ``run_stage`` executes a single
    offered-load plateau and returns its result row + telemetry snapshot."""

    def __init__(
        self,
        cfg: Config,
        endpoints: list[tuple[str, int]],
        n_clients: int,
        obs_dim: int,
        rows: int = 1,
        seed: int = 0,
    ):
        if not endpoints:
            raise ValueError("LoadDriver needs at least one endpoint")
        self.cfg = cfg
        self.n_clients = int(n_clients)
        self.seed = seed
        self._rng = random.Random(0xCAFE ^ (seed * 40503))
        self.floor = -1
        self.seq = 0
        # Request replay: every client sends the same observation frame —
        # the server's work per request is identical either way, and the
        # replay buffer is two tiny arrays instead of an env.
        self._obs = np.zeros((rows, obs_dim), np.float32)
        self._first = np.ones((rows,), np.float32)
        self.lanes = [
            _Lane(Dealer(
                ip, port,
                identity=f"lg{seed}-r{i}-{uuid.uuid4().hex[:6]}".encode(),
            ))
            for i, (ip, port) in enumerate(endpoints)
        ]

    # ------------------------------------------------------------- selection
    def _pick(
        self, exclude: tuple[int, ...] = (), live_only: bool = False
    ) -> int | None:
        """Power-of-two-choices over live lanes. Benched lanes
        (``fails > 0``) stay out of selection until a probe reply revives
        them — real traffic never rides a lane that last answered nothing.
        ``live_only`` (hedges) returns None instead of falling back to a
        benched lane: a hedge queued into a dead socket is not a rescue,
        it is a stale-request storm delivered to whatever replica binds
        that port later."""
        now = time.monotonic()
        live = [
            i for i, lane in enumerate(self.lanes)
            if i not in exclude
            and lane.fails == 0 and lane.dead_until <= now
        ]
        if not live:
            if live_only:
                return None
            # All benched: probe whichever recovers first (never stall the
            # schedule — open-loop means the load keeps coming).
            rest = [i for i in range(len(self.lanes)) if i not in exclude]
            if not rest:
                return None
            return min(rest, key=lambda i: self.lanes[i].dead_until)
        if len(live) == 1:
            return live[0]
        a, b = self._rng.sample(live, 2)
        return a if self.lanes[a].ewma_ms <= self.lanes[b].ewma_ms else b

    def _probe_lane(self, lanes_used: list[int]) -> int | None:
        """The most-overdue benched lane due for a piggyback re-probe, or
        None. The caller duplicates an in-flight seq onto it: an answer
        revives the lane (and can win the request); silence just doubled
        the backoff — a replica slot nothing serves yet is
        bothered exponentially rarely, one scaled out a moment ago is
        adopted within one bench."""
        now = time.monotonic()
        due = [
            i for i, lane in enumerate(self.lanes)
            if i not in lanes_used and lane.fails > 0 and lane.dead_until <= now
        ]
        if not due:
            return None
        return min(due, key=lambda i: self.lanes[i].dead_until)

    def _send(self, lane_idx: int, seq: int) -> None:
        self.lanes[lane_idx].dealer.send(Protocol.ObsRequest, {
            "wid": seq % self.n_clients,  # the synthetic client identity
            "seq": seq,
            "obs": self._obs,
            "first": self._first,
            "floor": self.floor,
        })

    # ----------------------------------------------------------------- stage
    def run_stage(self, rate_rps: float, duration_s: float) -> dict:
        """One plateau of the sweep: offer ``rate_rps`` for ``duration_s``,
        then drain one timeout window. Returns the stage row with the
        stage's telemetry snapshot attached under ``"snapshot"``."""
        cfg = self.cfg
        registry = MetricsRegistry(
            role="loadgen", labels={"drv": str(self.seed)}
        )
        rtt_hist = registry.histogram("inference-rtt")
        hedge_cap_s = cfg.inference_hedge_ms / 1e3
        timeout_s = cfg.inference_timeout_ms / 1e3

        def hedge_window(lane: _Lane) -> float:
            ewma_s = lane.ewma_ms / 1e3
            if ewma_s <= 0.0:  # lane never answered: configured window
                return hedge_cap_s
            return min(
                hedge_cap_s, max(_HEDGE_FLOOR_S, _HEDGE_EWMA_MULT * ewma_s)
            )

        interval = 1.0 / rate_rps if rate_rps > 0 else float("inf")
        inflight: dict[int, _InFlight] = {}
        sent = ok = failed = 0
        hedges = failovers = dedups = floor_rejects = reprobes = 0

        start = time.perf_counter()
        stop_sending = start + duration_s
        next_send = start
        hard_stop = stop_sending + timeout_s + hedge_cap_s + 0.5

        while True:
            now = time.perf_counter()
            if now >= hard_stop or (now >= stop_sending and not inflight):
                break
            # 1) send everything the schedule owes (bounded burst so a long
            # drain stall doesn't explode into one giant send storm)
            burst = 0
            while now < stop_sending and next_send <= now and burst < 256:
                primary = self._pick()
                if primary is None:
                    break
                self._send(primary, self.seq)
                entry = _InFlight(
                    now, primary, hedge_window(self.lanes[primary])
                )
                # Piggyback re-probe: duplicate this seq onto at most one
                # overdue benched lane — costs no latency, and an answer
                # both revives the lane and can win the request.
                probe = self._probe_lane(entry.lanes)
                if probe is not None:
                    self._send(probe, self.seq)
                    entry.lanes.append(probe)
                    reprobes += 1
                    self.lanes[probe].condemn()  # assume silence until reply
                inflight[self.seq] = entry
                self.seq += 1
                sent += 1
                burst += 1
                next_send += interval
            # 2) drain every lane
            for idx, lane in enumerate(self.lanes):
                while True:
                    got = lane.dealer.recv(timeout_ms=0)
                    if got is None:
                        break
                    # Any frame is proof of life: a probed-back replica (or
                    # a late straggler) rejoins selection immediately.
                    lane.revive()
                    proto, payload = got
                    if proto != Protocol.Act or not isinstance(payload, dict):
                        continue
                    seq = payload.get("seq")
                    entry = inflight.get(seq)
                    if entry is None:
                        dedups += 1  # hedge loser / post-timeout straggler
                        continue
                    ver = int(payload.get("ver", -1))
                    if ver < self.floor:
                        floor_rejects += 1  # keep waiting on this seq
                        continue
                    self.floor = max(self.floor, ver)
                    del inflight[seq]
                    ok += 1
                    rtt = time.perf_counter() - entry.t_send
                    rtt_hist.observe(rtt)
                    lane.observe(rtt * 1e3)
                    if idx != entry.primary:
                        failovers += 1
            # 3) hedge + expire
            now = time.perf_counter()
            expired = []
            for seq, entry in inflight.items():
                age = now - entry.t_send
                # Re-hedge every additional hedge window onto a lane this
                # seq has not ridden yet; self-capping — _pick returns None
                # once the unused live lanes run out.
                if now >= entry.next_hedge:
                    # A primary silent past its first hedge window is
                    # benched on the spot — waiting for the full request
                    # timeout would let a dead lane keep winning selection
                    # (every pick rescued by a hedge, never condemned).
                    # Any later frame on the lane revives it immediately,
                    # so a merely-slow replica rejoins within one reply.
                    if entry.n_hedges == 0:
                        self.lanes[entry.primary].condemn()
                    alt = self._pick(
                        exclude=tuple(entry.lanes), live_only=True
                    )
                    if alt is not None:
                        self._send(alt, seq)
                        entry.lanes.append(alt)
                        entry.n_hedges += 1
                        hedges += 1
                        entry.next_hedge += entry.hedge_s
                    else:
                        # No live lane free right now — retry next window
                        # (a scaled-out replica may have been adopted by
                        # then), rather than giving up on this seq forever.
                        entry.next_hedge += entry.hedge_s
                if age >= timeout_s:
                    expired.append(seq)
            for seq in expired:
                entry = inflight.pop(seq)
                failed += 1
                self.lanes[entry.primary].condemn()
            time.sleep(0.0005)

        elapsed = time.perf_counter() - start
        registry.counter("loadgen-requests").inc(sent)
        registry.counter("loadgen-replies").inc(ok)
        registry.counter("loadgen-failures").inc(failed + len(inflight))
        registry.counter("fleet-hedge-fired").inc(hedges)
        registry.counter("fleet-failovers").inc(failovers)
        registry.counter("fleet-dedup-replies").inc(dedups)
        registry.counter("fleet-floor-rejects").inc(floor_rejects)
        registry.counter("fleet-reprobes").inc(reprobes)
        registry.gauge("loadgen-offered-rate").set(rate_rps)
        registry.gauge("loadgen-achieved-rate").set(
            ok / elapsed if elapsed > 0 else 0.0
        )
        registry.gauge("fleet-version-floor").set(self.floor)
        failed += len(inflight)  # whatever never resolved by hard_stop
        return {
            "offered_rps": rate_rps,
            "achieved_rps": round(ok / elapsed, 3) if elapsed > 0 else 0.0,
            "sent": sent,
            "ok": ok,
            "failed": failed,
            "success_rate": round(ok / sent, 6) if sent else 1.0,
            "hedges": hedges,
            "failovers": failovers,
            "dedups": dedups,
            "floor_rejects": floor_rejects,
            "reprobes": reprobes,
            "version_floor": self.floor,
            "snapshot": registry.snapshot(),
        }

    def close(self) -> None:
        for lane in self.lanes:
            lane.dealer.close()


# ---------------------------------------------------------------- readiness
def probe_ready(
    endpoints: list[tuple[str, int]],
    cfg: Config,
    timeout_s: float = 60.0,
    obs_dim: int | None = None,
) -> bool:
    """Block until every endpoint answers one probe request (or the deadline
    lapses). Run before a sweep: a stage measured against a still-compiling
    replica is a saturation curve of its warm-up, not of the fleet."""
    dim = int(cfg.obs_shape[0]) if obs_dim is None else int(obs_dim)
    obs = np.zeros((1, dim), np.float32)
    first = np.ones((1,), np.float32)
    deadline = time.monotonic() + timeout_s
    for i, (ip, port) in enumerate(endpoints):
        dealer = Dealer(
            ip, port, identity=f"probe-{i}-{uuid.uuid4().hex[:6]}".encode()
        )
        try:
            seq = 0
            while True:
                if time.monotonic() >= deadline:
                    return False
                dealer.send(Protocol.ObsRequest, {
                    "wid": 0, "seq": seq, "obs": obs, "first": first,
                })
                got = dealer.recv(timeout_ms=500)
                if got is not None and got[0] == Protocol.Act:
                    break
                seq += 1
        finally:
            dealer.close()
    return True


# -------------------------------------------------------------------- sweep
def normalize_schedule(schedule) -> list[tuple[float, float]]:
    """Validate a time-indexed rps schedule — ``[(rps, duration_s), ...]``,
    the diurnal-ramp shape (100 -> 5000 -> 100) — into float pairs.
    Raises ``ValueError`` naming the offending stage."""
    out = []
    for i, stage in enumerate(schedule):
        try:
            rps, dur = stage
            rps, dur = float(rps), float(dur)
        except (TypeError, ValueError):
            raise ValueError(
                f"loadgen schedule stage {i}: expected (rps, duration_s) "
                f"pair, got {stage!r}"
            ) from None
        if rps < 0 or dur <= 0:
            raise ValueError(
                f"loadgen schedule stage {i}: need rps >= 0 and "
                f"duration_s > 0, got ({rps}, {dur})"
            )
        out.append((rps, dur))
    if not out:
        raise ValueError("loadgen schedule is empty")
    return out


def _driver_proc(
    cfg: Config,
    endpoints: list[tuple[str, int]],
    n_clients: int,
    obs_dim: int,
    rows: int,
    seed: int,
    stages: list[tuple[float, float]],
    q,
) -> None:
    """Spawn-context child: run every (rate, duration) stage of the sweep
    at this process's share of the offered rate, shipping
    (seed, stage_idx, row) back."""
    driver = LoadDriver(
        cfg, endpoints, n_clients, obs_dim, rows=rows, seed=seed
    )
    try:
        for idx, (rate, dur) in enumerate(stages):
            q.put((seed, idx, driver.run_stage(rate, dur)))
    finally:
        driver.close()


def run_loadgen(
    cfg: Config,
    endpoints: list[tuple[str, int]],
    n_clients: int,
    rates: list[float] | None = None,
    duration_s: float = 10.0,
    out_path: str | None = None,
    n_procs: int = 1,
    rows: int = 1,
    obs_dim: int | None = None,
    slo_spec: str | None = None,
    extra_snapshots=None,
    schedule=None,
) -> dict:
    """Sweep ``rates`` (aggregate offered rps, ``duration_s`` each) across
    ``n_procs`` driver processes and produce the saturation-curve document.
    ``schedule`` — ``[(rps, duration_s), ...]`` — is the explicit
    time-indexed alternative (diurnal ramps: 100 -> 5000 -> 100 with
    per-stage dwell times); exactly one of the two must be given. Stage
    rows and per-stage SLO verdicts are identical in both modes; a
    schedule additionally lands in the document under ``"schedule"``.

    Per stage: the drivers' telemetry snapshots merge elementwise (shared
    HIST_BUCKETS make quantiles exact across processes), rtt quantiles come
    from the merged histogram, and — when ``slo_spec`` is given — a FRESH
    SLO engine grades the merged snapshot, so every stage's verdict is
    independent (a saturated stage must not burn the budget of the
    sub-saturation stage before it). ``extra_snapshots`` (optional
    zero-arg callable -> list of snapshot dicts) joins SERVER-side
    telemetry to each stage's grading set — e.g. the replicas' live stat
    snapshots, so rules over server counters
    (``counter:inference-xla-recompiles==0``, the per-bucket signature
    watch) grade against real fleet state, not just the drivers' view; it is called once per stage
    at grading time. Writes ``out_path`` (loadgen.json) when given;
    returns the document either way.
    """
    from tpu_rl_torch.obs.slo import SloEngine
    from tpu_rl_torch.runtime.runner import _child_env
    from tpu_rl_torch.utils.platform import HOST_ENV

    if (schedule is None) == (rates is None):
        raise ValueError("run_loadgen: give exactly one of rates/schedule")
    if schedule is not None:
        plan = normalize_schedule(schedule)
    else:
        plan = normalize_schedule([(r, duration_s) for r in rates])
    dim = int(cfg.obs_shape[0]) if obs_dim is None else int(obs_dim)
    n_procs = max(1, int(n_procs))
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = []
    for p in range(n_procs):
        share = [(r / n_procs, d) for r, d in plan]
        procs.append(ctx.Process(
            target=_driver_proc,
            args=(cfg, endpoints, max(1, n_clients // n_procs), dim, rows,
                  p, share, q),
            daemon=True,
        ))
    with _child_env(**HOST_ENV):  # the drivers see no card
        for proc in procs:
            proc.start()
    rows_by_stage: dict[int, list[dict]] = {}
    expect = n_procs * len(plan)
    budget = (
        sum(d for _r, d in plan)
        + (cfg.inference_timeout_ms / 1e3 + 30.0) * len(plan)
    )
    deadline = time.monotonic() + budget
    got = 0
    while got < expect and time.monotonic() < deadline:
        try:
            _seed, idx, row = q.get(timeout=1.0)
        except Exception:  # noqa: BLE001 — queue.Empty; re-check deadline
            if not any(proc.is_alive() for proc in procs):
                break
            continue
        rows_by_stage.setdefault(idx, []).append(row)
        got += 1
    for proc in procs:
        proc.join(timeout=10.0)
        if proc.is_alive():
            proc.terminate()

    stages = []
    tot_sent = tot_ok = 0
    for idx in sorted(rows_by_stage):
        per = rows_by_stage[idx]
        snap = per[0]["snapshot"]
        for row in per[1:]:
            snap = merge_snapshots(snap, row["snapshot"])
        hist = next(
            (h for h in snap.get("hists", ()) if h[0] == "inference-rtt"),
            None,
        )
        quant = {}
        if hist is not None:
            for label, qq in (("p50", 0.5), ("p99", 0.99), ("p999", 0.999)):
                v = hist_quantile(hist[2], qq)
                quant[f"{label}_ms"] = (
                    round(v * 1e3, 3) if v is not None else None
                )
        sent = sum(r["sent"] for r in per)
        okc = sum(r["ok"] for r in per)
        tot_sent += sent
        tot_ok += okc
        stage = {
            "offered_rps": sum(r["offered_rps"] for r in per),
            "achieved_rps": round(sum(r["achieved_rps"] for r in per), 3),
            "duration_s": plan[idx][1],
            "sent": sent,
            "ok": okc,
            "failed": sum(r["failed"] for r in per),
            "success_rate": round(okc / sent, 6) if sent else 1.0,
            "hedges": sum(r["hedges"] for r in per),
            "failovers": sum(r["failovers"] for r in per),
            "dedups": sum(r["dedups"] for r in per),
            "floor_rejects": sum(r["floor_rejects"] for r in per),
            "reprobes": sum(r.get("reprobes", 0) for r in per),
            "version_floor": max(r["version_floor"] for r in per),
            **quant,
        }
        if slo_spec:
            graded = [snap]
            if extra_snapshots is not None:
                graded = graded + list(extra_snapshots())
            stage["slo"] = SloEngine(slo_spec).evaluate(graded)
        stages.append(stage)

    doc = {
        "n_clients": int(n_clients),
        "n_procs": n_procs,
        "rows": int(rows),
        "duration_s": float(sum(d for _r, d in plan)),
        "endpoints": [[ip, port] for ip, port in endpoints],
        "slo_spec": slo_spec,
        "schedule": [[r, d] for r, d in plan] if schedule is not None else None,
        "stages": stages,
        "overall": {
            "sent": tot_sent,
            "ok": tot_ok,
            "success_rate": (
                round(tot_ok / tot_sent, 6) if tot_sent else 1.0
            ),
        },
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        tmp = f"{out_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2)
        os.replace(tmp, out_path)  # crash-atomic, like every result file
    return doc
