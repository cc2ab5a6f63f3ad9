#!/usr/bin/env python3
"""Where the telemetry plane's cost goes on the colocated loop's update.

    python3 lab/plane_lab.py        # from the repository root, on the card
    python3 lab/plane_lab.py runs   # ColocatedLoop.run with parts of the plane off
    python3 lab/plane_lab.py runs profiled   # the same after one profiler capture

Runs the training config (PPO, CartPole, 128 envs, H 64, S 5) through
``ColocatedLoop.program`` on the card, in windows of WINDOW updates closed
by a host read of the stats (as ``ColocatedLoop.run`` closes its log
windows), with each piece of the plane's per-update work added alone:

- ``program``: the update and nothing else;
- ``signature``: plus ``obs.perf.signature`` of the update's arguments
  (what ``PerfTracker.call`` adds to every call after the first);
- ``diag_fold``: plus ``DiagAccumulator.add`` of the update's diag at
  staleness 0;
- ``tracker``: the update through ``PerfTracker.call`` (its first call
  counted before the timing);
- ``plane``: tracker, diag fold and goodput ledger together.

The variants run in turns (ABCDE, EDCBA, ...) for ROUNDS rounds; each
prints the median ms per update over its windows, and the host time of
one diag fold alone (its launches, with a synchronize after).

``runs``: ``ColocatedLoop.run`` for RUN_UPDATES updates (a log window
every WINDOW) with the plane off, on (a result_dir), on with
``chip_smoke.TELEMETRY_SLO``'s rules, on without its tracker, and on with
the tracker bound before the run (so no update is counted under
``FlopCounterMode``), in turns; each prints the median of its log windows
after the first, in ms per update. ``runs profiled`` first runs 50 updates
under a bounded ``ProfilerCapture`` (CUDA activity, as ``/prof`` takes
one), as ``chip_smoke.telemetry_phase`` does before it times the plane.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpu_rl_torch.config import Config  # noqa: E402
from tpu_rl_torch.obs import DiagAccumulator, GoodputLedger, PerfTracker  # noqa: E402
from tpu_rl_torch.obs.goodput import COMPUTE  # noqa: E402
from tpu_rl_torch.obs.perf import signature  # noqa: E402
from tpu_rl_torch.runtime.colocated import ColocatedLoop  # noqa: E402

CFG = dict(env="CartPole-v1", env_mode="colocated", algo="PPO", colocated_envs=128)
WINDOW, WINDOWS, ROUNDS = 10, 8, 4
VARIANTS = ("program", "signature", "diag_fold", "tracker", "plane")
RUN_UPDATES = 100
RUN_VARIANTS = ("off", "on", "on_slo", "on_no_tracker", "on_tracker_bound")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("plane_lab needs a CUDA card")
    loop = ColocatedLoop(Config(**CFG), seed=0, device="cuda")
    state, carry, stats = loop.state, loop.init_carry(), loop.init_stats()
    for _ in range(5):
        state, carry, stats, metrics = loop.program(state, carry, stats)
    stale0 = torch.zeros((loop.cfg.batch_size,), device="cuda")
    acc = DiagAccumulator()
    acc.add(metrics["diag"], stale0)
    tracker = PerfTracker("cuda")
    state, carry, stats, metrics = tracker.call(loop.program, state, carry, stats)
    ledger = GoodputLedger("colocated")
    torch.cuda.synchronize()

    def one(variant: str):
        nonlocal state, carry, stats
        t0 = time.perf_counter()
        if variant in ("tracker", "plane"):
            state, carry, stats, m = tracker.call(loop.program, state, carry, stats)
        else:
            if variant == "signature":
                signature((state, carry, stats))
            state, carry, stats, m = loop.program(state, carry, stats)
        diag = m.pop("diag")
        if variant in ("diag_fold", "plane"):
            acc.add(diag, stale0)
        if variant == "plane":
            ledger.add(COMPUTE, time.perf_counter() - t0)

    ms = {v: [] for v in VARIANTS}
    for r in range(ROUNDS):
        order = VARIANTS if r % 2 == 0 else VARIANTS[::-1]
        for v in order:
            for _ in range(WINDOWS):
                t0 = time.perf_counter()
                for _ in range(WINDOW):
                    one(v)
                int(stats["episodes"])  # the window's host read
                ms[v].append((time.perf_counter() - t0) / WINDOW * 1e3)
    card = torch.cuda.get_device_name(0)
    for v in VARIANTS:
        print(f"plane_lab {v}: median ms/update {statistics.median(ms[v]):.6f} over "
              f"{len(ms[v])} windows of {WINDOW} [{card}]", flush=True)
    _s, _c, _t, m = loop.program(state, carry, stats)
    folds = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc.add(m["diag"], stale0)
        folds.append(time.perf_counter() - t0)
    print(f"plane_lab one diag fold: median host ms {statistics.median(folds) * 1e3:.6f} "
          f"({len(m['diag']['rows'])} row channels, {len(m['diag']['scalars'])} scalars) "
          f"[{card}]", flush=True)


def runs(profiled: bool) -> None:
    import tempfile

    from chip_smoke import TELEMETRY_SLO
    from tpu_rl_torch.obs.perf import ProfilerCapture, _SignatureWatch

    if not torch.cuda.is_available():
        sys.exit("plane_lab needs a CUDA card")
    if profiled:
        with tempfile.TemporaryDirectory() as d:
            capture = ProfilerCapture(d, "cuda")
            capture.capture_async(60_000)
            ColocatedLoop(Config(**CFG), seed=0, max_updates=50, device="cuda").run(log=False)
            trace = capture.stop()
            capture.close()
        print(f"plane_lab profiled first: trace written {trace is not None}", flush=True)
    ms = {v: [] for v in RUN_VARIANTS}
    for r in range(ROUNDS):
        for v in (RUN_VARIANTS if r % 2 == 0 else RUN_VARIANTS[::-1]):
            with tempfile.TemporaryDirectory() as d:
                extra = {} if v == "off" else dict(result_dir=d)
                if v == "on_slo":
                    extra["slo_spec"] = TELEMETRY_SLO
                loop = ColocatedLoop(Config(**CFG, loss_log_interval=WINDOW, **extra), seed=0,
                                     max_updates=RUN_UPDATES, device="cuda")
                if v == "on_no_tracker":
                    loop._perf = None
                if v == "on_tracker_bound":
                    loop._perf._watch = _SignatureWatch(loop.program)
                windows = []
                tick = loop._telemetry_tick

                def note(updates, env_steps, episodes, ups, tps, chunk_s, *a, tick=tick,
                         windows=windows):
                    windows.append(chunk_s)
                    tick(updates, env_steps, episodes, ups, tps, chunk_s, *a)

                loop._telemetry_tick = note
                loop.run(log=False)
            ms[v].append(statistics.median(windows[1:]) * 1e3)
    card = torch.cuda.get_device_name(0)
    tag = " (profiled first)" if profiled else ""
    for v in RUN_VARIANTS:
        print(f"plane_lab run{tag} {v}: median log window ms/update per run "
              f"{[round(x, 6) for x in ms[v]]} [{card}]", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["runs"]:
        runs(profiled=sys.argv[2:] == ["profiled"])
    else:
        main()
