#!/usr/bin/env python3
"""Host cost of the kernel wrappers and of the telemetry plane's serving work.

    python3 lab/dispatch_lab.py wrappers [ROOT]   # on the card
    python3 lab/dispatch_lab.py serving           # on the card

``wrappers``: imports ``tpu_rl_torch`` from ROOT (default: this checkout;
give another checkout's root to time its wrappers the same way) and times,
on the card, the public wrappers of B3 (``fused_act_step`` at 8 rows of the
serving model: obs 4, H 256, 2 actions) and B1/B2 (``lstm_fwd`` /
``lstm_bwd`` at B 128, S 5, H 64, the default training shape). Where a
wrapper enters its kernel through a ``torch.library.custom_op``, the op's
own function is timed too, called directly (no dispatcher). Each line gives
the median over ROUNDS rounds of the host time per call (CALLS calls
enqueued back to back, then one synchronize) and of the wall time per call
with a synchronize after each. Run it once per checkout in one process
each, in turns (parent, change, change, parent), to compare two trees.

``serving``: the serving model's act step at the 8-row bucket, with each
piece of the plane's per-flush work timed alone on the service's own
arguments (the step bare and through its bucket's ``PerfTracker``, the
argument signature walked whole and as the service takes it, the goodput
ledger's two adds, the tracker's ``note``); then serving mix 1 (2 clients x
4 envs x 1000 acts, ``chip_smoke.serve_phase``) with the plane off and on,
in turns, printing acts/s and the mean flush ms of each run.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

CALLS, ROUNDS = 200, 15


def host_us(fn) -> dict:
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    enq, wall = [], []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        enq.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
            torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) / 20 * 1e6)
    return {"host_us": statistics.median(enq), "synced_us": statistics.median(wall)}


def card() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def wrappers(root: Path) -> None:
    sys.path.insert(0, str(root.resolve()))
    import numpy as np
    import torch

    from tpu_rl_torch.ops import fused_act as FA
    from tpu_rl_torch.ops import lstm as L

    if not torch.cuda.is_available():
        sys.exit("dispatch_lab needs a CUDA card")
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()

    B, D, H, A = 8, 4, 256, 2
    params = {
        "body.weight": rand(H, D), "body.bias": rand(H),
        "cell.x_proj.weight": rand(4 * H, H), "cell.x_proj.bias": rand(4 * H),
        "cell.recurrent_kernel": rand(H, 4 * H), "logits.weight": rand(A, H),
        "logits.bias": rand(A),
    }
    obs, h, c = rand(B, D), rand(B, H), rand(B, H)
    Bl, S, Hl = 128, 5, 64
    xp, wh, h0, c0 = rand(Bl, S, 4 * Hl), rand(Hl, 4 * Hl) * 0.1, rand(Bl, Hl), rand(Bl, Hl)
    keep = torch.from_numpy((rng.random((Bl, S)) > 0.2).astype(np.float32)).cuda()
    hs, cs, acts = L.lstm_fwd(xp, wh, h0, c0, keep)
    dhs, dcs = rand(Bl, S, Hl), rand(Bl, S, Hl)
    calls = {
        "B3 fused_act_step (8,4,256,2)": lambda: FA.fused_act_step(params, obs, h, c),
        "B1 lstm_fwd (128,5,64)": lambda: L.lstm_fwd(xp, wh, h0, c0, keep),
        "B2 lstm_bwd (128,5,64)": lambda: L.lstm_bwd(wh, h0, c0, keep, hs, cs, acts, dhs, dcs),
    }
    # The op's own function, where the wrapper goes through a custom op.
    if hasattr(FA, "_fused_act_op"):
        fa = FA._fused_act_op._init_fn
        weights = [params[k] for k in FA._WEIGHTS]
        calls["B3 op body, no dispatcher"] = lambda: fa(obs, *weights, h, c)
    if hasattr(L, "_lstm_fwd_op"):
        f1, f2 = L._lstm_fwd_op._init_fn, L._lstm_bwd_op._init_fn
        calls["B1 op body, no dispatcher"] = lambda: f1(xp, wh, h0, c0, keep)
        calls["B2 op body, no dispatcher"] = lambda: f2(wh, h0, c0, keep, hs, cs, acts, dhs, dcs)
    out = {}
    for name, fn in calls.items():
        # as on the paths: serving acts under inference_mode, the LSTM
        # Function's forward and backward run without grad mode
        with torch.inference_mode() if name.startswith("B3") else torch.no_grad():
            out[name] = host_us(fn)
    print("dispatch_lab wrappers " + json.dumps(
        {"root": str(root), "card": card(), "torch": torch.__version__, "calls": out}), flush=True)


def serving() -> None:
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.models.families import build_family
    from tpu_rl_torch.models.quant import make_act_fn
    from tpu_rl_torch.obs import GoodputLedger, PerfTracker
    from tpu_rl_torch.obs.goodput import COMPUTE, QUEUE_WAIT
    from tpu_rl_torch.obs.perf import signature
    from tpu_rl_torch.runtime.inference_service import InferenceService, _Staging, _views
    from tpu_rl_torch.runtime.local_router import LocalRouter

    if not torch.cuda.is_available():
        sys.exit("dispatch_lab needs a CUDA card")
    cfg = Config.from_dict(chip_smoke.SERVE_CFG)
    family = build_family(cfg, device="cuda")
    svc = InferenceService(cfg, family, chip_smoke.seeded_params(family, 0), LocalRouter(),
                           device="cuda")  # not started: its act step is driven here
    act = make_act_fn(cfg, family)
    hw, cw = family.carry_widths
    st = _Staging(8, 4, hw, cw, family.n_actions, 1, pin=True)
    st.reset()
    params, params_sig = svc._params, svc._params_sig
    gen = torch.Generator("cuda").manual_seed(0)
    tracker, ledger = PerfTracker("cuda"), GoodputLedger("inference")
    dev_in = st.in_host.to("cuda")
    obs, first, h, c = _views(dev_in, st.in_shapes)
    args = (act, params, obs, h, c, first, gen)
    with torch.inference_mode():
        tracker.call(svc._step, *args, sig=(params_sig, signature((obs, h, c, first))))

        def ledger_adds():
            t = time.perf_counter()
            ledger.add(QUEUE_WAIT, time.perf_counter() - t)
            t = time.perf_counter()
            ledger.add(COMPUTE, time.perf_counter() - t)

        parts = {
            "act step": lambda: svc._step(*args),
            "act step through the tracker": lambda: tracker.call(
                svc._step, *args, sig=(params_sig, signature((obs, h, c, first)))),
            "signature of every argument": lambda: signature(args),
            "signature as the service takes it": lambda: (
                params_sig, signature((obs, h, c, first))),
            "two ledger adds": ledger_adds,
            "tracker note": lambda: tracker.note(1e-3),
        }
        out = {name: host_us(fn) for name, fn in parts.items()}
    print("dispatch_lab serving parts " + json.dumps({"card": card(), "parts": out}), flush=True)
    runs = []
    for telemetry in (False, True, True, False, False, True, True, False):
        res = chip_smoke.serve_phase(mixes=(chip_smoke.SERVE_MIXES[0],), telemetry=telemetry)
        mix = res["mixes"][0]
        runs.append({"plane": "on" if telemetry else "off", "acts_per_s": mix["acts_per_s"],
                     "flush_ms": mix["flush_ms"], "p99_ms": mix["p99_ms"],
                     "recompiles": (res["telemetry"] or {}).get("recompiles")})
    print("dispatch_lab serving mix1 " + json.dumps({"card": card(), "runs": runs}), flush=True)


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode == "wrappers":
        wrappers(Path(sys.argv[2]) if len(sys.argv) > 2 else Path(__file__).resolve().parent.parent)
    elif mode == "serving":
        serving()
    else:
        sys.exit(__doc__)
