"""The port's performance plane (``tpu_rl_torch.obs.perf``) on the CPU.

- Each hand-written kernel's FLOP formula equals ``FlopCounterMode`` over
  its plain version at two shapes (B2 without the plain version's ``dwh``,
  which the kernel leaves to one product outside it), and the counter
  charges the kernel's operator exactly its formula.
- The tracker's count of one default PPO colocated update equals a
  hand-written count of that update's products.
- Achieved FLOP/s and MFU agree with an offline timing within 15%
  (``TPU_RL_PEAK_FLOPS=1e12``), shape drift counts exactly one recompile,
  and the device helpers refuse what they cannot read.
- ``ProfilerCapture`` writes a Chrome trace, refuses a second capture while
  one runs, and is stopped by the crash hook; ``/prof`` answers 200 then 409.
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from tpu_rl_torch.config import Config
from tpu_rl_torch.obs import MetricsRegistry, TelemetryAggregator, TelemetryHTTPServer, flightrec
from tpu_rl_torch.obs.perf import (
    PEAK_FLOPS,
    PerfTracker,
    ProfilerCapture,
    device_memory_bytes,
    device_peak_flops,
    process_self_stats,
)
from tpu_rl_torch.ops import attention as A
from tpu_rl_torch.ops import fused_act as FA
from tpu_rl_torch.ops import lstm as L
from tpu_rl_torch.runtime.colocated import ColocatedLoop


def flops(fn, *args) -> int:
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# ----------------------------------------------------------- kernel formulas
def _lstm_inputs(B, S, H, seed=0):
    rng = np.random.default_rng(seed)
    xp, wh, h0, c0 = (_rand(rng, *s) for s in ((B, S, 4 * H), (H, 4 * H), (B, H), (B, H)))
    keep = torch.from_numpy((rng.random((B, S)) > 0.3).astype(np.float32))
    return xp, wh, h0, c0, keep


@pytest.mark.parametrize("B,S,H", [(3, 5, 8), (16, 4, 32)])
def test_b1_formula_is_the_plain_forward(B, S, H):
    args = _lstm_inputs(B, S, H)
    assert flops(L.lstm_forward_plain, *args) == L.lstm_flops(B, S, H) == 2 * B * S * H * 4 * H
    assert flops(L.lstm_fwd, *args) == L.lstm_flops(B, S, H)


@pytest.mark.parametrize("B,S,H", [(3, 5, 8), (16, 4, 32)])
def test_b2_formula_is_the_plain_backward_without_dwh(B, S, H):
    """The plain backward also computes ``dwh`` (S products of (H,B)x(B,4H)),
    which the wrapper drops; the formula is the rest."""
    xp, wh, h0, c0, keep = _lstm_inputs(B, S, H)
    hs, cs, acts = L.lstm_forward_plain(xp, wh, h0, c0, keep)
    rng = np.random.default_rng(1)
    dhs, dcs = _rand(rng, B, S, H), _rand(rng, B, S, H)
    args = (wh, h0, c0, keep, hs, cs, acts, dhs, dcs)
    dwh_alone = flops(lambda: [torch.zeros(B, H).T @ torch.zeros(B, 4 * H) for _ in range(S)])
    assert flops(L.lstm_backward_plain, *args) - dwh_alone == L.lstm_flops(B, S, H)
    assert flops(L.lstm_bwd, *args) == L.lstm_flops(B, S, H)


def test_lstm_unroll_counts_each_kernel_once_and_dwh_outside():
    """Forward + backward of the autograd Function: B1's and B2's formulas
    and the one ``dwh`` product, nothing of the plain versions beneath."""
    B, S, H = 4, 5, 8
    xp, wh, h0, c0, keep = (t.requires_grad_(i < 4) for i, t in enumerate(_lstm_inputs(B, S, H)))
    with FlopCounterMode(display=False) as counter:
        hs, cs = L.lstm_unroll(xp, wh, h0, c0, keep)
        (hs.sum() + cs.sum()).backward()
    counts = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    assert counts == {"tpu_rl_torch.lstm_fwd": L.lstm_flops(B, S, H),
                      "tpu_rl_torch.lstm_bwd": L.lstm_flops(B, S, H),
                      "aten.mm": 2 * B * S * H * 4 * H}


@pytest.mark.parametrize("B,D,H,A", [(8, 4, 16, 2), (5, 6, 32, 3)])
def test_b3_formula_is_the_plain_act_step(B, D, H, A):
    rng = np.random.default_rng(2)
    params = {
        "body.weight": _rand(rng, H, D), "body.bias": _rand(rng, H),
        "cell.x_proj.weight": _rand(rng, 4 * H, H), "cell.x_proj.bias": _rand(rng, 4 * H),
        "cell.recurrent_kernel": _rand(rng, H, 4 * H),
        "logits.weight": _rand(rng, A, H), "logits.bias": _rand(rng, A),
    }
    args = (params, _rand(rng, B, D), _rand(rng, B, H), _rand(rng, B, H))
    assert flops(FA.fused_act_step_plain, *args) == FA.act_flops(B, D, H, A)
    assert flops(FA.fused_act_step, *args) == FA.act_flops(B, D, H, A)
    assert FA.act_flops(B, D, H, A) == 2 * B * (D * H + 8 * H * H + H * A)


@pytest.mark.parametrize("B,T,H,D", [(2, 16, 2, 8), (1, 33, 3, 16)])
def test_b4_formulas_are_the_plain_forward_and_backward(B, T, H, D):
    """Full T×T products, whatever the mask: tiles the kernels skip show as
    speed, not as less work."""
    rng = np.random.default_rng(3)
    q, k, v, do = (_rand(rng, B, T, H, D) for _ in range(4))
    seg = torch.from_numpy(np.sort(rng.integers(0, 3, (B, T)), axis=1).astype(np.int32))
    o, lse = A.flash_attention_forward_plain(q, k, v, seg)
    assert flops(A.flash_attention_forward_plain, q, k, v, seg) == A.attn_flops(B, T, H, D)
    assert flops(A.flash_fwd, q, k, v, seg) == A.attn_flops(B, T, H, D) == 4 * B * H * T * T * D
    bwd = (q, k, v, seg, o, lse, do)
    assert flops(A.flash_attention_backward_plain, *bwd) == A.attn_flops(B, T, H, D, True)
    assert flops(A.flash_bwd, *bwd) == A.attn_flops(B, T, H, D, True) == 10 * B * H * T * T * D


# ------------------------------------------------------------- the tracker
def ppo_update_flops(B: int, S: int, H: int, D: int, A: int) -> int:
    """Products of one colocated PPO update with the MLP+LSTM actor-critic,
    counted by hand: S acting ticks of B rows (torso D·H, input and
    recurrent projections 8H², logits H·A, value H), the train forward over
    B·S rows (the same products, the recurrence in B1), its backward (dW
    alone for the torso, whose input needs no gradient; dX and dW of the
    projections and heads; B2's dz·whᵀ and the dwh product), and GAE's one
    (S-1)x(S-1) product per row."""
    fwd_row = 2 * (D * H + 8 * H * H + H * A + H)
    bwd_row = 2 * (H * D + 2 * 4 * H * H + 4 * H * H + 4 * H * H + 2 * H * A + 2 * H)
    return S * B * fwd_row + B * S * fwd_row + B * S * bwd_row + 2 * (S - 1) ** 2 * B


def test_hand_count_is_the_issue_estimate():
    """The default config's update is ~1.7e8 FLOPs (128 x 5 row-steps)."""
    assert ppo_update_flops(128, 5, 64, 4, 2) == 169_742_336


@pytest.mark.parametrize("envs", [128, 8])
def test_tracker_counts_one_default_ppo_update_by_hand(envs):
    """The tracker counts the FIRST update it dispatches (no extra call),
    returns that update's own result, and the count is the hand count."""
    cfg = Config(env_mode="colocated", colocated_envs=envs)
    loop = ColocatedLoop(cfg, seed=0, max_updates=1, device="cpu")
    state, carry, stats = loop.state, loop.init_carry(), loop.init_stats()
    tracker = PerfTracker("cpu")
    step0 = int(state.step)
    state, carry, stats, metrics = tracker.call(loop.program, state, carry, stats)
    assert int(state.step) == step0 + 1 and "loss" in metrics
    assert tracker.flops_per_call == ppo_update_flops(envs, cfg.seq_len, cfg.hidden_size, 4, 2)
    assert tracker.recompiles == 0


def test_achieved_flops_and_mfu_agree_with_offline_timing(monkeypatch):
    monkeypatch.setenv("TPU_RL_PEAK_FLOPS", "1e12")
    loop = ColocatedLoop(Config(env_mode="colocated", colocated_envs=16), seed=0,
                         device="cpu")
    state, carry, stats = loop.state, loop.init_carry(), loop.init_stats()
    tracker = PerfTracker("cpu")
    state, carry, stats, _ = tracker.call(loop.program, state, carry, stats)
    flops_offline = flops(loop.program, state, carry, stats)
    assert tracker.flops_per_call == flops_offline > 0
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        t_it = time.perf_counter()
        state, carry, stats, metrics = tracker.call(loop.program, state, carry, stats)
        float(metrics["loss"])
        tracker.note(time.perf_counter() - t_it)
    dt = time.perf_counter() - t0
    achieved = tracker.achieved_flops_per_s()
    assert achieved == pytest.approx(flops_offline * iters / dt, rel=0.15)
    assert tracker.mfu() == pytest.approx(achieved / 1e12)
    assert tracker.recompiles == 0


def test_shape_drift_counts_exactly_one_recompile_and_rebind_freezes():
    tracker = PerfTracker("cpu")

    def step(x, w):
        return x @ w

    w = torch.ones(3, 2)
    for _ in range(3):
        tracker.call(step, torch.ones(4, 3), w)
    assert tracker.recompiles == 0 and tracker.flops_per_call == 2 * 4 * 3 * 2
    tracker.call(step, torch.ones(5, 3), w)
    assert tracker.recompiles == 1
    tracker.call(step, torch.ones(4, 3), w)  # a seen signature is no new drift
    tracker.call(step, torch.ones(4, 3, dtype=torch.float64), w.double())
    assert tracker.recompiles == 2
    tracker.call(step, torch.ones(5, 3), w)
    assert tracker.recompiles == 2

    def rebuilt(x, w):
        return x @ w

    tracker.call(rebuilt, torch.ones(7, 3), w)  # an expected rebuild: counted anew
    assert tracker.recompiles == 2 and tracker.flops_per_call == 2 * 7 * 3 * 2
    tracker.call(rebuilt, torch.ones(8, 3), w)
    assert tracker.recompiles == 3


def test_device_helpers(monkeypatch):
    monkeypatch.delenv("TPU_RL_PEAK_FLOPS", raising=False)
    assert device_peak_flops("cpu") is None
    assert PEAK_FLOPS["NVIDIA H100 80GB HBM3"] == 989e12
    monkeypatch.setenv("TPU_RL_PEAK_FLOPS", "2.5e12")
    assert device_peak_flops("cpu") == 2.5e12 and PerfTracker("cpu").peak == 2.5e12
    rss, peak = device_memory_bytes("cpu")
    assert 0 < rss <= peak
    with pytest.raises(ValueError, match="unsupported device"):
        device_memory_bytes("meta")
    rss2, n_fds = process_self_stats()
    assert rss2 > 0 and n_fds > 0


# --------------------------------------------------------- profiler capture
def _wait_for(path: str, timeout: float = 30.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            return True
        time.sleep(0.05)
    return False


def test_profiler_capture_writes_a_trace_and_refuses_overlap(tmp_path):
    prof = ProfilerCapture(str(tmp_path), "cpu", default_ms=300)
    try:
        ok, path = prof.capture_async()
        assert ok and prof.active
        busy, reason = prof.capture_async(50)
        assert not busy and "in progress" in reason
        assert _wait_for(os.path.join(path, "trace.json"))
        deadline = time.monotonic() + 30
        while prof.active and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not prof.active and prof.n_captures == 1
        trace = json.loads(open(os.path.join(path, "trace.json")).read())
        assert "traceEvents" in trace
        # the slot is free again: a window on this thread records its ops
        window = prof.start("window")
        for _ in range(3):
            torch.ones(64, 64) @ torch.ones(64, 64)
        assert prof.stop() == window and prof.n_captures == 2
        trace = json.loads(open(os.path.join(window, "trace.json")).read())
        assert any("aten::mm" in e.get("name", "") for e in trace["traceEvents"])
    finally:
        prof.close()
    assert prof._crash_stop not in flightrec._CRASH_HOOKS


@pytest.mark.parametrize("bounded", [False, True], ids=["window", "capture_async"])
def test_crash_hook_stops_the_profiler(tmp_path, bounded):
    """A fatal exception ends the capture early and its trace is written,
    a window's or a bounded capture's (long as it was asked to run)."""
    prof = ProfilerCapture(str(tmp_path), "cpu")
    path = prof.capture_async(600_000)[1] if bounded else prof.start("crash")
    assert path is not None and prof.active
    t0 = time.monotonic()
    flightrec.dump_on_crash(RuntimeError("boom"))
    assert not prof.active and os.path.exists(os.path.join(path, "trace.json"))
    assert time.monotonic() - t0 < 30
    prof.close()


def test_prof_endpoint_200_then_409(tmp_path):
    prof = ProfilerCapture(str(tmp_path), "cpu")
    agg = TelemetryAggregator(registry=MetricsRegistry(role="colocated"))
    srv = TelemetryHTTPServer(agg, 0, prof=prof.capture_async)  # the OS picks the port
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/prof?ms=2000", timeout=30) as r:
            doc = json.loads(r.read())
        assert r.status == 200 and doc["started"] and doc["ms"] == 2000
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/prof?ms=10", timeout=30)
        assert e.value.code == 409
    finally:
        srv.close()
        prof.close()
