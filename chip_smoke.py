#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``tpu_rl_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

It drives the port's serving path, its colocated LSTM training path and the
transformer's PPO training (its train step at full width, and its colocated
loop) end to end, and holds every hand-written kernel of those paths against
its plain PyTorch version:

1. device check: a CUDA card is required (else exit 1, no result printed);
   prints the card's name and power limit as nvidia-smi reports them and
   turns TF32 off everywhere;
2. build: every ``tpu_rl_torch/csrc/*.cu`` with nvcc (``kernels/build.py``),
   printing ptxas's registers and spill stores for every kernel instance;
3. kernel vs plain: the fused act kernel at the serving ladder, ragged row
   counts, the default model and the wide model, on seeded inputs and the
   port's own init with seeded nonzero biases; per shape the max abs error, the kernel's, the plain
   version's and the unfused act's (``family.act``) times, and the bound;
4. serving: an ``InferenceService`` (IMPALA ``DiscreteActorCritic``,
   H=256, A=2, inference_batch=256, buckets 8..256, the fused kernel) over
   an in-process ``LocalRouter``, under 2 clients x 4 envs x 1000 acts and
   64 clients x 4 envs x 100 acts; asserts every request is answered, the
   kernel ran exactly once per warm-up and per flush, the carry persists on
   the server and a parameter swap is served with its version;
5. LSTM kernels vs plain: B1 (``lstm_fwd``) and B2 (``lstm_bwd``) at
   (B,S,H) = (128,5,64) the training path, (32,5,64) the learning run,
   (100,5,64) ragged, (256,16,256) and (1024,16,1024), on seeded inputs with
   a keep mask that resets; per shape the max abs error of hs, cs, acts,
   dxp, dh0, dc0 and of the whole autograd Function's dwh, the kernel's and
   the plain version's times, and the bound;
6. training: the default config (PPO, CartPole, H=64, S=5, 128 envs)
   through ``ColocatedLoop.program``, 5 warm-up then 200 timed updates:
   transitions/s, ms per update, its rollout/train split, the device busy
   share over a 10-update profiler window, and B1/B2 launch counts equal to
   updates x K_epoch with no fused-act launch;
7. learning: ``ColocatedLoop.run`` on tpu_rl's colocated smoke recipe
   (batch 32, lr 3e-4, entropy 1e-3, seed 0) for 1800 updates, one line per
   200-update window; fails unless the best window's mean return is >= 60
   over >= 100 episodes;
8. B4 (``flash_attn_fwd``/``flash_attn_bwd``: bf16 on the tensor-core
   kernels, f32 on the CUDA-core ones) vs plain: the main path's (B,T,H,D)
   = (16,2048,8,64) bf16, the colocated config's (8,4096,8,32) bf16, bf16
   rows with long segments over many tiles, many seams on a ragged T, a
   small D=32 shape and shuffled (non-monotone) segment ids, and f32 rows
   (one with ~1000-key segments), q/k/v as strided views of one qkv tensor;
   per shape the tile pairs the bf16 kernels visit beside the causal ones,
   the max abs error of o, lse, dq, dk and dv beside its tolerance (bf16:
   element by element) and the median |ref|, the kernels', the plain
   versions' and ``scaled_dot_product_attention``'s times (the same mask as
   a boolean attn_mask), and the bound;
9. transformer training: small f32 and bf16 train steps on the card
   against the CPU's plain path (loss, grad norm), then
   ``get_algo("PPO").build`` at
   bench.py's ``PPO-transformer@longctx-flash`` model (d512, 8 heads, 4
   layers, bf16, flash; its build must leave bf16 products reducing in f32)
   on a seeded 16 x 2048 batch with seams, 2 warm-up
   then 10 timed updates: ms per update, transitions/s, peak memory, B4's
   share of device time over a profiler window, finite loss, and B4 launch
   counts equal to n_layers x K_epoch x updates;
10. the transformer's colocated loop: ``ColocatedLoop.program`` on
   ``configs/longcontext_singlechip.example.json`` with the flash impl
   (CartPole, KV-cached acting, 8 x 4096) for 2 updates, finite metrics and
   the launches as counted;
11. prints the ``kernels`` JSON line and, last, the ``{"ok": true, ...}`` line.

Any failed phase raises and the script exits non-zero before the last line.
Times are CUDA-event medians on this card; each is printed beside the card's
name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32
# CUDA-core FLOP/s and dense bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

# Serving configuration: the model of tpu_rl's serving benchmark
# (bench.py:1058-1082), f32 weights through the fused act kernel.
SERVE_CFG = dict(
    algo="IMPALA", obs_shape=(4,), action_space=2, hidden_size=256,
    inference_batch=256, inference_flush_us=500, inference_buckets=8,
    inference_dtype="f32", act_kernel="pallas", worker_num_envs=4,
)

# The training config: tpu_rl's defaults (PPO, CartPole-v1, H=64, S=5,
# K_epoch=1, lr 1e-4, guard and learn_diag on) at bench.py's reference
# quantum of 128 envs.
TRAIN_CFG = dict(env="CartPole-v1", env_mode="colocated", algo="PPO", colocated_envs=128)
TRAIN_WARMUP, TRAIN_UPDATES = 5, 200
# examples/colocated_smoke.py's learning recipe and bar.
LEARN_CFG = dict(
    env="CartPole-v1", env_mode="colocated", algo="PPO", batch_size=32, buffer_size=32,
    seq_len=5, lr=3e-4, entropy_coef=1e-3, reward_scale=0.1, time_horizon=500,
    loss_log_interval=200,
)
LEARN_UPDATES, LEARN_BAR, LEARN_EPISODES = 1800, 60.0, 100

# (B, S, H) at which B1 and B2 are held against the plain versions: the
# training path, the learning run, a ragged batch, and two wide shapes
# (tpu_rl's IMPALA@wide-lstm is the last, bench.py:241-246).
LSTM_SHAPES = [(128, 5, 64), (32, 5, 64), (100, 5, 64), (256, 16, 256), (1024, 16, 1024)]
LSTM_FWD_TOL, LSTM_GRAD_TOL = 1e-5, 3e-5

# (B, T, H, D, dtype, mean seams per row, shuffled ids) at which B4 is held
# against its plain versions: the main path (bench.py's
# PPO-transformer@longctx-flash; one seam per row, as the training batch
# below has), the colocated config (configs/longcontext_singlechip.example
# .json); for the bf16 tensor-core kernels, the main path's row length with
# ~1 seam (long segments: the online softmax and the backward walks over
# many tiles, most of them unmasked), a ragged T with ~50 seams (most tile
# pairs skipped, the rest masked), a small D=32 shape, and shuffled segment
# ids (not monotone: the skip rule visits every causal tile and the element
# mask does the work); the f32 CUDA-core kernels at the main path's row
# length (segments of ~1000 keys), a ragged shape with many segments and a
# small shape.
ATTN_SHAPES = [
    (16, 2048, 8, 64, torch.bfloat16, 1, False), (8, 4096, 8, 32, torch.bfloat16, 16, False),
    (2, 2048, 8, 64, torch.bfloat16, 1, False), (3, 1000, 4, 64, torch.bfloat16, 50, False),
    (2, 200, 3, 32, torch.bfloat16, 5, False), (2, 512, 4, 64, torch.bfloat16, 8, True),
    (2, 2048, 8, 64, torch.float32, 1, False), (3, 1000, 4, 64, torch.float32, 50, False),
    (2, 200, 3, 32, torch.float32, 5, False),
]
# f32: the kernel and the plain version sum in another order; absolute
# tolerances (o and lse, gradients). bf16: both compute in f32 from the same
# bf16 inputs and round once, so an element may differ by one bf16 ulp of
# itself (at most 2**-7 * |ref|), checked element by element, plus a floor of
# 2**-16 * max|ref| for the f32 sums' order near zero; lse is f32 either way.
ATTN_F32_TOL = (2e-5, 1e-4)
BF16_ULP, BF16_FLOOR = 2.0**-7, 2.0**-16

# bench.py's PPO-transformer@longctx-flash row (bench.py:291-300): the
# transformer's full-width model and batch.
TF_TRAIN_CFG = dict(
    algo="PPO", model="transformer", compute_dtype="bfloat16", attention_impl="flash",
    batch_size=16, seq_len=2048, hidden_size=512, n_heads=8, n_layers=4, obs_shape=(64,),
    action_space=8,
)
TF_WARMUP, TF_UPDATES, TF_PROFILE = 2, 10, 2
TF_COLOCATED_UPDATES = 2

# (rows, D, H, A) checked against the plain version.
SERVING_LADDER = [(b, 4, 256, 2) for b in (8, 16, 32, 64, 128, 256)]
RAGGED = [(b, 4, 256, 2) for b in (1, 3, 100)]
DEFAULT_MODEL = [(b, 4, 64, 2) for b in (8, 128)]
WIDE_MODEL = [(256, 64, 1024, 8)]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
def device_ms(fn, iters: int = 100, reps: int = 7, warmup: int = 10) -> float:
    """Median device time of one ``fn()`` call, in ms. A busy-wait kernel is
    queued first so that the host has enqueued all ``iters`` calls before
    the card reaches the start event: the events then time the card's work
    back to back, not Python's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # cycles to cover twice the host's enqueue time at up to 2 GHz
    sleep_cycles = int(max(host_s, 1e-3) * 2 * 2e9)
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def bound(B: int, D: int, H: int, A: int) -> tuple[float, str]:
    """Least time (ms) of one fused act step on an H100: the larger of its
    bytes (each input read once, each output written once) over HBM's rate
    and its operations (the three products' multiply-adds, 2 each) over the
    f32 peak."""
    weights = H * D + H + 4 * H * H + 4 * H + H * 4 * H + A * H + A
    floats = weights + B * D + 2 * B * H + B * A + 2 * B * H
    t_bytes = 4 * floats / HBM_BYTES_PER_S
    t_ops = 2 * B * (D * H + 8 * H * H + H * A) / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def seeded_params(family, seed: int) -> dict:
    """The port's own init from ``seed``, then every bias filled with seeded
    N(0, 0.1^2) values: the init zeroes biases, a trained policy's are not,
    and the kernel's bias terms must be held to the plain version too."""
    g = torch.Generator().manual_seed(seed)
    params = family.init_params(g)
    for name, t in params["actor"].items():
        if name.endswith(".bias"):
            t.copy_(0.1 * torch.randn(t.shape, generator=g))
    return params


# ------------------------------------------------------- kernel vs plain
def kernel_phase() -> list[dict]:
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.models.families import build_family
    from tpu_rl_torch.models.quant import make_act_fn
    from tpu_rl_torch.ops import fused_act as FA

    rows = []
    for B, D, H, A in SERVING_LADDER + RAGGED + DEFAULT_MODEL + WIDE_MODEL:
        cfg = Config.from_dict({"hidden_size": H, "obs_shape": (D,), "action_space": A})
        family = build_family(cfg, device="cuda")
        params = seeded_params(family, 0)
        p = params["actor"]
        g = torch.Generator().manual_seed(B * 1000 + H)
        obs, h, c = (torch.randn(s, generator=g).cuda() for s in ((B, D), (B, H), (B, H)))
        got = FA.fused_act_step(p, obs, h, c)
        torch.cuda.synchronize()
        want = FA.fused_act_step_plain(p, obs, h, c)
        err = max(float((x - y).abs().max()) for x, y in zip(got, want, strict=True))
        # f32 FMAs on both sides, summed in another order: 1e-5 holds up to
        # H=256; at H=1024 each gate sums 2048 products, so the rounding of
        # the two orders can differ by a few 1e-6 more.
        tol = 1e-5 if H <= 256 else 1e-4
        if not (err <= tol and all(bool(torch.isfinite(x).all()) for x in got)):
            fail(f"fused act kernel vs plain at {(B, D, H, A)}: max abs err {err} > {tol}")
        gen = torch.Generator("cuda").manual_seed(0)
        fused_act = make_act_fn(cfg.replace(act_kernel="pallas"), family)
        kernel_ms = device_ms(lambda: FA.fused_act_step(p, obs, h, c))
        plain_ms = device_ms(lambda: FA.fused_act_step_plain(p, obs, h, c))
        unfused_ms = device_ms(lambda: family.act(params, obs, h, c, gen))
        # the service's whole act step: the kernel, then sampling and log-prob
        act_ms = device_ms(lambda: fused_act(params, obs, h, c, gen))
        bound_ms, bound_by = bound(B, D, H, A)
        row = dict(
            shape=dict(rows=B, D=D, H=H, A=A), max_abs_err=err, tol=tol,
            kernel_ms=kernel_ms, plain_ms=plain_ms, unfused_ms=unfused_ms, act_ms=act_ms,
            bound_ms=bound_ms, bound_by=bound_by,
        )
        rows.append(row)
        print(
            f"fused_act rows={B} D={D} H={H} A={A}: max_abs_err={err:.3e} (tol {tol:g}) "
            f"kernel_ms={kernel_ms:.6f} plain_ms={plain_ms:.6f} "
            f"unfused_ms={unfused_ms:.6f} act_ms={act_ms:.6f} "
            f"bound_ms={bound_ms:.6f} ({bound_by})",
            flush=True,
        )
    return rows


# ----------------------------------------------------------------- serving
def drive(cfg, router, n_clients: int, envs: int, acts: int, tag: str) -> dict:
    """``n_clients`` threads, each one client of ``envs`` env rows, each
    sending ``acts`` timed ObsRequests after one untimed priming act.
    Checks every reply's shapes, finiteness and log-prob."""
    barrier = threading.Barrier(n_clients + 1)
    failures = [0] * n_clients
    bad = [0] * n_clients
    lat: list[list[float]] = [[] for _ in range(n_clients)]
    A = int(cfg.action_space)

    def check(reply) -> bool:
        act = reply["act"]
        logits = reply["logits"]
        lp = reply["log_prob"]
        if act.shape != (envs, 1) or logits.shape != (envs, A) or lp.shape != (envs, 1):
            return False
        if not (np.isfinite(logits).all() and np.isfinite(lp).all()):
            return False
        idx = act[:, 0].astype(np.int64)
        if idx.min() < 0 or idx.max() >= A:
            return False
        picked = logits[np.arange(envs), idx]
        return bool(np.allclose(lp[:, 0], picked, atol=1e-6, rtol=0)) and bool(
            np.allclose(np.exp(logits).sum(-1), 1.0, atol=1e-5)
        )

    def run(k: int) -> None:
        cl = router.client(f"{tag}-{k}".encode())
        rng = np.random.default_rng(k)
        obs = rng.standard_normal((envs, int(cfg.obs_shape[0]))).astype(np.float32)
        first = np.ones(envs, np.float32)
        reply = cl.act(obs, first)
        if reply is None or not check(reply):
            failures[k] += 1
        barrier.wait()
        first = np.zeros(envs, np.float32)
        for _ in range(acts):
            t0 = time.perf_counter()
            reply = cl.act(obs, first)
            lat[k].append(time.perf_counter() - t0)
            if reply is None:
                failures[k] += 1
            elif not check(reply):
                bad[k] += 1

    threads = [threading.Thread(target=run, args=(k,), daemon=True) for k in range(n_clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    all_lat = sorted(x for ks in lat for x in ks)
    return dict(
        clients=n_clients, envs=envs, acts=acts,
        acts_per_s=n_clients * acts * envs / dt,
        p50_ms=all_lat[int(0.50 * (len(all_lat) - 1))] * 1e3,
        p99_ms=all_lat[int(0.99 * (len(all_lat) - 1))] * 1e3,
        client_failures=sum(failures), bad_replies=sum(bad),
    )


def serve_phase(device: str = "cuda") -> dict:
    """The main path: an InferenceService on ``device`` over a LocalRouter.
    Returns the traffic results, the fused kernel's launch count over the
    whole run and the service's counters."""
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.models.families import build_family
    from tpu_rl_torch.ops import fused_act as FA
    from tpu_rl_torch.runtime.inference_service import InferenceService
    from tpu_rl_torch.runtime.local_router import LocalRouter
    from tpu_rl_torch.utils.timer import ExecutionTimer

    cfg = Config.from_dict(SERVE_CFG)
    family = build_family(cfg, device=device)
    params = seeded_params(family, 0)
    router = LocalRouter()

    # A window that holds every flush of a mix, for the mean flush time.
    timer = ExecutionTimer(window=1_000_000)
    FA.LAUNCHES = 0  # every launch from here on is the main path's
    svc = InferenceService(cfg, family, params, router, timer, seed=0, device=device).start()
    try:
        if not svc.wait_ready(300.0) or svc.error is not None:
            fail(f"inference service did not start: {svc.error!r}")
        mixes = []
        # 2 x 4 x 1000 is bench.py's chip default; 64 x 4 x 100 fills the
        # 256-row bucket.
        for n_clients, acts, tag in ((2, 1000, "mix1"), (64, 100, "mix2")):
            timer.elapsed.clear()
            timer.gauges.clear()
            mix = drive(cfg, router, n_clients, 4, acts, tag)
            # host clock around staging, H2D, act step, D2H sync and replies
            mix["flush_ms"] = timer.mean_elapsed("inference-step-time") * 1e3
            mix["flush_rows"] = timer.mean_gauge("inference-batch-size")
            mixes.append(mix)

        # Carry persistence and the parameter swap, from one probe client
        # while no other traffic flows (so its flushes hold only its rows).
        probe = router.client(b"probe")
        rng = np.random.default_rng(99)
        obs1, obs2 = (rng.standard_normal((4, 4)).astype(np.float32) for _ in range(2))
        r1 = probe.act(obs1, np.ones(4, np.float32))
        r2 = probe.act(obs2, np.zeros(4, np.float32))
        if r1 is None or r2 is None:
            fail("probe client got no reply")
        zeros = torch.zeros((4, cfg.hidden_size))
        cpu_actor = {k: v.cpu() for k, v in params["actor"].items()}
        _lg, h2, c2 = FA.fused_act_step_plain(cpu_actor, torch.from_numpy(obs1), zeros, zeros)
        carry_err = max(
            float(np.abs(r1["hx"]).max()), float(np.abs(r1["cx"]).max()),
            float(np.abs(r2["hx"] - h2.numpy()).max()), float(np.abs(r2["cx"] - c2.numpy()).max()),
        )
        if carry_err > 1e-5:
            fail(f"server-side carry: reply 2's hx/cx differ from reply 1's post-step carry by {carry_err}")

        new = seeded_params(family, 1)
        svc.set_params(new, version=7)
        r3 = probe.act(obs1, np.ones(4, np.float32))
        if r3 is None or r3["ver"] != 7:
            fail(f"after set_params(version=7) the reply says ver={None if r3 is None else r3['ver']}")
        if np.allclose(r3["logits"], r1["logits"], atol=1e-4):
            fail("set_params did not change the served policy")
        new_cpu = {k: v.cpu() for k, v in new["actor"].items()}
        want, _h, _c = FA.fused_act_step_plain(new_cpu, torch.from_numpy(obs1), zeros, zeros)
        swap_err = float(np.abs(r3["logits"] - want.numpy()).max())
        if swap_err > 1e-5:
            fail(f"swapped policy's logits differ from the plain version by {swap_err}")
    finally:
        svc.close()
    launches = FA.LAUNCHES
    if svc.error is not None:
        fail(f"inference service died: {svc.error!r}")
    return dict(
        mixes=mixes, launches=launches, warmups=len(svc.buckets), flushes=svc.n_batches,
        buckets=svc.buckets, n_flush_bucket=dict(sorted(svc.n_flush_bucket.items())),
        n_requests=svc.n_requests, n_replies=svc.n_replies,
        n_flush_full=svc.n_flush_full, n_flush_deadline=svc.n_flush_deadline,
        n_rejected_payload=svc.n_rejected_payload, carry_err=carry_err, swap_err=swap_err,
    )

# ------------------------------------------------------------ LSTM kernels
def lstm_bounds(B: int, S: int, H: int) -> dict:
    """Least time (ms) of B1 and B2 on an H100, and what bounds each: the
    larger of the bytes each must move (inputs read once, outputs written
    once) over HBM's rate and its recurrent product's multiply-adds
    (2*B*S*H*4H operations) over the f32 peak."""
    G = 4 * H
    seq, rows = B * S, B
    fwd = 4 * (seq * G + H * G + 2 * rows * H + seq + 2 * seq * H + seq * G)
    bwd = 4 * (seq * G + 3 * seq * H + rows * H + seq + G * H + seq * G + 2 * rows * H)
    t_ops = 2 * B * S * H * G / F32_FLOPS_PER_S
    out = {}
    for name, nbytes in (("lstm_fwd", fwd), ("lstm_bwd", bwd)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[name] = dict(
            bytes=nbytes, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
    return out


def max_err(got, want) -> float:
    return float((got.detach().float() - want.detach().float()).abs().max())


def lstm_phase() -> list[dict]:
    """B1 and B2 against their plain versions at LSTM_SHAPES, and the whole
    autograd Function (both kernels plus the dwh product) against the plain
    backward. The inputs are at the scales of the training path: lecun-scale
    wh, unit xp, carries and cotangents, and a keep mask with ~20% resets
    (every row reset at step 0 on half the rows)."""
    from tpu_rl_torch.ops import lstm as L

    rows = []
    for B, S, H in LSTM_SHAPES:
        g = torch.Generator().manual_seed(B * 7 + S * 3 + H)
        rnd = lambda *shape: torch.randn(shape, generator=g).cuda()  # noqa: E731
        xp, h0, c0 = rnd(B, S, 4 * H), rnd(B, H), rnd(B, H)
        wh = rnd(H, 4 * H) / H**0.5
        keep = (torch.rand((B, S), generator=g) >= 0.2).float()
        keep[: B // 2, 0] = 0.0
        keep = keep.cuda()
        dhs, dcs = rnd(B, S, H), rnd(B, S, H)

        hs, cs, acts = L.lstm_fwd(xp, wh, h0, c0, keep)
        dxp, dh0, dc0 = L.lstm_bwd(wh, h0, c0, keep, hs, cs, acts, dhs, dcs)
        torch.cuda.synchronize()
        hs_p, cs_p, acts_p = L.lstm_forward_plain(xp, wh, h0, c0, keep)
        dxp_p, dwh_p, dh0_p, dc0_p = L.lstm_backward_plain(wh, h0, c0, keep, hs_p, cs_p, acts_p, dhs, dcs)
        fwd_err = max(max_err(hs, hs_p), max_err(cs, cs_p), max_err(acts, acts_p))
        bwd_err = max(max_err(dxp, dxp_p), max_err(dh0, dh0_p), max_err(dc0, dc0_p))

        # The autograd Function end to end: B1, B2 and the dwh product.
        leaves = [t.clone().requires_grad_() for t in (xp, wh, h0, c0)]
        hs_f, cs_f = L.lstm_unroll(*leaves, keep)
        grads = torch.autograd.grad((hs_f, cs_f), leaves, (dhs, dcs))
        torch.cuda.synchronize()
        fn_err = max(
            max_err(hs_f, hs_p), max_err(grads[0], dxp_p), max_err(grads[2], dh0_p),
            max_err(grads[3], dc0_p),
        )
        dwh_err = max_err(grads[1], dwh_p)
        # dwh is a (B*S)-deep contraction, summed in another order by the
        # product and by the plain per-step loop: its rounding grows with
        # its magnitude, so its tolerance is relative to its largest entry.
        dwh_scale = max(1.0, float(dwh_p.abs().max()))
        dwh_tol = LSTM_GRAD_TOL * dwh_scale
        finite = all(bool(torch.isfinite(t).all()) for t in (hs, cs, acts, dxp, dh0, dc0, grads[1]))
        if not (finite and fwd_err <= LSTM_FWD_TOL and bwd_err <= LSTM_GRAD_TOL
                and fn_err <= LSTM_GRAD_TOL and dwh_err <= dwh_tol):
            fail(
                f"LSTM kernels vs plain at (B,S,H)={(B, S, H)}: fwd {fwd_err} (tol {LSTM_FWD_TOL}), "
                f"bwd {bwd_err} / Function {fn_err} (tol {LSTM_GRAD_TOL}), dwh {dwh_err} "
                f"(tol {dwh_tol}), finite {finite}"
            )

        iters = 100 if B * S * H <= 100_000 else 10
        fwd_ms = device_ms(lambda: L.lstm_fwd(xp, wh, h0, c0, keep), iters=iters)
        fwd_plain_ms = device_ms(lambda: L.lstm_forward_plain(xp, wh, h0, c0, keep), iters=iters)
        bwd_ms = device_ms(lambda: L.lstm_bwd(wh, h0, c0, keep, hs, cs, acts, dhs, dcs), iters=iters)
        bwd_plain_ms = device_ms(
            lambda: L.lstm_backward_plain(wh, h0, c0, keep, hs, cs, acts, dhs, dcs), iters=iters
        )
        bounds = lstm_bounds(B, S, H)
        row = dict(
            shape=dict(B=B, S=S, H=H),
            fwd_err=fwd_err, bwd_err=bwd_err, function_err=fn_err, dwh_err=dwh_err, dwh_tol=dwh_tol,
            lstm_fwd=dict(ms=fwd_ms, plain_ms=fwd_plain_ms, **bounds["lstm_fwd"]),
            lstm_bwd=dict(ms=bwd_ms, plain_ms=bwd_plain_ms, **bounds["lstm_bwd"]),
        )
        rows.append(row)
        for name in ("lstm_fwd", "lstm_bwd"):
            r = row[name]
            print(
                f"{name} B={B} S={S} H={H}: kernel_ms={r['ms']:.6f} plain_ms={r['plain_ms']:.6f} "
                f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}, {r['bytes']} bytes)",
                flush=True,
            )
        print(
            f"lstm B={B} S={S} H={H}: max_abs_err hs/cs/acts {fwd_err:.3e} (tol {LSTM_FWD_TOL:g}), "
            f"dxp/dh0/dc0 {bwd_err:.3e} (tol {LSTM_GRAD_TOL:g}), Function {fn_err:.3e}, "
            f"dwh {dwh_err:.3e} (tol {dwh_tol:.3e})",
            flush=True,
        )
    return rows


# ---------------------------------------------------------------- training
def train_phase(card: str) -> dict:
    """The main training path: ColocatedLoop.program at the default config,
    TRAIN_WARMUP untimed then TRAIN_UPDATES timed updates. The launch
    counters are zeroed just before the timed updates and read just after."""
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import fused_act as FA
    from tpu_rl_torch.ops import lstm as L
    from tpu_rl_torch.runtime.colocated import ColocatedLoop, act_params

    cfg = Config(**TRAIN_CFG)
    loop = ColocatedLoop(cfg, seed=0, device="cuda")
    n, s = loop.cfg.batch_size, loop.cfg.seq_len
    state, carry, stats = loop.state, loop.init_carry(), loop.init_stats()
    for _ in range(TRAIN_WARMUP):
        state, carry, stats, metrics = loop.program(state, carry, stats)
    torch.cuda.synchronize()
    fa0 = FA.LAUNCHES
    L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_UPDATES):
        state, carry, stats, metrics = loop.program(state, carry, stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fwd, bwd = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
    want = TRAIN_UPDATES * cfg.K_epoch
    if fwd != want or bwd != want:
        fail(f"training launched lstm_fwd {fwd} and lstm_bwd {bwd} times, want {want} each")
    if FA.LAUNCHES != fa0:
        fail("the colocated loop launched the fused act kernel")
    host = {k: float(v) for k, v in metrics.items() if k != "diag"}
    if not all(np.isfinite(v) for v in host.values()) or host["nonfinite-updates"] != 0.0:
        fail(f"training metrics not finite: {host}")
    if not all(bool(torch.isfinite(p).all()) for p in state.params["actor"].values()):
        fail("training params not finite")

    # Where one update's time goes: the rollout and the train step apart,
    # each closed by a synchronize, on the host clock.
    roll, train = [], []
    for _ in range(20):
        t1 = time.perf_counter()
        carry, batch, _done, _ret = loop.rollout(act_params(state), carry)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state, _m = loop.train_step(state, batch)
        torch.cuda.synchronize()
        roll.append(t2 - t1)
        train.append(time.perf_counter() - t2)

    # Device busy share and kernels per update over a few updates, from the
    # profiler's device events.
    busy = kernels_per_update = None
    n_prof = 10
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t3 = time.perf_counter()
            for _ in range(n_prof):
                state, carry, stats, _m = loop.program(state, carry, stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t3
        device = [
            e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
        ]
        device_us = sum(e.self_device_time_total for e in device)
        if device_us > 0:
            busy = device_us / 1e6 / wall
            kernels_per_update = sum(e.count for e in device) / n_prof
    except (RuntimeError, AttributeError) as e:
        print(f"training profile: not measured ({e!r})", flush=True)

    out = dict(
        updates=TRAIN_UPDATES, batch=n, seq=s, hidden=cfg.hidden_size,
        ms_per_update=dt / TRAIN_UPDATES * 1e3, transitions_per_s=TRAIN_UPDATES * n * s / dt,
        rollout_ms=statistics.median(roll) * 1e3, train_step_ms=statistics.median(train) * 1e3,
        lstm_fwd_launches=fwd, lstm_bwd_launches=bwd, device_busy=busy,
        device_events_per_update=kernels_per_update,
        episodes=int(stats["episodes"]), loss=host["loss"],
    )
    print(
        f"training PPO CartPole B={n} S={s} H={cfg.hidden_size}: {TRAIN_UPDATES} updates, "
        f"ms/update={out['ms_per_update']:.4f} transitions/s={out['transitions_per_s']:.1f} "
        f"rollout_ms={out['rollout_ms']:.4f} train_step_ms={out['train_step_ms']:.4f} "
        f"device_busy={'not measured' if busy is None else f'{busy:.4f}'} "
        f"device_events/update={kernels_per_update} "
        f"lstm_fwd launches={fwd} lstm_bwd launches={bwd} (= updates x K_epoch {cfg.K_epoch}) "
        f"fused_act launches +0 [{card}]",
        flush=True,
    )
    return out


def learn_phase(card: str) -> dict:
    """tpu_rl's colocated learning check through ColocatedLoop.run."""
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import lstm as L
    from tpu_rl_torch.runtime.colocated import ColocatedLoop

    L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
    loop = ColocatedLoop(Config(**LEARN_CFG), seed=0, max_updates=LEARN_UPDATES, device="cuda")
    out = loop.run(log=True)
    fwd, bwd = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
    print(
        f"learning: {out['updates']} updates, {out['episodes']} episodes, best-window mean return "
        f"{out['mean_return_best_window']:.1f} (bar {LEARN_BAR}), {out['elapsed_s']:.1f} s, "
        f"{out['transitions_per_s']:.1f} transitions/s, lstm launches {fwd}/{bwd} [{card}]",
        flush=True,
    )
    if out["mean_return_best_window"] < LEARN_BAR or out["episodes"] < LEARN_EPISODES:
        fail(f"no learning: {out}")
    if fwd != out["updates"] or bwd != out["updates"]:
        fail(f"learning run launched lstm_fwd {fwd} / lstm_bwd {bwd} for {out['updates']} updates")
    return out


# ---------------------------------------------------------- attention (B4)
def attn_inputs(B, T, H, D, dtype, seams, seed, shuffled=False, device="cuda"):
    """Seeded q, k, v as strided views of one (B,T,3,H,D) qkv tensor (as the
    model hands them to the kernel), int32 segment ids with ~``seams``
    seams per row, and an output cotangent. ``shuffled`` permutes each
    row's ids: segments then interleave and the ids are not monotone, which
    the tile-skip rule must also get right."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((B, T, 3, H, D), generator=g).to(dtype).to(device)
    firsts = (torch.rand((B, T), generator=g) < seams / T).to(torch.int32)
    firsts[:, 0] = 1
    seg = torch.cumsum(firsts, 1, dtype=torch.int32)
    if shuffled:
        seg = torch.stack([row[torch.randperm(T, generator=g)] for row in seg])
    do = torch.randn((B, T, H, D), generator=g).to(dtype).to(device)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], seg.contiguous().to(device), do


def visible_pairs(seg: torch.Tensor) -> int:
    """Query-key pairs B4's mask keeps in this run's data: a segment id that
    occurs c times in a row keeps c(c+1)/2 (query, key) pairs, wherever its
    rows lie."""
    counts = [torch.unique(row, return_counts=True)[1] for row in seg]
    return int(sum(int((c * (c + 1) // 2).sum()) for c in counts))


def tile_visits(seg: torch.Tensor) -> tuple[int, int]:
    """(tile pairs the bf16 kernels visit, causal tile pairs) per head, by
    the kernels' own skip rule (``ops.attention.visited_tiles``)."""
    from tpu_rl_torch.ops import attention as A

    r = A.tile_ranges(seg)
    n = r[0].shape[1]
    return int(A.visited_tiles(r, r).sum()), seg.shape[0] * n * (n + 1) // 2


def attn_bounds(B: int, T: int, H: int, D: int, elt: int, pairs: int) -> dict:
    """Least time (ms) of B4's forward and backward on an H100: the larger of
    the bytes each must move (q, k, v, seg and the forward's o and lse, and
    do, read once; o, lse, dq, dk, dv written once) over HBM's rate, and
    its operations over the dtype's peak. The operations count the pairs
    this run's mask keeps, per head 2*D for each of the products that
    touch a pair: 2 forward (s, o) and 5 backward (s, dp, dv, dq, dk); with
    one segment per row that is 2*B*H*T^2*D and 5*B*H*T^2*D."""
    n = B * T * H * D * elt
    small = 4 * B * T + 4 * B * H * T  # seg, lse
    peak = BF16_FLOPS_PER_S if elt == 2 else F32_FLOPS_PER_S
    out = {}
    for name, nbytes, products in (("flash_attn_fwd", 4 * n + small, 2),
                                   ("flash_attn_bwd", 8 * n + small, 5)):
        flops = products * 2 * D * H * pairs
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        out[name] = dict(
            bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
    return out


def attn_check(got: dict, want: dict, dtype: torch.dtype) -> dict:
    """For each output: its max abs error, the median and max |ref|, the
    tolerance and the share of it used (at most 1 passes). f32 outputs and
    lse: ATTN_F32_TOL, absolute. bf16 o and gradients: element by element,
    BF16_ULP * |ref| + BF16_FLOOR * max|ref|."""
    out = {}
    for n in got:
        err = (got[n].float() - want[n].float()).abs()
        ref = want[n].float().abs()
        top = float(ref.max())
        if dtype == torch.float32 or n == "lse":
            tol = ATTN_F32_TOL[0] if n in ("o", "lse") else ATTN_F32_TOL[1]
            used, tol_text = float(err.max()) / tol, f"{tol:g}"
        else:
            floor = BF16_FLOOR * top
            used = float((err / (BF16_ULP * ref + floor)).max())
            tol_text = f"2^-7|ref|+{floor:.3e}"
        out[n] = dict(err=float(err.max()), median_ref=float(ref.median()), max_ref=top,
                      tol=tol_text, used=used)
    return out


def attention_phase() -> list[dict]:
    """B4's forward and backward kernels against their plain versions at
    ATTN_SHAPES, with their times beside the plain versions',
    scaled_dot_product_attention's (the library call for the same function,
    timed here, never called by the port) and the bound."""
    import torch.nn.functional as F

    from tpu_rl_torch.ops import attention as A

    rows = []
    for B, T, H, D, dtype, seams, shuffled in ATTN_SHAPES:
        q, k, v, seg, do = attn_inputs(B, T, H, D, dtype, seams, B * T + D, shuffled)
        # the bf16 kernels' tile plan, made once per forward on the main path
        # and timed apart from the kernels
        plan = A.tile_plan(seg) if dtype == torch.bfloat16 else None
        visited, causal = tile_visits(seg)
        o, lse = A.flash_fwd(q, k, v, seg, plan)
        dq, dk, dv = A.flash_bwd(q, k, v, seg, o, lse, do, plan)
        torch.cuda.synchronize()
        o_p, lse_p = A.flash_attention_forward_plain(q, k, v, seg)
        grads_p = A.flash_attention_backward_plain(q, k, v, seg, o, lse, do)
        got = dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv)
        want = dict(o=o_p, lse=lse_p, dq=grads_p[0], dk=grads_p[1], dv=grads_p[2])
        checks = attn_check(got, want, dtype)
        errs = {n: c["err"] for n, c in checks.items()}
        finite = all(bool(torch.isfinite(t).all()) for t in got.values())
        if not finite or any(c["used"] > 1.0 for c in checks.values()):
            fail(f"B4 vs plain at {(B, T, H, D, dtype)}: {checks}, finite {finite}")

        big = B * H * T * T > 2**30
        kw = dict(iters=3, reps=3, warmup=2) if big else dict(iters=20, reps=5, warmup=3)
        fwd_ms = device_ms(lambda: A.flash_fwd(q, k, v, seg, plan), **kw)
        bwd_ms = device_ms(lambda: A.flash_bwd(q, k, v, seg, o, lse, do, plan), **kw)
        plan_ms = None if plan is None else device_ms(lambda: A.tile_plan(seg), **kw)
        fwd_plain_ms = device_ms(lambda: A.flash_attention_forward_plain(q, k, v, seg), **kw)
        bwd_plain_ms = device_ms(
            lambda: A.flash_attention_backward_plain(q, k, v, seg, o, lse, do), **kw
        )
        # The library call: SDPA over (B,H,T,D) views with the same mask as
        # a boolean attn_mask, forward alone and the backward of one graph.
        idx = torch.arange(T, device=seg.device)
        mask = ((idx[None, :] <= idx[:, None])[None] & (seg[:, :, None] == seg[:, None, :]))[:, None]
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))

        def sdpa():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        lib_err = max_err(out.transpose(1, 2), o_p)
        lib_fwd_ms = device_ms(sdpa, **kw)
        lib_bwd_ms = device_ms(
            lambda: torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
            **kw,
        )
        bounds = attn_bounds(B, T, H, D, q.element_size(), visible_pairs(seg))
        row = dict(
            shape=dict(B=B, T=T, H=H, D=D, dtype=str(dtype).split(".")[-1], seams=seams,
                       shuffled=shuffled),
            errs=errs, checks=checks, sdpa_err=lib_err, tiles_visited=visited,
            tiles_causal=causal, plan_ms=plan_ms,
            flash_attn_fwd=dict(ms=fwd_ms, plain_ms=fwd_plain_ms, library_ms=lib_fwd_ms,
                                **bounds["flash_attn_fwd"]),
            flash_attn_bwd=dict(ms=bwd_ms, plain_ms=bwd_plain_ms, library_ms=lib_bwd_ms,
                                **bounds["flash_attn_bwd"]),
        )
        rows.append(row)
        for name in ("flash_attn_fwd", "flash_attn_bwd"):
            r = row[name]
            print(
                f"{name} B={B} T={T} H={H} D={D} {row['shape']['dtype']}: kernel_ms={r['ms']:.6f} "
                f"plain_ms={r['plain_ms']:.6f} sdpa_ms={r['library_ms']:.6f} "
                f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}, {r['bytes']} bytes, "
                f"{r['flops']} flops)",
                flush=True,
            )
        print(
            f"flash_attn B={B} T={T} H={H} D={D} {row['shape']['dtype']}"
            f"{' shuffled ids' if shuffled else ''}: tile pairs visited {visited} of "
            f"{causal} causal (per head; the bf16 kernels' skip rule)"
            + ("" if plan_ms is None else f", tile plan {plan_ms:.6f} ms"),
            flush=True,
        )
        print(
            f"flash_attn B={B} T={T} H={H} D={D} {row['shape']['dtype']}: max_abs_err "
            + ", ".join(f"{n} {c['err']:.3e} (tol {c['tol']}, used {c['used']:.3f}; |ref| "
                        f"median {c['median_ref']:.3e} max {c['max_ref']:.3e})"
                        for n, c in checks.items())
            + f"; sdpa vs plain {lib_err:.3e}",
            flush=True,
        )
        del q, k, v, seg, do, o, lse, dq, dk, dv, o_p, lse_p, grads_p, got, want, out, mask, plan
        del qt, kt, vt
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------ transformer training
def tf_batch(cfg, seed: int, device: str = "cuda"):
    """A seeded batch at ``cfg``'s shape as tests/test_transformer.py builds
    one: every row starts an episode and has one more seam mid-window;
    uniform behaviour logits; 1-wide carry placeholders."""
    from tpu_rl_torch.types import Batch

    rng = np.random.default_rng(seed)
    B, S, A, D = cfg.batch_size, cfg.seq_len, cfg.action_space, int(cfg.obs_shape[0])
    firsts = np.zeros((B, S, 1), np.float32)
    firsts[:, 0] = 1.0
    firsts[np.arange(B), rng.integers(1, S, size=B)] = 1.0
    return Batch.from_mapping(dict(
        obs=rng.normal(size=(B, S, D)).astype(np.float32),
        act=rng.integers(0, A, size=(B, S, 1)).astype(np.float32),
        rew=(0.1 * rng.normal(size=(B, S, 1))).astype(np.float32),
        logits=np.full((B, S, A), -np.log(A), np.float32),
        log_prob=np.full((B, S, 1), -np.log(A), np.float32),
        is_fir=firsts, hx=np.zeros((B, S, 1), np.float32), cx=np.zeros((B, S, 1), np.float32),
    ), device=device)


def on_device(tree, device):
    if isinstance(tree, dict):
        return {k: on_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def tf_reference_check(dtype: str) -> dict:
    """One PPO step of a small transformer (flash impl, T=200 with seams) on
    the card, through B4's kernels, against the same step from the same
    state on the CPU, through B4's plain versions.

    float32 (D=32, the CUDA-core kernels): f32 on both sides, summed in
    other orders over 800 transitions: loss and grad norm at rtol 1e-4.
    bfloat16 (D=64, the tensor-core kernels): both sides round activations
    to bf16 at every layer, at other places (cuBLAS and the CPU's GEMMs
    round their f32 sums once; B4's kernels and plain versions differ by
    at most one bf16 ulp per element), so loss and grad norm are held at
    rtol 2e-3, the size of bf16's own effect: the CPU's bf16 step differs
    from its f32 step by about that much, printed beside."""
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.config import Config

    small = dict(batch_size=4, seq_len=200, n_layers=2, n_heads=2)
    if dtype == "float32":
        cfg = Config.from_dict(dict(TF_TRAIN_CFG, compute_dtype=dtype, hidden_size=64, **small))
        rtol = 1e-4
    else:
        cfg = Config.from_dict(dict(TF_TRAIN_CFG, compute_dtype=dtype, hidden_size=128, **small))
        rtol = 2e-3
    _f, state, step_cpu = get_algo("PPO").build(cfg, torch.Generator().manual_seed(0), device="cpu")
    _f, _s, step_dev = get_algo("PPO").build(cfg, torch.Generator().manual_seed(0), device="cuda")
    _new, want = step_cpu(state, tf_batch(cfg, 1, "cpu"))
    dev_state = state.replace(step=state.step.cuda(), params=on_device(state.params, "cuda"),
                              opt_state=on_device(state.opt_state, "cuda"))
    _new, got = step_dev(dev_state, tf_batch(cfg, 1, "cuda"))
    keys = ("loss", "grad-norm")
    out = {k: (float(got[k]), float(want[k])) for k in keys}
    gap = ""
    if dtype != "float32":
        f32 = cfg.replace(compute_dtype="float32")
        _f, state32, step32 = get_algo("PPO").build(f32, torch.Generator().manual_seed(0), device="cpu")
        _new, m32 = step32(state32, tf_batch(f32, 1, "cpu"))
        gap = "; the CPU's bf16 step vs its f32 step: " + " ".join(
            f"{k} {abs(out[k][1] - float(m32[k])) / abs(float(m32[k])):.3e}" for k in keys)
    for k, (g, w) in out.items():
        if not (np.isfinite(g) and abs(g - w) <= rtol * abs(w)):
            fail(f"transformer {dtype} train step on the card vs the CPU: {k} {g} vs {w} "
                 f"(rtol {rtol:g})")
    print(f"transformer {dtype} step (D={cfg.hidden_size // cfg.n_heads}) on the card vs the CPU: "
          + " ".join(f"{k} {g:.8f} vs {w:.8f} (rel {abs(g - w) / abs(w):.3e}, rtol {rtol:g})"
                     for k, (g, w) in out.items()) + gap, flush=True)
    return {k: dict(card=g, cpu=w, rtol=rtol) for k, (g, w) in out.items()}


def tf_train_phase(card: str) -> dict:
    """The transformer's learner path at full width: get_algo("PPO").build
    and its train_step on one seeded 16 x 2048 batch, TF_WARMUP untimed then
    TF_UPDATES timed updates. The B4 launch counters are zeroed just before
    the timed updates and read just after."""
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import attention as A

    reference = {dt: tf_reference_check(dt) for dt in ("float32", "bfloat16")}
    cfg = Config.from_dict(TF_TRAIN_CFG)
    _family, state, train_step = get_algo("PPO").build(
        cfg, torch.Generator().manual_seed(0), device="cuda"
    )
    # the bf16 model's build makes its products reduce in f32, as tpu_rl's do
    if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        fail("building the bf16 transformer left cuBLAS free to reduce bf16 products in bf16")
    batch = tf_batch(cfg, 0, "cuda")
    for _ in range(TF_WARMUP):
        state, metrics = train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.FLASH_FWD_LAUNCHES = A.FLASH_BWD_LAUNCHES = 0
    enqueue = []  # host time until train_step returns: what the host spends issuing it
    t0 = time.perf_counter()
    for _ in range(TF_UPDATES):
        t1 = time.perf_counter()
        state, metrics = train_step(state, batch)
        enqueue.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fwd, bwd = A.FLASH_FWD_LAUNCHES, A.FLASH_BWD_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * cfg.K_epoch * TF_UPDATES
    if fwd != want or bwd != want:
        fail(f"transformer training launched flash_attn_fwd {fwd} and flash_attn_bwd {bwd} "
             f"times, want {want} each")
    host = {k: float(v) for k, v in metrics.items() if k != "diag"}
    if not all(np.isfinite(v) for v in host.values()) or host["nonfinite-updates"] != 0.0:
        fail(f"transformer training metrics not finite: {host}")
    if not all(bool(torch.isfinite(p).all()) for p in state.params["actor"].values()):
        fail("transformer training params not finite")

    # B4's share of device time, device time per update and the device
    # busy share over a few updates.
    b4_share = busy = device_ms_per_update = None
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(TF_PROFILE):
                state, _m = train_step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in events)
        if device_us > 0:
            busy = device_us / 1e6 / wall
            b4_share = sum(e.self_device_time_total for e in events if "flash_" in e.key) / device_us
            device_ms_per_update = device_us / 1e3 / TF_PROFILE
    except (RuntimeError, AttributeError) as e:
        print(f"transformer profile: not measured ({e!r})", flush=True)

    n, s = cfg.batch_size, cfg.seq_len
    out = dict(
        updates=TF_UPDATES, batch=n, seq=s, hidden=cfg.hidden_size, heads=cfg.n_heads,
        layers=cfg.n_layers, dtype=cfg.compute_dtype, ms_per_update=dt / TF_UPDATES * 1e3,
        transitions_per_s=TF_UPDATES * n * s / dt, max_memory_allocated=peak,
        enqueue_ms=statistics.median(enqueue) * 1e3, device_ms_per_update=device_ms_per_update,
        b4_device_share=b4_share, device_busy=busy, flash_attn_fwd_launches=fwd,
        flash_attn_bwd_launches=bwd, loss=host["loss"], reference=reference,
    )
    print(
        f"transformer training PPO B={n} T={s} d={cfg.hidden_size} heads={cfg.n_heads} "
        f"layers={cfg.n_layers} {cfg.compute_dtype} flash: {TF_UPDATES} updates, "
        f"ms/update={out['ms_per_update']:.4f} transitions/s={out['transitions_per_s']:.1f} "
        f"host enqueue ms/update={out['enqueue_ms']:.4f} device ms/update="
        f"{'not measured' if device_ms_per_update is None else f'{device_ms_per_update:.4f}'} "
        f"max_memory_allocated={peak} B4 share of device time="
        f"{'not measured' if b4_share is None else f'{b4_share:.4f}'} device_busy="
        f"{'not measured' if busy is None else f'{busy:.4f}'} loss={host['loss']:.6f} "
        f"flash_attn_fwd launches={fwd} flash_attn_bwd launches={bwd} "
        f"(= n_layers x K_epoch x updates {want}) [{card}]",
        flush=True,
    )
    return out


def tf_colocated_phase(card: str) -> dict:
    """The transformer's colocated loop: ColocatedLoop.program on
    configs/longcontext_singlechip.example.json with the flash impl for
    TF_COLOCATED_UPDATES updates (KV-cached acting, training through B4)."""
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import attention as A
    from tpu_rl_torch.runtime.colocated import ColocatedLoop

    raw = json.loads((ROOT / "configs" / "longcontext_singlechip.example.json").read_text())
    raw.update(attention_impl="flash", env_mode="colocated")
    cfg = Config.from_dict(raw)
    loop = ColocatedLoop(cfg, seed=0, device="cuda")
    state, carry, stats = loop.state, loop.init_carry(), loop.init_stats()
    torch.cuda.synchronize()
    A.FLASH_FWD_LAUNCHES = A.FLASH_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(TF_COLOCATED_UPDATES):
        state, carry, stats, metrics = loop.program(state, carry, stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fwd, bwd = A.FLASH_FWD_LAUNCHES, A.FLASH_BWD_LAUNCHES
    want = cfg.n_layers * cfg.K_epoch * TF_COLOCATED_UPDATES
    if fwd != want or bwd != want:
        fail(f"transformer colocated loop launched flash_attn_fwd {fwd} and flash_attn_bwd "
             f"{bwd} times, want {want} each")
    host = {k: float(v) for k, v in metrics.items() if k != "diag"}
    if not all(np.isfinite(v) for v in host.values()) or host["nonfinite-updates"] != 0.0:
        fail(f"transformer colocated metrics not finite: {host}")
    episodes = int(stats["episodes"])
    if episodes < 1:
        fail("the transformer colocated loop finished no episode")

    # One acting tick (decode, sampling, env step), where the rollout's time
    # goes: host clock over 32 ticks, device time over 8 in the profiler.
    params = {"actor": state.params["actor"]}
    with torch.no_grad():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(32):
            carry, _ys = loop._tick(params, carry, loop.generator)
        torch.cuda.synchronize()
        tick_ms = (time.perf_counter() - t1) / 32 * 1e3
        tick_device_ms = tick_events = None
        try:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(8):
                    carry, _ys = loop._tick(params, carry, loop.generator)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            if events:
                tick_device_ms = sum(e.self_device_time_total for e in events) / 1e3 / 8
                tick_events = sum(e.count for e in events) / 8
        except (RuntimeError, AttributeError) as e:
            print(f"tick profile: not measured ({e!r})", flush=True)
    n, s = loop.cfg.batch_size, loop.cfg.seq_len
    out = dict(
        updates=TF_COLOCATED_UPDATES, batch=n, seq=s, act_ctx=cfg.effective_act_ctx,
        ms_per_update=dt / TF_COLOCATED_UPDATES * 1e3,
        transitions_per_s=TF_COLOCATED_UPDATES * n * s / dt, episodes=episodes,
        mean_return=float(stats["ret_sum"]) / episodes, loss=host["loss"],
        flash_attn_fwd_launches=fwd, flash_attn_bwd_launches=bwd, tick_ms=tick_ms,
        tick_device_ms=tick_device_ms, tick_device_events=tick_events,
    )
    print(
        f"transformer colocated PPO CartPole B={n} T={s} act_ctx={cfg.effective_act_ctx} "
        f"d={cfg.hidden_size} {cfg.compute_dtype} flash: {TF_COLOCATED_UPDATES} updates, "
        f"ms/update={out['ms_per_update']:.1f} transitions/s={out['transitions_per_s']:.1f} "
        f"episodes={episodes} mean_return={out['mean_return']:.2f} loss={host['loss']:.6f} "
        f"flash launches {fwd}/{bwd} (= {want}); one tick {tick_ms:.4f} ms, device "
        f"{'not measured' if tick_device_ms is None else f'{tick_device_ms:.4f}'} ms in "
        f"{tick_events} device events [{card}]",
        flush=True,
    )
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs one CUDA card")
    try:
        import tpu_rl_torch
    except ImportError as e:
        fail(f"the tpu_rl_torch package is not beside this script: {e}")
    if Path(tpu_rl_torch.__file__).resolve().parent.parent != ROOT:
        fail(f"tpu_rl_torch was imported from {tpu_rl_torch.__file__}, not from {ROOT}")
    if any(m.split(".")[0] in ("jax", "flax", "tpu_rl") for m in sys.modules):
        fail("JAX or the JAX package was imported")
    t_start = time.perf_counter()

    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(
        f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}",
        flush=True,
    )

    from tpu_rl_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.3f} s", flush=True)
    for line in build.resource_usage():
        print(f"ptxas: {line}", flush=True)

    shapes = kernel_phase()
    serving = serve_phase()
    for mix in serving["mixes"]:
        print(
            f"serving {mix['clients']} clients x {mix['envs']} envs x {mix['acts']} acts: "
            f"acts/s={mix['acts_per_s']:.1f} p50_ms={mix['p50_ms']:.4f} "
            f"p99_ms={mix['p99_ms']:.4f} flush_ms={mix['flush_ms']:.4f} "
            f"flush_rows={mix['flush_rows']:.1f} client_failures={mix['client_failures']} "
            f"bad_replies={mix['bad_replies']} [{card}]",
            flush=True,
        )
    print(
        f"serving flushes per bucket {serving['n_flush_bucket']} "
        f"(full {serving['n_flush_full']}, deadline {serving['n_flush_deadline']}); "
        f"requests {serving['n_requests']} replies {serving['n_replies']}; "
        f"fused_act launches {serving['launches']} = warm-ups {serving['warmups']} "
        f"+ flushes {serving['flushes']}; carry err {serving['carry_err']:.3e}, "
        f"swap err {serving['swap_err']:.3e}",
        flush=True,
    )
    for mix in serving["mixes"]:
        if mix["client_failures"] or mix["bad_replies"]:
            fail(f"serving mix {mix}: requests unanswered or replies malformed")
    if serving["n_replies"] != serving["n_requests"] or serving["n_rejected_payload"]:
        fail(f"replies {serving['n_replies']} != requests {serving['n_requests']}")
    if serving["launches"] != serving["warmups"] + serving["flushes"]:
        fail("fused_act.LAUNCHES is not warm-ups plus flushes")
    if serving["launches"] == 0:
        fail("the main path never launched the fused act kernel")

    lstm_rows = lstm_phase()
    training = train_phase(card)
    learning = learn_phase(card)
    attn_rows = attention_phase()
    tf_training = tf_train_phase(card)
    tf_colocated = tf_colocated_phase(card)

    main_path = [r for r in shapes if r["shape"]["H"] == 256 and r["shape"]["D"] == 4]
    top = next(r for r in main_path if r["shape"]["rows"] == 256)
    kernels = [dict(
        name="fused_act",
        route="cuda",
        source="tpu_rl_torch/csrc/fused_act.cu",
        replaces="tpu_rl/ops/pallas_act.py:52",
        launches=serving["launches"],
        max_abs_err=max(r["max_abs_err"] for r in main_path),
        ms=top["kernel_ms"],
        plain_ms=top["plain_ms"],
        bound_ms=top["bound_ms"],
        bound_by=top["bound_by"],
        library_ms=None,  # no single PyTorch call computes the fused act step
        unfused_ms=top["unfused_ms"],
        act_ms=top["act_ms"],
        at=top["shape"],
        card=card,
        shapes=shapes,
    )]
    lstm_main = lstm_rows[0]  # (128, 5, 64), the training path's shape
    for name, replaces, launches in (
        ("lstm_fwd", "tpu_rl/ops/pallas_lstm.py:99", training["lstm_fwd_launches"]),
        ("lstm_bwd", "tpu_rl/ops/pallas_lstm.py:373", training["lstm_bwd_launches"]),
    ):
        r = lstm_main[name]
        kernels.append(dict(
            name=name,
            route="cuda",
            source=f"tpu_rl_torch/csrc/{name}.cu",
            replaces=replaces,
            launches=launches,
            max_abs_err=max(
                (x["fwd_err"] if name == "lstm_fwd" else max(x["bwd_err"], x["function_err"]))
                for x in lstm_rows
            ),
            ms=r["ms"],
            plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"],
            bound_by=r["bound_by"],
            # No single PyTorch call computes a keep-masked LSTM with
            # per-row, per-step carry resets (cuDNN's LSTM resets nothing
            # and has two biases).
            library_ms=None,
            at=lstm_main["shape"],
            card=card,
            shapes=[dict(shape=x["shape"], **x[name]) for x in lstm_rows],
        ))
    attn_main = attn_rows[0]  # (16, 2048, 8, 64) bf16, the transformer's main path
    for name, errs in (("flash_attn_fwd", ("o", "lse")), ("flash_attn_bwd", ("dq", "dk", "dv"))):
        r = attn_main[name]
        kernels.append(dict(
            name=name,
            route="cuda",
            # the bf16 main path's tensor-core kernel; f32 takes csrc/{name}.cu
            source=f"tpu_rl_torch/csrc/{name.replace('flash_attn', 'flash_attn_tc')}.cu",
            replaces="tpu_rl/parallel/sequence.py:608",
            launches=tf_training[f"{name}_launches"],
            max_abs_err=max(x["errs"][e] for x in attn_rows for e in errs),
            ms=r["ms"],
            plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"],
            bound_by=r["bound_by"],
            # scaled_dot_product_attention with the causal-and-segment mask
            # as a boolean attn_mask (forward; or the backward of its graph)
            library_ms=r["library_ms"],
            at=attn_main["shape"],
            tiles_visited=attn_main["tiles_visited"],
            tiles_causal=attn_main["tiles_causal"],
            plan_ms=attn_main["plan_ms"],
            card=card,
            shapes=[dict(shape=x["shape"], checks=x["checks"], tiles_visited=x["tiles_visited"],
                         tiles_causal=x["tiles_causal"], **x[name])
                    for x in attn_rows],
        ))
    print(json.dumps({"training": training, "learning": {
        k: v for k, v in learning.items() if k != "scalars"
    }, "transformer_training": tf_training, "transformer_colocated": tf_colocated}), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
