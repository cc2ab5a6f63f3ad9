"""LSTM sequence unroll — the port of ``tpu_rl.ops.pallas_lstm``.

:func:`lstm_unroll` runs the S-step recurrence over a precomputed input
projection with a per-row, per-step carry-keep mask (``h, c *= keep[t]``
before step t; gates i, f, g, o). Under autograd it is one
``torch.autograd.Function`` whose forward launches kernel B1
(``csrc/lstm_fwd.cu``, the counterpart of ``_pallas_forward``) and saves the
gate activations, and whose backward launches kernel B2
(``csrc/lstm_bwd.cu``, the counterpart of ``_pallas_backward``) for
``dxp, dh0, dc0``. The recurrent-weight gradient
``dwh = sum_t (h_prev[t]·keep[t])ᵀ dxp[t]`` is one plain product over
batch × time outside the kernel, as ``tpu_rl`` leaves it outside its own.

Layouts are batch-major, as at ``tpu_rl``'s public functions: xp (B,S,4H),
wh (H,4H), h0/c0 (B,H), keep (B,S); hs/cs (B,S,H), acts (B,S,4H). keep is
a 0/1 carry mask.

Both kernels split a row tile's hidden units across a thread-block cluster;
:func:`lstm_launch_plan` chooses the regime (wh's slices resident in shared
memory, or streamed every step), the cluster size, the rows per tile and
the thread tile from (B, S, H) in plain Python, so the CPU tests reach it,
and refuses with :class:`LstmPlanError` what the card cannot launch.

Each kernel entry is a ``torch.library.custom_op`` (``tpu_rl_torch::lstm_fwd``,
``tpu_rl_torch::lstm_bwd``) with a FLOP formula registered for
``torch.utils.flop_counter``: a counter charges each call its formula
(:func:`lstm_flops`, the plain version's recurrent products; B2's without
``dwh``, the product outside it) and does not descend into it, so the count
is the same whether the kernel or the plain version runs beneath. A wrapper
enters the operator only while a dispatch mode is active
(:func:`tpu_rl_torch.counted`); otherwise it calls the operator's function
directly and pays no dispatcher.

On a CUDA tensor the unroll always launches B1, and B2 under backward: there
is no dispatch gate. ``tpu_rl``'s gate (whole batch in one VMEM tile;
forward-only calls scan) was measured on a TPU and is not carried over;
re-deriving a gate for this card waits for a benchmark cell that can show
it end to end. The plain versions, :func:`lstm_forward_plain` and
:func:`lstm_backward_plain`, are the same math as Python loops over time;
they are taken only for tensors that lie on the CPU, and they are what the
kernels are held against.

Under bf16 compute ``tpu_rl`` never runs its f32 kernel: it runs the
mixed-precision scan, :func:`lstm_scan`, whose recurrent product is
:func:`mixed_dot` (bf16 operands, an f32 result, in both passes). Both are
here too, and neither is a kernel: the products are cuBLAS's on the card.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from tpu_rl_torch import counted, on_card
from tpu_rl_torch.kernels import build
from tpu_rl_torch.ops.matmul import mm_f32

# Kernel launches made through lstm_fwd / lstm_bwd (plain-version calls
# excluded).
LSTM_FWD_LAUNCHES = 0
LSTM_BWD_LAUNCHES = 0


# ------------------------------------------------------------ plain versions
def lstm_forward_plain(xp, wh, h0, c0, keep):
    """``_scan_forward``'s step math as a loop over time.
    Returns ``(hs, cs, acts)``; ``acts`` holds the post-activation gates
    ``[i, f, g, o]`` of every step."""
    S = xp.shape[1]
    H = wh.shape[0]
    h, c = h0, c0
    hs, cs, acts = [], [], []
    for t in range(S):
        kp = keep[:, t, None]
        h = h * kp
        c = c * kp
        z = xp[:, t] + h @ wh
        i = torch.sigmoid(z[:, :H])
        f = torch.sigmoid(z[:, H : 2 * H])
        g = torch.tanh(z[:, 2 * H : 3 * H])
        o = torch.sigmoid(z[:, 3 * H :])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
        acts.append(torch.cat([i, f, g, o], dim=-1))
    return torch.stack(hs, 1), torch.stack(cs, 1), torch.stack(acts, 1)


def lstm_backward_plain(wh, h0, c0, keep, hs, cs, acts, dhs, dcs):
    """The reverse loop of ``pallas_lstm._bwd``: analytic LSTM backprop from
    the saved gate activations and cell states. Returns
    ``(dxp, dwh, dh0, dc0)``."""
    S = hs.shape[1]
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
    c_prev = torch.cat([c0[:, None], cs[:, :-1]], dim=1)
    dh = torch.zeros_like(h0)
    dc = torch.zeros_like(c0)
    dwh = torch.zeros_like(wh)
    dzs = [None] * S
    for t in reversed(range(S)):
        kp = keep[:, t, None]
        i, f, g, o = torch.chunk(acts[:, t], 4, dim=-1)
        hp_used = h_prev[:, t] * kp
        cp_used = c_prev[:, t] * kp
        dh_t = dhs[:, t] + dh
        t_c2 = torch.tanh(cs[:, t])
        do = dh_t * t_c2
        dc_t = dcs[:, t] + dc + dh_t * o * (1.0 - t_c2 * t_c2)
        di = dc_t * g
        dg = dc_t * i
        df = dc_t * cp_used
        dz = torch.cat(
            [di * i * (1.0 - i), df * f * (1.0 - f), dg * (1.0 - g * g), do * o * (1.0 - o)],
            dim=-1,
        )
        dwh = dwh + hp_used.T @ dz
        dh = (dz @ wh.T) * kp
        dc = dc_t * f * kp
        dzs[t] = dz
    return torch.stack(dzs, 1), dwh, dh, dc


# -------------------------------------------------------------- launch plan
# The kernels' fixed sizes (csrc/lstm_common.cuh) and the card's limits.
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
SMEM_PER_SM = 233472
MAX_CLUSTER_PORTABLE, MAX_CLUSTER = 8, 16
MAX_RESIDENT_THREADS = 512
KC = 16  # streamed regime: k (B1) or gate columns (B2) per ring stage
LDK = KC + 4  # streamed regime: row length of a [row][k] stage tile
# Resident regime: thread tiles (rows x units per thread) the kernels are
# built for. Streamed regime: 16-row m-tiles (1 to 5 a block) and warps of
# 8 units (all four gates), on the tensor cores; at most 16 warps.
RESIDENT_TILES = ((1, 1), (4, 1))
STREAMED_TILE = (16, 8)
STREAMED_MAX_THREADS = 512
STREAMED_ROWS = (16, 32, 48, 64, 80)
# Clusters of each size an H100 holds at once at one block per SM
# (cudaOccupancyMaxActiveClusters on an H100 80GB HBM3: a cluster's blocks
# share one GPC); sizes between two keys take the larger key's count.
CLUSTERS_PER_CARD = {1: 132, 2: 66, 4: 30, 8: 15, 12: 7, 16: 7}
# Resident B2 pushes its partial dh (R x H floats a block a step) into the
# owners' slots over DSMEM up to this many floats; above it the global
# scratch through L2 was faster (lab/b12_lab.py push: H=64 at 8 rows push,
# H=256 at 20 rows global).
PUSH_MAX_FLOATS = 4096
# The cost model's constants, in cycles of one SM: a cluster barrier and
# the step's exchange, the bytes one SM takes in per cycle by cp.async
# (lab/b3_lab.py intake), and the f32 FMAs a cycle of the streamed
# regime's split-precision products on mma.sync (two mmas a product; set
# so that the model's wide-shape B1 is of the card's order).
STEP_SYNC_CYCLES = 1500
INTAKE_BYTES_PER_CYCLE = 10.0
STREAMED_FMA_PER_CYCLE = 256.0


class LstmPlanError(ValueError):
    """The LSTM kernels cannot launch at this shape."""


@dataclass(frozen=True)
class LstmPlan:
    """One launch of ``csrc/lstm_fwd.cu`` or ``csrc/lstm_bwd.cu``: a cluster
    of ``cluster`` blocks (one per slice of ``units`` hidden units) for each
    of ``row_tiles`` tiles of ``rows`` rows; ``threads`` threads a block,
    each owning ``tm`` rows x ``tu`` units (streamed: warps of ``tu``
    units over m-tiles of ``tm`` rows, on the tensor cores). ``resident``:
    each block holds its slice of wh in shared memory for all steps and the
    blocks exchange h (B1) and, with ``push``, the partial dh (B2) over
    distributed shared memory; else the slice streams through a ring of
    ``stages`` stages every step and the exchange goes through global
    memory. ``smem_fwd`` / ``smem_bwd``: bytes of shared memory a block of
    each kernel."""

    rows: int
    units: int
    cluster: int
    row_tiles: int
    tm: int
    tu: int
    threads: int
    resident: bool
    stages: int
    smem_fwd: int
    smem_bwd: int
    push: bool = True

    @property
    def nonportable(self) -> bool:
        """A cluster above 8 blocks needs the non-portable size attribute."""
        return self.cluster > MAX_CLUSTER_PORTABLE

    @property
    def blocks(self) -> int:
        return self.cluster * self.row_tiles

    @property
    def regime(self) -> str:
        return "resident" if self.resident else "streamed"

    def slices(self, H: int) -> list[range]:
        """The hidden units of each cluster rank."""
        return [range(u0, min(H, u0 + self.units)) for u0 in range(0, H, self.units)]

    def scratch_floats(self, H: int) -> int:
        """B2's global buffer of partial dh (without ``push``; else 0)."""
        return 0 if self.push else 2 * self.row_tiles * self.cluster * H * self.rows


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def resident_smem(H: int, R: int, U: int, C: int) -> tuple[int, int]:
    """Bytes of shared memory of a resident block of B1 and of B2: the
    slice (rows of 4U+1 floats; B2's up to whole windows of 4U units), B1's
    two h buffers, B2's dz and its two sets of C slots of R x U."""
    ldr, ldw = _round4(R), 4 * U + 1
    hp = -(-H // (4 * U)) * 4 * U
    fwd = _round4(H * ldw) + 2 * H * ldr
    bwd = _round4(hp * ldw) + 4 * U * ldr + 2 * C * U * ldr
    return 4 * fwd, 4 * bwd


def stream_ldw(U: int) -> int:
    """Row length of B1's [k][4U] stage tile: 4U padded to 8 mod 32."""
    return 4 * U + (8 - 4 * U) % 32


def streamed_stage(R: int, U: int) -> tuple[int, int]:
    """Floats of one ring stage of B1 (KC rows of the slice, the same k of
    h) and of B2 (KC gate columns of a window of 4U units of the slice, the
    same columns of dz)."""
    return KC * stream_ldw(U) + R * LDK, (4 * U + R) * LDK


def streamed_smem(R: int, U: int, stages: int) -> tuple[int, int]:
    """Bytes of shared memory of a streamed block of B1 (its ring, or the
    R x 4U pre-activations written over it, whichever is larger) and of
    B2 (its ring)."""
    sf, sb = streamed_stage(R, U)
    return 4 * max(stages * sf, R * stream_ldw(U)), 4 * stages * sb


def resident_clusters(C: int, smem: int, threads: int, regs: int) -> int:
    """Clusters of C blocks the card holds at once (the model's): blocks
    per SM by shared memory, threads and ``regs`` registers a thread, times
    the clusters of that size at one per SM."""
    regs = regs * -(-threads // 32) * 32
    per_sm = max(1, min(SMEM_PER_SM // (smem + 1024), 2048 // threads, 65536 // regs, 32))
    size = min(k for k in CLUSTERS_PER_CARD if k >= C)
    return CLUSTERS_PER_CARD[size] * per_sm


def plan_registers(plan: LstmPlan) -> int:
    """Registers a thread of the plan's kernels may take (their launch
    bounds; ptxas reports 48-62 for the one-row resident tile, 71-109 for
    the four-row one and 128 for the streamed one)."""
    return 64 if plan.resident and plan.tm == 1 else 128


def plan_cycles(B: int, S: int, H: int, plan: LstmPlan) -> float:
    """The model's cycles of one SM for one launch of B1: waves of
    clusters x (S steps + a resident slice's one load). A step is the
    larger of the instructions its warps issue on the SM's four schedulers
    (per k: TM + 4 TU loads and 4 TM TU FMAs; blocks of a wave share the
    SMs), a chain's latency (8 cycles a k) and the streamed slice's intake,
    plus the barrier."""
    R, U, T, tm, tu = plan.rows, plan.units, plan.threads, plan.tm, plan.tu
    smem = max(plan.smem_fwd, plan.smem_bwd)
    capacity = resident_clusters(plan.cluster, smem, T, plan_registers(plan)) * plan.cluster
    waves = -(-plan.blocks // capacity)
    per_sm = -(-min(plan.blocks, capacity) // CLUSTERS_PER_CARD[1])
    if plan.resident:
        warps = max(1.0, per_sm * -(-T // 32) / 4)
        step = max(warps * H * (tm + 4 * tu + 4 * tm * tu), 8.0 * H)
        load = per_sm * 16.0 * H * U / INTAKE_BYTES_PER_CYCLE
    else:
        step = max(per_sm * R * 4 * U * H / STREAMED_FMA_PER_CYCLE,
                   per_sm * 4.0 * (4 * U + R) * H / INTAKE_BYTES_PER_CYCLE)
        load = 0.0
    return waves * (S * (step + STEP_SYNC_CYCLES) + load)


def _candidates(B: int, H: int, resident: bool):
    """Every plan of one regime that fits the card."""
    seen = set()
    for c in range(1, MAX_CLUSTER + 1):
        U = -(-H // c)
        if not resident:
            U = -(-U // 16) * 16  # a B2 stage's 16 gate columns lie in one gate
        C = -(-H // U)
        if (U, C) in seen or C > MAX_CLUSTER:
            continue
        seen.add((U, C))
        tiles = RESIDENT_TILES if resident else (STREAMED_TILE,)
        for tm, tu in tiles:
            if U % tu or (not resident and 32 * U // tu > STREAMED_MAX_THREADS):
                continue
            if not resident:
                rows = STREAMED_ROWS
            else:
                rows = range(tm, 8 * tm + 1, tm) if tm == 1 else range(2 * tm, 257, tm)
            for R in rows:
                threads = (R // tm) * (U // tu) if resident else 32 * U // tu
                row_tiles = -(-B // R)
                if row_tiles > 65535 or (resident and threads > MAX_RESIDENT_THREADS):
                    continue
                if resident:
                    fwd, bwd = resident_smem(H, R, U, C)
                    stages = 0
                else:
                    # two stages: no slower than three or four (lab/b12_lab.py stages)
                    stages = 2 if max(streamed_smem(R, U, 2)) <= SMEM_LIMIT else 0
                    if not stages:
                        continue
                    fwd, bwd = streamed_smem(R, U, stages)
                if max(fwd, bwd) > SMEM_LIMIT:
                    continue
                yield LstmPlan(rows=R, units=U, cluster=C, row_tiles=row_tiles, tm=tm, tu=tu,
                               threads=threads, resident=resident, stages=stages,
                               smem_fwd=fwd, smem_bwd=bwd,
                               push=resident and R * H <= PUSH_MAX_FLOATS)


def _preferred_cluster(cands, H: int) -> list[LstmPlan]:
    """The plans of the fewest unit slices at or above 8 (or of the most,
    below 8): clusters of 8 beat 16, 4 and 2 at every checked shape, in
    both regimes (``lab/b12_lab.py plans``)."""
    cands = list(cands)
    if not cands:
        return []
    cluster = min((p.cluster for p in cands), key=lambda c: (c < min(8, H), c))
    return [p for p in cands if p.cluster == cluster]


def _resident_plan(B: int, H: int) -> LstmPlan | None:
    """The resident regime's plan, by the rule the card's timings gave
    (``lab/b12_lab.py plans``, `PERF.md` §6): the fewest unit slices at or
    above 8 (clusters of 8 beat 16, 4 and 2 at every checked shape), then
    one-row, one-unit threads on tiles of up to 8 rows where a wave of such
    tiles covers the batch (fewer rows a tile only slow the block's loads),
    else 4-row threads on the shortest tiles that make one wave (4 rows a
    thread quadruple its chain), else the tallest tiles that fit."""
    cands = _preferred_cluster(_candidates(B, H, True), H)
    if not cands:
        return None

    def one_wave(p: LstmPlan) -> bool:
        fits = resident_clusters(p.cluster, max(p.smem_fwd, p.smem_bwd), p.threads, plan_registers(p))
        return p.row_tiles <= fits

    short = [p for p in cands if p.tm == 1 and one_wave(p) and p.rows <= max(1, B)]
    if short:
        return max(short, key=lambda p: p.rows)
    tall = [p for p in cands if p.tm > 1 and one_wave(p)]
    if tall:
        return min(tall, key=lambda p: p.rows)
    return max(cands, key=lambda p: p.rows)


@functools.lru_cache(maxsize=256)
def lstm_launch_plan(B: int, S: int, H: int) -> LstmPlan:
    """The launch plan of B1 and B2 for a batch of B rows, S steps and H
    hidden units. The resident regime wherever a block's slice of wh (16 H U
    bytes) fits beside its buffers (:func:`_resident_plan`), the streamed
    one where it does not (H a multiple of 4): there, clusters of 8 where
    possible, and the rows per tile and warp tile of the least modelled
    time (:func:`plan_cycles`: one wave of clusters, the slice's intake,
    the tensor cores' rate). Raises :class:`LstmPlanError` for what cannot
    launch."""
    for name, v in (("B", B), ("S", S), ("H", H)):
        if not isinstance(v, int) or v < 1:
            raise LstmPlanError(f"lstm_launch_plan: {name}={v!r} must be a positive int")
    plan = _resident_plan(B, H)
    if plan is None and H % 4 == 0:
        plan = min(_preferred_cluster(_candidates(B, H, False), H),
                   key=lambda p: plan_cycles(B, S, H, p), default=None)
    if plan is not None:
        return plan
    raise LstmPlanError(
        f"LSTM kernels cannot launch at B={B}, S={S}, H={H}: a resident slice of wh needs more "
        f"than {SMEM_LIMIT} bytes of shared memory"
        + (" and the streamed regime needs H to be a multiple of 4" if H % 4 else
           " and no streamed plan fits")
    )


# ------------------------------------------------------------------ binding
_PLAN_ARGS = [ctypes.c_int] * 14 + [ctypes.c_void_p]


def _plan_args(B: int, S: int, H: int, plan: LstmPlan, smem: int) -> tuple:
    return (B, S, H, plan.rows, plan.units, plan.cluster, plan.row_tiles, plan.tm, plan.tu,
            plan.threads, int(plan.resident), plan.stages, smem, int(plan.push))


def _check(fn: str, device: torch.device, tensors: dict, shapes: dict) -> None:
    """Device, dtype, shape, contiguity and 16-byte alignment of every
    kernel input."""
    for name, t in tensors.items():
        want = shapes[name]
        if t.device != device:
            raise ValueError(f"{fn}: {name} on {t.device}, the others on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} is {t.dtype}, the kernel takes float32")
        if tuple(t.shape) != want:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, want {want}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")


# ----------------------------------------------------------------- wrappers
def lstm_flops(B: int, S: int, H: int) -> int:
    """FLOPs of one call of B1, and of one of B2: the S recurrent products
    ``h @ wh`` (B2: ``dz @ whᵀ``) of B rows, 2·B·S·H·4H."""
    return 2 * B * S * H * 4 * H


def lstm_fwd(xp, wh, h0, c0, keep):
    """Kernel B1: ``(hs, cs, acts)``. CPU tensors take
    :func:`lstm_forward_plain`; CUDA tensors launch the kernel with
    :func:`lstm_launch_plan`'s plan. Under a FLOP counter it runs as the
    operator ``tpu_rl_torch::lstm_fwd``; a tensor on another device is
    refused first."""
    on_card("lstm_fwd", xp)
    return (_lstm_fwd_op if counted() else _lstm_fwd)(xp, wh, h0, c0, keep)


def _lstm_fwd(
    xp: Tensor, wh: Tensor, h0: Tensor, c0: Tensor, keep: Tensor
) -> tuple[Tensor, Tensor, Tensor]:
    if not on_card("lstm_fwd", xp):
        return lstm_forward_plain(xp, wh, h0, c0, keep)
    if xp.dim() != 3 or xp.shape[0] < 1 or xp.shape[1] < 1:
        raise ValueError(f"lstm_fwd: xp {tuple(xp.shape)}")
    B, S, G = xp.shape
    H = wh.shape[0]
    _check(
        "lstm_fwd", xp.device,
        {"xp": xp, "wh": wh, "h0": h0, "c0": c0, "keep": keep},
        {"xp": (B, S, 4 * H), "wh": (H, 4 * H), "h0": (B, H), "c0": (B, H), "keep": (B, S)},
    )
    out = _launch_fwd(xp, wh, h0, c0, keep, lstm_launch_plan(B, S, H))
    global LSTM_FWD_LAUNCHES
    LSTM_FWD_LAUNCHES += 1
    return out


def _launch_fwd(xp, wh, h0, c0, keep, plan: LstmPlan):
    """One launch of B1 with ``plan`` on checked inputs; counts nothing."""
    B, S, G = xp.shape
    H = wh.shape[0]
    hs = torch.empty((B, S, H), dtype=torch.float32, device=xp.device)
    cs = torch.empty_like(hs)
    acts = torch.empty((B, S, G), dtype=torch.float32, device=xp.device)
    # Asynchronous on the current stream; the caching allocator hands an
    # input's memory to later work on that stream only, after the kernel.
    err = build.bind("lstm_fwd", [ctypes.c_void_p] * 8 + _PLAN_ARGS)(
        xp.data_ptr(), wh.data_ptr(), h0.data_ptr(), c0.data_ptr(), keep.data_ptr(),
        hs.data_ptr(), cs.data_ptr(), acts.data_ptr(), *_plan_args(B, S, H, plan, plan.smem_fwd),
        torch.cuda.current_stream(xp.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"lstm_fwd kernel launch failed at B={B}, S={S}, H={H} with {plan}: CUDA error {err}")
    return hs, cs, acts


_lstm_fwd_op = torch.library.custom_op(
    "tpu_rl_torch::lstm_fwd", _lstm_fwd, mutates_args=()
)


@register_flop_formula(torch.ops.tpu_rl_torch.lstm_fwd)
def _lstm_fwd_flops(xp_shape, wh_shape, *_shapes, out_shape=None) -> int:
    B, S, _ = xp_shape
    return lstm_flops(B, S, wh_shape[0])


def lstm_bwd(wh, h0, c0, keep, hs, cs, acts, dhs, dcs):
    """Kernel B2: ``(dxp, dh0, dc0)`` from the forward's saved ``cs`` and
    ``acts`` and the output cotangents ``dhs``, ``dcs``. CPU tensors take
    :func:`lstm_backward_plain` (whose ``dwh`` is dropped); CUDA tensors
    launch the kernel, which reads wh as the forward does (no transpose).
    Under a FLOP counter it runs as the operator ``tpu_rl_torch::lstm_bwd``;
    a tensor on another device is refused first."""
    on_card("lstm_bwd", acts)
    args = (wh, h0, c0, keep, hs, cs, acts, dhs, dcs)
    return (_lstm_bwd_op if counted() else _lstm_bwd)(*args)


def _lstm_bwd(
    wh: Tensor, h0: Tensor, c0: Tensor, keep: Tensor, hs: Tensor, cs: Tensor, acts: Tensor,
    dhs: Tensor, dcs: Tensor,
) -> tuple[Tensor, Tensor, Tensor]:
    if not on_card("lstm_bwd", acts):
        dxp, _dwh, dh0, dc0 = lstm_backward_plain(wh, h0, c0, keep, hs, cs, acts, dhs, dcs)
        return dxp, dh0, dc0
    B, S, H = cs.shape
    G = 4 * H
    _check(
        "lstm_bwd", acts.device,
        {"acts": acts, "cs": cs, "c0": c0, "keep": keep, "dhs": dhs, "dcs": dcs, "wh": wh},
        {"acts": (B, S, G), "cs": (B, S, H), "c0": (B, H), "keep": (B, S),
         "dhs": (B, S, H), "dcs": (B, S, H), "wh": (H, G)},
    )
    out = _launch_bwd(wh, c0, keep, cs, acts, dhs, dcs, lstm_launch_plan(B, S, H))
    global LSTM_BWD_LAUNCHES
    LSTM_BWD_LAUNCHES += 1
    return out


def _launch_bwd(wh, c0, keep, cs, acts, dhs, dcs, plan: LstmPlan):
    """One launch of B2 with ``plan`` on checked inputs; counts nothing."""
    B, S, H = cs.shape
    dev = acts.device
    dxp = torch.empty((B, S, 4 * H), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dc0 = torch.empty_like(dh0)
    scratch = torch.empty((plan.scratch_floats(H),), dtype=torch.float32, device=dev)
    err = build.bind("lstm_bwd", [ctypes.c_void_p] * 11 + _PLAN_ARGS)(
        acts.data_ptr(), cs.data_ptr(), c0.data_ptr(), keep.data_ptr(), dhs.data_ptr(),
        dcs.data_ptr(), wh.data_ptr(), dxp.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
        scratch.data_ptr(), *_plan_args(B, S, H, plan, plan.smem_bwd),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"lstm_bwd kernel launch failed at B={B}, S={S}, H={H} with {plan}: CUDA error {err}")
    return dxp, dh0, dc0


_lstm_bwd_op = torch.library.custom_op(
    "tpu_rl_torch::lstm_bwd", _lstm_bwd, mutates_args=()
)


@register_flop_formula(torch.ops.tpu_rl_torch.lstm_bwd)
def _lstm_bwd_flops(wh_shape, h0_shape, c0_shape, keep_shape, hs_shape, *_shapes,
                    out_shape=None) -> int:
    B, S, H = hs_shape
    return lstm_flops(B, S, H)


def max_active_clusters(plan: LstmPlan) -> int:
    """How many clusters of ``plan``'s B1 the current card holds at once
    (``cudaOccupancyMaxActiveClusters``). Card only."""
    n = build.bind("lstm_fwd", [ctypes.c_int] * 7, entry="lstm_fwd_max_clusters")(
        plan.cluster, plan.rows, plan.tm, plan.tu, int(plan.resident), plan.threads, plan.smem_fwd
    )
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters for {plan}: CUDA error {-n}")
    return n


# ------------------------------------------------------------ autograd
class _LSTMUnroll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, wh, h0, c0, keep):
        hs, cs, acts = lstm_fwd(xp, wh, h0, c0, keep)
        ctx.save_for_backward(wh, h0, c0, keep, hs, cs, acts)
        return hs, cs

    @staticmethod
    def backward(ctx, dhs, dcs):
        # Grads are materialized (the default), so an unused output's
        # cotangent arrives as zeros, never None.
        wh, h0, c0, keep, hs, cs, acts = ctx.saved_tensors
        dxp, dh0, dc0 = lstm_bwd(
            wh, h0, c0, keep, hs, cs, acts, dhs.contiguous(), dcs.contiguous()
        )
        dwh = None
        if ctx.needs_input_grad[1]:  # a critic under the actor's loss needs no dwh
            B, S, H = hs.shape
            h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1) * keep[..., None]
            dwh = h_prev.reshape(B * S, H).t() @ dxp.reshape(B * S, 4 * H)
        return dxp, dwh, dh0, dc0, None


def lstm_unroll(xp, wh, h0, c0, keep):
    """The LSTM over a sequence: ``(hs, cs)``, each (B,S,H). Differentiable
    in xp, wh, h0 and c0 (not keep). Where no gradient is wanted (under
    ``torch.no_grad()``, or no input requires one) it is B1 alone: nothing
    is saved and no backward follows."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (xp, wh, h0, c0))):
        hs, cs, _acts = lstm_fwd(xp, wh, h0, c0, keep)
        return hs, cs
    return _LSTMUnroll.apply(xp, wh, h0, c0, keep)


# ------------------------------------------------- bf16 compute (no kernel)
class _MixedDot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, dtype):
        # residuals saved already cast, as tpu_rl's _mixed_dot_fwd saves them
        ad, bd = a.to(dtype), b.to(dtype)
        ctx.save_for_backward(ad, bd)
        return mm_f32(ad, bd)

    @staticmethod
    def backward(ctx, g):
        ad, bd = ctx.saved_tensors
        gd = g.to(ad.dtype)
        da = mm_f32(gd, bd.t()) if ctx.needs_input_grad[0] else None
        db = mm_f32(ad.t(), gd) if ctx.needs_input_grad[1] else None
        return da, db, None


def mixed_dot(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``tpu_rl.ops.pallas_lstm.mixed_dot``: ``a @ b`` with both operands
    rounded to ``dtype`` and an f32 result, in both passes: the backward
    casts the cotangent to ``dtype`` too and computes ``da = gd @ bdᵀ`` and
    ``db = adᵀ @ gd`` the same way. 2-D operands only (the backward's
    transposes assume plain matrices), as in ``tpu_rl``."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(
            "mixed_dot requires 2-D operands (its backward transposes them); "
            f"got a.ndim={a.dim()}, b.ndim={b.dim()}. Reshape to matrices before calling."
        )
    return _MixedDot.apply(a, b, dtype)


def lstm_scan(xp, wh, h0, c0, keep, matmul_dtype: torch.dtype = torch.bfloat16):
    """``tpu_rl.ops.pallas_lstm._scan_forward`` with ``matmul_dtype``: the
    mixed-precision recurrence that ``tpu_rl`` runs under bf16 compute
    instead of its f32 kernel. The recurrent product goes through
    :func:`mixed_dot`; ``xp`` (bf16 or f32) is widened to f32, and the
    gates, the carry and the outputs are f32. A plain loop over S; its
    backward is autograd through the loop. B1/B2 compute an f32 recurrent
    product, another function, so they are not used here.
    Returns ``(hs (B,S,H), (h_last, c_last))``."""
    S = xp.shape[1]
    H = wh.shape[0]
    h, c = h0, c0
    hs = []
    for t in range(S):
        kp = keep[:, t, None]
        h = h * kp
        c = c * kp
        z = xp[:, t].float() + mixed_dot(h, wh, matmul_dtype)
        i = torch.sigmoid(z[:, :H])
        f = torch.sigmoid(z[:, H : 2 * H])
        g = torch.tanh(z[:, 2 * H : 3 * H])
        o = torch.sigmoid(z[:, 3 * H :])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, 1), (h, c)
