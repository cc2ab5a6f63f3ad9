"""Causal, segment-masked flash attention (kernel B4) — the port of
``tpu_rl.parallel.sequence.flash_attention_tpu`` (JAX's Pallas TPU
flash-attention kernel called with ``SegmentIds`` and ``causal=True``).

For q, k, v (B,T,H,D) in ``tpu_rl``'s layout and segment ids seg (B,T)
int32, query row i of head h attends to every key row j <= i whose segment
id equals its own, with ``scale = 1/sqrt(D)``. :func:`flash_attn` is one
``torch.autograd.Function`` over :func:`flash_fwd` (``o`` in q's dtype and
the row log-sum-exp ``lse`` (B,H,T) f32) and :func:`flash_bwd` (``dq, dk,
dv`` in the input dtype). Each dispatches by dtype, and neither ever takes
the other's kernel:

- bfloat16: the tensor-core kernels ``csrc/flash_attn_tc_fwd.cu`` and
  ``csrc/flash_attn_tc_bwd.cu`` (``mma.sync`` bf16 with f32 accumulation,
  P and dS fed as hi/lo bf16 pairs);
- float32, ``tpu_rl``'s default compute type: the tensor-core kernels
  ``csrc/flash_attn_f32_fwd.cu`` and ``csrc/flash_attn_f32_bwd.cu``
  (``mma.sync`` TF32 in split precision, 3xTF32: every operand as a
  TF32 hi and its remainder lo, three products for each; one TF32 product
  would miss the f32 bar).

Both pairs skip every (query tile, key tile) pair whose segment ids cannot
meet: :func:`tile_plan` gives them each 64-row tile's segment-id range and
the launch order, and :func:`visited_tiles` is their skip rule. While spans
are on (:mod:`tpu_rl_torch.obs.trace`) the forward counts the score elements
its plan visits (:func:`count_visits`).

The kernels take head widths :data:`HEAD_DIMS` and q, k, v as strided
views (``qkv[:, :, 0]``) as long as the three share their strides and each
row's heads and features are dense; they copy 16-byte pieces, so their
rows must start on 16 bytes.

Both kernel entries are ``torch.library.custom_op`` operators
(``tpu_rl_torch::flash_fwd``, ``tpu_rl_torch::flash_bwd``; the tile plan
rides as a list of tensors) with FLOP formulas registered for
``torch.utils.flop_counter`` (:func:`attn_flops`): the plain versions' full
T×T score and value products, so that the tiles the kernels skip show as
speed, not as less work. The wrappers enter the operators only while a
dispatch mode is active (:func:`tpu_rl_torch.counted`); otherwise they call
the operators' functions directly and pay no dispatcher.

On a CUDA tensor the wrappers launch a kernel or raise: there is no
fallback. The plain versions, :func:`flash_attention_forward_plain` and
:func:`flash_attention_backward_plain`, compute the same function from the
inputs upcast to float32 (no tiling, P and dS unrounded); they are taken
only for tensors that lie on the CPU, and they are what the kernels are
held against.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from tpu_rl_torch import counted, on_card
from tpu_rl_torch.kernels import build
from tpu_rl_torch.obs import trace

# Kernel launches made through flash_fwd / flash_bwd (plain-version calls
# excluded); one per wrapper call.
FLASH_FWD_LAUNCHES = 0
FLASH_BWD_LAUNCHES = 0

# Head widths the kernels are built for (csrc/flash_attn_*.cu, their C entries).
HEAD_DIMS = (32, 64)
# Rows of the kernels' query and key tiles (csrc/flash_attn_tc.cuh, kTile; the
# f32 kernels take the same, csrc/flash_attn_f32.cuh).
TILE = 64
# The device counter (obs.trace) of the score elements B4's forward visits
# while spans are on: visited tile pairs x TILE^2 x heads (count_visits).
VISITED = "b4.visited_score_elements"
# The kernels' C entries by input dtype: csrc/<name>_{fwd,bwd}.cu.
_KERNELS = {torch.bfloat16: "flash_attn_tc", torch.float32: "flash_attn_f32"}
_NEG_INF = -1e30  # tpu_rl's finite -inf stand-in
# Score elements the plain versions hold at once (1 GiB of f32): larger
# batches go through in chunks of rows.
_PLAIN_CHUNK = 2**28


# ------------------------------------------------------------ plain versions
def _visible(seg: torch.Tensor) -> torch.Tensor:
    """(B,1,T,T) bool: query i sees key j iff j <= i and seg[j] == seg[i]."""
    T = seg.shape[1]
    idx = torch.arange(T, device=seg.device)
    causal = idx[None, :] <= idx[:, None]
    return (causal[None] & (seg[:, :, None] == seg[:, None, :]))[:, None]


def _chunks(B: int, H: int, T: int):
    rows = max(1, _PLAIN_CHUNK // max(1, H * T * T))
    return [slice(b0, min(B, b0 + rows)) for b0 in range(0, B, rows)]


def flash_attention_forward_plain(q, k, v, seg):
    """``(o, lse)``: o (B,T,H,D) in q's dtype, lse (B,H,T) float32."""
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    outs, lses = [], []
    for sl in _chunks(B, H, T):
        qf, kf, vf = (x[sl].float() for x in (q, k, v))
        mask = _visible(seg[sl])
        s = torch.where(mask, torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale, _NEG_INF)
        lse = torch.logsumexp(s, dim=-1)
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype))
        lses.append(lse)
    return torch.cat(outs), torch.cat(lses)


def flash_attention_backward_plain(q, k, v, seg, o, lse, do):
    """``(dq, dk, dv)`` in the input dtype, from the forward's ``o`` and
    ``lse`` and the output cotangent ``do``."""
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    grads = ([], [], [])
    for sl in _chunks(B, H, T):
        qf, kf, vf, of, dof = (x[sl].float() for x in (q, k, v, o, do))
        delta = (dof * of).sum(-1).transpose(1, 2)  # (b,H,T)
        mask = _visible(seg[sl])
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        p = torch.where(mask, torch.exp(s - lse[sl][..., None]), 0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
        ds = p * (dp - delta[..., None]) * scale
        grads[0].append(torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype))
        grads[1].append(torch.einsum("bhqk,bqhd->bkhd", ds, qf).to(k.dtype))
        grads[2].append(torch.einsum("bhqk,bqhd->bkhd", p, dof).to(v.dtype))
    return tuple(torch.cat(g) for g in grads)


# ------------------------------------------------------------ tile skipping
def tile_ranges(seg: torch.Tensor, tile: int = TILE) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, ceil(T/tile)) int32 minimum and maximum segment id of each tile
    of ``tile`` rows; the rows of the last tile past T repeat the last id."""
    B, T = seg.shape
    n = -(-T // tile)
    rows = seg if n * tile == T else torch.cat([seg, seg[:, -1:].expand(B, n * tile - T)], 1)
    lo, hi = torch.aminmax(rows.reshape(B, n, tile), dim=-1)
    return lo.to(torch.int32), hi.to(torch.int32)


def visited_tiles(q_range, k_range, q_tile: int = TILE, k_tile: int = TILE) -> torch.Tensor:
    """(B, n_q, n_k) bool: the kernels' skip rule. Query tile i and key
    tile j (``q_range``/``k_range`` as :func:`tile_ranges` gives them) are
    visited iff the pair is causal (the key tile starts at or before the
    query tile's last row) and their segment-id ranges overlap. No pair
    outside it holds a (query, key) element that the mask keeps, for any
    int32 ids; for the monotone ids of ``segment_ids_from_firsts`` it is
    tight. The kernels' ``next_meeting`` and ``interior`` apply it at 64 rows."""
    (qmin, qmax), (kmin, kmax) = q_range, k_range
    qi = torch.arange(qmin.shape[1], device=qmin.device)
    kj = torch.arange(kmin.shape[1], device=kmin.device)
    causal = kj[None, :] * k_tile <= qi[:, None] * q_tile + q_tile - 1
    meet = (kmin[:, None, :] <= qmax[:, :, None]) & (qmin[:, :, None] <= kmax[:, None, :])
    return causal[None] & meet


class TilePlan(NamedTuple):
    """What the kernels read besides the tensors: each 64-row tile's
    segment-id range, and the launch order of the query tiles (forward, dq)
    and of the key tiles (dk/dv), the ones that visit the most tiles first
    (flattened ``b * n_tiles + tile``)."""

    tile_min: torch.Tensor  # (B, n_tiles) int32
    tile_max: torch.Tensor
    order_q: torch.Tensor  # (B * n_tiles,) int32
    order_k: torch.Tensor


def tile_plan(seg: torch.Tensor) -> TilePlan:
    """The :class:`TilePlan` of segment ids ``seg`` (B,T) int32, on seg's
    device: a few small reductions and one sort, made once per forward and
    kept for the backward."""
    lo, hi = tile_ranges(seg)
    visits = visited_tiles((lo, hi), (lo, hi))
    counts = torch.stack([visits.sum(2, dtype=torch.int32).flatten(),
                          visits.sum(1, dtype=torch.int32).flatten()])
    order = torch.argsort(counts, dim=1, descending=True, stable=True).to(torch.int32)
    return TilePlan(lo, hi, order[0], order[1])


def count_visits(plan: TilePlan, heads: int) -> None:
    """Add to the device counter :data:`VISITED` the score elements a
    forward under ``plan`` visits, on ``heads`` heads: the tile pairs of
    the kernels' skip rule (:func:`visited_tiles`) times ``TILE**2`` times
    ``heads``, on the plan's device (no host read). The backward visits the
    same tiles and is not counted again."""
    ranges = (plan.tile_min, plan.tile_max)
    trace.add_count(VISITED, visited_tiles(ranges, ranges).sum() * (TILE * TILE * heads))


# ------------------------------------------------------------------ binding
def _entry(name: str, n_ptrs: int):
    """The kernel's C entry: ``n_ptrs`` pointers, then B, T, H, D, the
    strides sb and st, the scale and the stream."""
    return build.bind(
        name,
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
        + [ctypes.c_float, ctypes.c_void_p],
    )


def _check(fn: str, q, k, v, seg, dense: dict) -> tuple[int, int, int, int]:
    """Device, dtype, shape and layout of the kernel's inputs; returns
    (B, T, H, D)."""
    if q.dim() != 4:
        raise ValueError(f"{fn}: q has shape {tuple(q.shape)}, want (B, T, H, D)")
    B, T, H, D = q.shape
    if min(B, T, H) < 1 or D not in HEAD_DIMS:
        raise ValueError(f"{fn}: shape {tuple(q.shape)}; the kernel is built for D in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{fn}: q is {q.dtype}, the kernel takes float32 or bfloat16")
    for name, t in (("k", k), ("v", v), *dense.items()):
        if t.dtype != (torch.float32 if name == "lse" else q.dtype):
            raise TypeError(f"{fn}: {name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.stride() != q.stride():
            raise ValueError(
                f"{fn}: {name} has shape {tuple(t.shape)} and strides {t.stride()}, q has "
                f"{tuple(q.shape)} and {q.stride()}; the kernel takes one set of strides"
            )
    if q.stride(3) != 1 or q.stride(2) != D or min(q.stride(0), q.stride(1)) < 1:
        raise ValueError(f"{fn}: q's strides {q.stride()} leave its heads and features not dense")
    if seg.dtype != torch.int32 or tuple(seg.shape) != (B, T) or not seg.is_contiguous():
        raise ValueError(
            f"{fn}: seg must be contiguous int32 (B, T), got {seg.dtype} {tuple(seg.shape)}"
        )
    for name, t in dense.items():
        want = (B, H, T) if name == "lse" else (B, T, H, D)
        if tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous {want}, got {tuple(t.shape)}")
    # the kernels copy rows in 16-byte pieces (cp.async)
    per16 = 16 // q.element_size()
    if q.stride(0) % per16 or q.stride(1) % per16:
        raise ValueError(
            f"{fn}: {q.dtype} q/k/v strides {q.stride()}: the batch and time strides must be "
            f"multiples of {per16} elements (16 bytes)"
        )
    for name, t in (("q", q), ("k", k), ("v", v), *dense.items()):
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {q.dtype} {name} does not start on a 16-byte boundary")
    for name, t in (("k", k), ("v", v), ("seg", seg), *dense.items()):
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} on {t.device}, q on {q.device}")
    return B, T, H, D


def _check_plan(fn: str, plan: TilePlan, seg) -> None:
    n = -(-seg.shape[1] // TILE)
    for name, t, want in (("tile_min", plan.tile_min, (seg.shape[0], n)),
                          ("tile_max", plan.tile_max, (seg.shape[0], n)),
                          ("order_q", plan.order_q, (seg.shape[0] * n,)),
                          ("order_k", plan.order_k, (seg.shape[0] * n,))):
        if t.dtype != torch.int32 or tuple(t.shape) != want or not t.is_contiguous() \
                or t.device != seg.device:
            raise ValueError(f"{fn}: plan.{name} must be contiguous int32 {want} on {seg.device}")


def _stream(q) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


# ----------------------------------------------------------------- wrappers
def attn_flops(B: int, T: int, H: int, D: int, backward: bool = False) -> int:
    """FLOPs of B4's forward, the plain version's two T×T products (the
    scores and P·V), 4·B·H·T²·D; or of its backward, the plain version's
    five (the scores again, dP, dQ, dK and dV), 10·B·H·T²·D."""
    return (10 if backward else 4) * B * H * T * T * D


def flash_fwd(q, k, v, seg, plan: TilePlan | None = None):
    """Kernel B4's forward: ``(o, lse)``. CPU tensors take
    :func:`flash_attention_forward_plain`; CUDA tensors launch the bf16 or
    the f32 tensor-core kernel (with ``plan``, or :func:`tile_plan` of
    ``seg``). Under a FLOP counter it runs as the operator
    ``tpu_rl_torch::flash_fwd``; a tensor on another device is refused
    first."""
    on_card("flash_fwd", q)
    return (_flash_fwd_op if counted() else _flash_fwd)(q, k, v, seg, list(plan or ()))


def _flash_fwd(q: Tensor, k: Tensor, v: Tensor, seg: Tensor, plan: list[Tensor]
                  ) -> tuple[Tensor, Tensor]:
    plan = TilePlan(*plan) if plan else None
    if not on_card("flash_fwd", q):
        return flash_attention_forward_plain(q, k, v, seg)
    B, T, H, D = _check("flash_fwd", q, k, v, seg, {})
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    plan = tile_plan(seg) if plan is None else plan
    _check_plan("flash_fwd", plan, seg)
    if trace.spans_on():
        count_visits(plan, H)
    name = f"{_KERNELS[q.dtype]}_fwd"
    err = _entry(name, 9)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), plan.tile_min.data_ptr(),
        plan.tile_max.data_ptr(), plan.order_q.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, T, H, D, q.stride(0), q.stride(1), 1.0 / math.sqrt(D), _stream(q),
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed at {(B, T, H, D)}: CUDA error {err}")
    global FLASH_FWD_LAUNCHES
    FLASH_FWD_LAUNCHES += 1
    return o, lse


_flash_fwd_op = torch.library.custom_op("tpu_rl_torch::flash_fwd", _flash_fwd, mutates_args=())


@register_flop_formula(torch.ops.tpu_rl_torch.flash_fwd)
def _flash_fwd_flops(q_shape, *_shapes, out_shape=None) -> int:
    return attn_flops(*q_shape)


def flash_bwd(q, k, v, seg, o, lse, do, plan: TilePlan | None = None):
    """Kernel B4's backward: ``(dq, dk, dv)``. CPU tensors take
    :func:`flash_attention_backward_plain`; CUDA tensors launch the three
    kernels (delta, dk/dv, dq) of ``csrc/flash_attn_tc_bwd.cu`` for bf16 or
    of ``csrc/flash_attn_f32_bwd.cu`` for f32 (with ``plan``, or
    :func:`tile_plan` of ``seg``). Under a FLOP counter it runs as the
    operator ``tpu_rl_torch::flash_bwd``; a tensor on another device is
    refused first."""
    on_card("flash_bwd", q)
    args = (q, k, v, seg, o, lse, do, list(plan or ()))
    return (_flash_bwd_op if counted() else _flash_bwd)(*args)


def _flash_bwd(q: Tensor, k: Tensor, v: Tensor, seg: Tensor, o: Tensor, lse: Tensor,
                  do: Tensor, plan: list[Tensor]) -> tuple[Tensor, Tensor, Tensor]:
    plan = TilePlan(*plan) if plan else None
    if not on_card("flash_bwd", q):
        return flash_attention_backward_plain(q, k, v, seg, o, lse, do)
    B, T, H, D = _check("flash_bwd", q, k, v, seg, {"o": o, "lse": lse, "do": do})
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty((B, T, H, D), dtype=q.dtype, device=q.device) for _ in range(3))
    plan = tile_plan(seg) if plan is None else plan
    _check_plan("flash_bwd", plan, seg)
    name = f"{_KERNELS[q.dtype]}_bwd"
    err = _entry(name, 15)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), plan.tile_min.data_ptr(),
        plan.tile_max.data_ptr(), plan.order_q.data_ptr(), plan.order_k.data_ptr(),
        o.data_ptr(), lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, H, D, q.stride(0), q.stride(1),
        1.0 / math.sqrt(D), _stream(q),
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed at {(B, T, H, D)}: CUDA error {err}")
    global FLASH_BWD_LAUNCHES
    FLASH_BWD_LAUNCHES += 1
    return dq, dk, dv


_flash_bwd_op = torch.library.custom_op("tpu_rl_torch::flash_bwd", _flash_bwd, mutates_args=())


@register_flop_formula(torch.ops.tpu_rl_torch.flash_bwd)
def _flash_bwd_flops(q_shape, *_shapes, out_shape=None) -> int:
    return attn_flops(*q_shape, backward=True)


# ------------------------------------------------------------ autograd
class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg):
        # the kernels' tile plan, made once and kept for the backward
        plan = tile_plan(seg) if q.is_cuda else None
        o, lse = flash_fwd(q, k, v, seg, plan)
        ctx.save_for_backward(q, k, v, seg, o, lse, *(plan or ()))
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse, *plan = ctx.saved_tensors
        plan = TilePlan(*plan) if plan else None
        dq, dk, dv = flash_bwd(q, k, v, seg, o, lse, do.contiguous(), plan)
        return dq, dk, dv, None


def flash_attn(q, k, v, seg):
    """Causal, segment-masked attention ``o`` (B,T,H,D), differentiable in
    q, k and v. ``seg`` is int32 (B,T)."""
    return _FlashAttention.apply(q, k, v, seg)
