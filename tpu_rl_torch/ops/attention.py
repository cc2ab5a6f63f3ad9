"""Causal, segment-masked flash attention (kernel B4) — the port of
``tpu_rl.parallel.sequence.flash_attention_tpu`` (JAX's Pallas TPU
flash-attention kernel called with ``SegmentIds`` and ``causal=True``).

For q, k, v (B,T,H,D) in ``tpu_rl``'s layout and segment ids seg (B,T)
int32, query row i of head h attends to every key row j <= i whose segment
id equals its own, with ``scale = 1/sqrt(D)``. :func:`flash_attn` is one
``torch.autograd.Function``: its forward launches ``csrc/flash_attn_fwd.cu``
(returns ``o`` in q's dtype and the row log-sum-exp ``lse`` (B,H,T) f32),
its backward ``csrc/flash_attn_bwd.cu`` (``dq, dk, dv`` in the input dtype).
The kernels take float32 and bfloat16, head widths :data:`HEAD_DIMS`, and
q, k, v as strided views (``qkv[:, :, 0]``) as long as the three share their
strides and each row's heads and features are dense.

On a CUDA tensor the wrappers launch the kernel or raise: there is no
fallback. The plain versions, :func:`flash_attention_forward_plain` and
:func:`flash_attention_backward_plain`, compute the same function from the
inputs upcast to float32 (the kernels' arithmetic, with no tiling); they are
taken only for tensors that lie on the CPU, and they are what the kernels
are held against.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpu_rl_torch import on_card
from tpu_rl_torch.kernels import build

# Kernel launches made through flash_fwd / flash_bwd (plain-version calls
# excluded); one per wrapper call.
FLASH_FWD_LAUNCHES = 0
FLASH_BWD_LAUNCHES = 0

# Head widths the kernels are built for (csrc/flash_attn_*.cu, launch_d).
HEAD_DIMS = (32, 64)
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


# ------------------------------------------------------------------ binding
def _entry(name: str, n_ptrs: int):
    """The kernel's C entry: ``n_ptrs`` pointers, then B, T, H, D, the
    strides sb and st, the scale, is_bf16 and the stream."""
    return build.bind(
        name,
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
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
    for name, t in (("k", k), ("v", v), ("seg", seg), *dense.items()):
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} on {t.device}, q on {q.device}")
    return B, T, H, D


# ----------------------------------------------------------------- wrappers
def flash_fwd(q, k, v, seg):
    """Kernel B4's forward: ``(o, lse)``. CPU tensors take
    :func:`flash_attention_forward_plain`; CUDA tensors launch the kernel."""
    if not on_card("flash_fwd", q):
        return flash_attention_forward_plain(q, k, v, seg)
    B, T, H, D = _check("flash_fwd", q, k, v, seg, {})
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    err = _entry("flash_attn_fwd", 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, T, H, D, q.stride(0), q.stride(1), 1.0 / math.sqrt(D), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed at {(B, T, H, D)}: CUDA error {err}")
    global FLASH_FWD_LAUNCHES
    FLASH_FWD_LAUNCHES += 1
    return o, lse


def flash_bwd(q, k, v, seg, o, lse, do):
    """Kernel B4's backward: ``(dq, dk, dv)``. CPU tensors take
    :func:`flash_attention_backward_plain`; CUDA tensors launch the three
    kernels of ``csrc/flash_attn_bwd.cu`` (delta, dk/dv, dq)."""
    if not on_card("flash_bwd", q):
        return flash_attention_backward_plain(q, k, v, seg, o, lse, do)
    B, T, H, D = _check("flash_bwd", q, k, v, seg, {"o": o, "lse": lse, "do": do})
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty((B, T, H, D), dtype=q.dtype, device=q.device) for _ in range(3))
    err = _entry("flash_attn_bwd", 11)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), o.data_ptr(), lse.data_ptr(),
        do.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, T, H, D, q.stride(0), q.stride(1), 1.0 / math.sqrt(D), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed at {(B, T, H, D)}: CUDA error {err}")
    global FLASH_BWD_LAUNCHES
    FLASH_BWD_LAUNCHES += 1
    return dq, dk, dv


# ------------------------------------------------------------ autograd
class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg):
        o, lse = flash_fwd(q, k, v, seg)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, seg, o, lse, do.contiguous())
        return dq, dk, dv, None


def flash_attn(q, k, v, seg):
    """Causal, segment-masked attention ``o`` (B,T,H,D), differentiable in
    q, k and v. ``seg`` is int32 (B,T)."""
    return _FlashAttention.apply(q, k, v, seg)
