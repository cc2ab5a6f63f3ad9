"""Matrix products of the reference, in float32 or in TF32.

``precision="float32"`` is the reference itself: every product in float32
(the caller turns TF32 off on the card). ``precision="tf32"`` is its
control, the same arithmetic one precision below: both operands of every
product, forward and backward, rounded to TF32 (10 mantissa bits, to
nearest) and the products summed in float32, as a TF32 tensor core does.
The rounding is done here, not by a backend flag, so the control is the
same on the CPU and on the card.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float32", "tf32")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, held in float32."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32).view(x.shape)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a, b = to_tf32(a), to_tf32(b)
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return torch.matmul(g, b.transpose(-1, -2)), torch.matmul(a.transpose(-1, -2), g)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` over (..., m, k) x (..., k, n) with equal leading dims."""
    if precision == "float32":
        return torch.matmul(a, b)
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    raise ValueError(f"precision {precision!r}, want one of {PRECISIONS}")


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, precision: str):
    """``x @ wᵀ + b`` over x's last axis, for a weight stored (out, in)."""
    y = matmul(x.reshape(-1, x.shape[-1]), w.t(), precision).reshape(*x.shape[:-1], w.shape[0])
    return y if b is None else y + b
