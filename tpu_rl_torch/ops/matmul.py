"""The mixed-precision product shared by the bf16 paths: ``mixed_dot``'s
(:mod:`tpu_rl_torch.ops.lstm`) and blockwise attention's tile products
(:mod:`tpu_rl_torch.parallel.sequence`)."""

from __future__ import annotations

import torch


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over (..., m, k) x (..., k, n) with an f32 result that, for
    bf16 operands, is not rounded to bf16 (``preferred_element_type=
    jnp.float32``). On the card that is cuBLAS's bf16 product with an f32
    output; on the CPU, which has no such product, the operands are widened
    first: the products of two bf16 numbers are exact in f32, so that is the
    same function up to the order of the f32 sums. f32 operands: the plain
    product."""
    if a.dtype != torch.bfloat16:
        return torch.matmul(a, b)
    if a.device.type != "cuda":
        return a.float() @ b.float()
    if a.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    lead, m, n = a.shape[:-2], a.shape[-2], b.shape[-1]
    out = torch.bmm(a.reshape(-1, m, a.shape[-1]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(*lead, m, n)
