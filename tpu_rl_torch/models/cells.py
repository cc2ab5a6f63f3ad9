"""Recurrent cells — the port of ``tpu_rl.models.cells.LSTMCell``.

Parameters keep flax's layout so weights bridge one to one: ``x_proj`` is an
``nn.Linear(in, 4H)`` with bias (flax ``Dense``, transposed by the bridge)
and ``recurrent_kernel`` an ``(H, 4H)`` parameter used as ``h @ kernel``.
Gates are i, f, g, o. ``torch.nn.LSTMCell`` is not used: it has two biases
and another weight layout. ``forward`` is one step (the act path),
``unroll`` the whole sequence (the training path, through the LSTM kernels
of :mod:`tpu_rl_torch.ops.lstm`).

``dtype=torch.bfloat16`` is ``tpu_rl``'s mixed precision
(``LSTMCell.dtype``): parameters stay f32, ``x_proj`` is a bf16 Dense whose
output is widened to f32, the recurrent product goes through
:func:`~tpu_rl_torch.ops.lstm.mixed_dot`, and the unroll is the
mixed-precision scan :func:`~tpu_rl_torch.ops.lstm.lstm_scan` (never
B1/B2, which compute an f32 product: ``tpu_rl/models/cells.py:179-185``).
Gates, carry and outputs stay f32. tpu_rl's bf16 products accumulate in
f32; cuBLAS does so only with
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
False``, so building a bf16 cell sets that process-wide flag.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpu_rl_torch.ops.lstm import lstm_scan, lstm_unroll, mixed_dot

Carry = tuple[torch.Tensor, torch.Tensor]

# Standard deviation of a unit normal truncated to [-2, 2]; flax's
# lecun_normal divides by it so the truncated draw keeps variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(
    t: torch.Tensor, fan_in: int, generator: torch.Generator | None = None
) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal with variance ``1/fan_in``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_dense_(layer: nn.Linear, generator: torch.Generator | None = None) -> None:
    """flax ``Dense`` init: lecun_normal kernel, zero bias."""
    lecun_normal_(layer.weight, layer.in_features, generator)
    with torch.no_grad():
        layer.bias.zero_()


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """flax ``Dense``: with a compute dtype, input, kernel and bias are cast
    to it (the product's output is rounded to it before the bias add);
    without one, an f32 ``x @ Wᵀ + b``."""
    if dtype is None:
        return F.linear(x.float(), layer.weight, layer.bias)
    return torch.matmul(x.to(dtype), layer.weight.to(dtype).t()) + layer.bias.to(dtype)


def reduce_bf16_in_f32(dtype: torch.dtype | None) -> None:
    """Make cuBLAS sum bf16 products in f32, as tpu_rl's do (process-wide;
    a no-op for other dtypes)."""
    if dtype == torch.bfloat16:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def lstm_gates(z: torch.Tensor, c: torch.Tensor) -> Carry:
    """``z`` (B, 4H) pre-activations in gate order i, f, g, o ->
    ``(h', c')`` with ``c' = σ(f)·c + σ(i)·tanh(g)``, ``h' = σ(o)·tanh(c')``."""
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return h2, c2


class LSTMCell(nn.Module):
    def __init__(self, in_features: int, hidden: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        reduce_bf16_in_f32(dtype)
        self.x_proj = nn.Linear(in_features, 4 * hidden)
        self.recurrent_kernel = nn.Parameter(torch.empty(hidden, 4 * hidden))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_dense_(self.x_proj, generator)
        lecun_normal_(self.recurrent_kernel, self.hidden, generator)

    def forward(self, carry: Carry, x: torch.Tensor) -> tuple[Carry, torch.Tensor]:
        h, c = carry
        if self.dtype is None:
            z = self.x_proj(x) + h @ self.recurrent_kernel
        else:
            z = dense(self.x_proj, x, self.dtype).float() + mixed_dot(
                h, self.recurrent_kernel, self.dtype
            )
        h2, c2 = lstm_gates(z, c)
        return (h2, c2), h2

    def unroll(
        self, x: torch.Tensor, carry0: Carry, firsts: torch.Tensor, reset_on_first: bool
    ) -> tuple[Carry, torch.Tensor]:
        """x (B, S, in), carry0 ((B,H),(B,H)), firsts (B, S, 1) ->
        (final carry, hs (B, S, H)). The input projection of every step is
        one product; the carry is zeroed before the steps ``firsts`` flags
        when ``reset_on_first``."""
        B, S = x.shape[0], x.shape[1]
        keep = (
            1.0 - firsts[..., 0]
            if reset_on_first
            else torch.ones((B, S), dtype=torch.float32, device=x.device)
        )
        if self.dtype is not None:
            xp = dense(self.x_proj, x, self.dtype)
            hs, last = lstm_scan(xp, self.recurrent_kernel, carry0[0], carry0[1], keep, self.dtype)
            return last, hs
        xp = self.x_proj(x)
        hs, cs = lstm_unroll(
            xp.contiguous(), self.recurrent_kernel.contiguous(),
            carry0[0].contiguous(), carry0[1].contiguous(), keep.contiguous(),
        )
        return (hs[:, -1], cs[:, -1]), hs
