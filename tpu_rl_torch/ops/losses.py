"""Loss primitives — the port of ``tpu_rl.ops.losses``."""

from __future__ import annotations

import torch


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber) loss, mean-reduced."""
    diff = torch.abs(pred - target)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return torch.mean(loss)


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor, as a 0-d tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


def clip_subtree_by_global_norm(grads: dict, max_norm: float):
    """Clip ``{group: {name: grad}}`` by its global norm:
    ``scale = min(1, max_norm / (norm + 1e-6))``. Returns
    ``(clipped grads, norm)``; the norm is the one before clipping. Stays on
    the device: no host read. (``tpu_rl``'s ``subtree`` argument, which
    V-MPO uses, comes with that algorithm.)"""
    gnorm = global_norm(g for group in grads.values() for g in group.values())
    scale = torch.minimum(torch.ones_like(gnorm), max_norm / (gnorm + 1e-6))
    return {k: {n: g * scale for n, g in group.items()} for k, group in grads.items()}, gnorm
