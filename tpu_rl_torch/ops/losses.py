"""Loss primitives — the port of ``tpu_rl.ops.losses``."""

from __future__ import annotations

import torch

from tpu_rl_torch.utils.tree import tree_leaves, tree_map


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber) loss, mean-reduced."""
    diff = torch.abs(pred - target)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return torch.mean(loss)


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor, as a 0-d tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


def clip_subtree_by_global_norm(grads: dict, max_norm: float, subtree: str | None = None):
    """Clip a gradient tree (nested dicts of tensors) by its global norm:
    ``scale = min(1, max_norm / (norm + 1e-6))``; with ``subtree``, only
    ``grads[subtree]`` is measured and clipped and the other entries pass
    through (V-MPO clips the ``actor`` and not its Lagrange duals). Returns
    ``(clipped grads, norm)``; the norm is the one before clipping. Stays on
    the device: no host read."""
    tree = grads if subtree is None else grads[subtree]
    gnorm = global_norm(tree_leaves(tree))
    scale = torch.minimum(torch.ones_like(gnorm), max_norm / (gnorm + 1e-6))
    clipped = tree_map(lambda g: g * scale, tree)
    if subtree is None:
        return clipped, gnorm
    return {**grads, subtree: clipped}, gnorm
