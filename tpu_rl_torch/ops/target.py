"""Target-network updates — the port of ``tpu_rl.ops.target``."""

from __future__ import annotations

from tpu_rl_torch.utils.tree import tree_map


def polyak_update(source_params, target_params, tau: float = 0.005):
    """Soft (Polyak) target update, ``t <- (1 - tau) * t + tau * s``, leaf by
    leaf over two trees of one structure. Returns a new tree: the target is
    a tree of its own, never an alias of the source, so the update moves it
    (``tpu_rl`` fixes the same aliasing of its reference)."""
    return tree_map(lambda s, t: (1.0 - tau) * t + tau * s, source_params, target_params)
