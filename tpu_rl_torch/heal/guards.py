"""Non-finite update guards — the port of ``tpu_rl.heal.guards``.

Both helpers stay on the device, so a guarded train step adds no host sync:

- guard on, clean step -> the update computed exactly as unguarded;
- guard on, non-finite loss or global grad-norm -> the *incoming* params
  and optimizer state come back untouched, and the step's
  ``nonfinite-updates`` metric counts one skipped update.
"""

from __future__ import annotations

from typing import Any

import torch


def update_ok(loss: torch.Tensor, gnorm: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor: this update's loss and global grad-norm are finite."""
    return torch.isfinite(loss) & torch.isfinite(gnorm)


def guarded(ok: torch.Tensor, apply_fn, fallback: Any) -> Any:
    """``apply_fn()`` where ``ok`` else ``fallback``, leaf by leaf with
    ``torch.where`` (``lax.cond``'s counterpart without a host read).
    ``fallback`` and ``apply_fn()`` are nested dicts/tuples of tensors of one
    structure. ``apply_fn`` always runs; its result is discarded where
    ``ok`` is false."""
    return _select(ok, apply_fn(), fallback)


def _select(ok: torch.Tensor, new: Any, old: Any) -> Any:
    if isinstance(old, dict):
        return {k: _select(ok, new[k], old[k]) for k in old}
    if isinstance(old, (tuple, list)):
        return type(old)(_select(ok, n, o) for n, o in zip(new, old, strict=True))
    return torch.where(ok, new, old)
