"""Learning-dynamics diagnostics, the in-step math — the port of part of
``tpu_rl.obs.learn``.

The train step returns a ``diag`` dict: per-row means of quantities the
loss already computed (``rows``, each a (B,) tensor) and per-update scalars
(per-module grad norms, update and param norms). Nothing here feeds back
into the update. The on-device accumulator bucketed by staleness
(``DiagAccumulator``), ``derive`` and ``publish`` come with the
observability slice of the port.
"""

from __future__ import annotations

import torch

from tpu_rl_torch.ops.losses import global_norm


def rows_mean(x: torch.Tensor) -> torch.Tensor:
    """Per-row mean over all non-batch axes: (R, ...) -> (R,)."""
    return torch.mean(x.reshape(x.shape[0], -1), dim=1)


def module_grad_norms(grads: dict) -> dict[str, torch.Tensor]:
    """Global grad norm split by module group over ``{group: {name: grad}}``
    (names are state_dict keys): ``torso`` (a path part containing "body"),
    ``cell`` (the recurrent core), ``heads`` (everything else). The first
    path part that decides wins, as in ``tpu_rl``'s walk of the flax path."""
    parts: dict[str, list[torch.Tensor]] = {"torso": [], "cell": [], "heads": []}
    for group, tree in grads.items():
        for name, leaf in tree.items():
            kind = "heads"
            for part in (group, *name.split(".")):
                if "body" in part:
                    kind = "torso"
                    break
                if part == "cell":
                    kind = "cell"
                    break
            parts[kind].append(leaf.float())
    # A group with no leaves (the transformer has no torso or cell) is 0.
    device = next(t.device for ts in parts.values() for t in ts)
    return {
        k: global_norm(ts) if ts else torch.zeros((), device=device) for k, ts in parts.items()
    }


def tree_delta_norm(new: dict, old: dict) -> torch.Tensor:
    """Global norm of ``new - old`` over ``{group: {name: tensor}}`` (the
    applied update's magnitude; exactly 0 when a guard skipped it)."""
    return global_norm(
        new[g][n].float() - old[g][n].float() for g in new for n in new[g]
    )


def tree_norm(tree: dict) -> torch.Tensor:
    return global_norm(t for group in tree.values() for t in group.values())
