"""The comparison that decides ``correct``: the program's first updates
against the reference's, from the same weights on the same batches. The
configuration's file says how many first updates are compared
(``check.updates``) and the limit of each number:

- ``loss_gap``: over the compared updates, the largest gap between the loss
  the program reports and the reference's, relative to the reference's
  loss scale (the sum of its weighted terms' magnitudes, which, unlike the
  loss, never passes near 0);
- ``grad_gap``: over the parameter tensors ("leaves"), the largest gap
  between the norm of the first update's gradient as the program's
  optimizer got it and the reference's, relative to the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same measure for the norm of each leaf's change over
  the compared updates, taken over the leaves the reference's first
  gradient moves: a leaf whose gradient is under a thousandth of the median
  leaf's moves under RMSprop by round-off alone, and is left out by that
  rule.

Where the first update's loss has kinks (``portbench.reference.losses``),
the reference works the updates out for every way they can fall, and the
program is judged against the way its numbers lie closest to: each way is
an exact reference, and no allowance widens any of them. A configuration
whose loss has kinks compares its first update alone (``check.updates``
1), since later updates' kinks fall as the reference puts them.

Each is a gap of norms, not the norm of a difference.
"""

from __future__ import annotations

import math
import statistics

import torch

CHECKS = ("loss_gap", "grad_gap", "change_gap")
MOVED = 1e-3  # a leaf moves if its reference gradient is at least this share of the median's


def change_norms(params: dict, params0: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm((params[k] - params0[k]).double())) for k in params}


def leaf_gap(got: dict[str, float], want: dict[str, float], leaves) -> float:
    leaves = list(leaves)
    floor = statistics.median(want[k] for k in leaves)
    return max(abs(got[k] - want[k]) / max(want[k], floor) for k in leaves)


def way_readings(losses: list[float], grads: dict[str, float], changes: dict[str, float],
                 way: dict) -> dict[str, float]:
    """The three numbers against one way of the reference's updates."""
    floor = statistics.median(way["grad_norms"].values())
    moved = [k for k, v in way["grad_norms"].items() if v >= MOVED * floor]
    return {
        "loss_gap": max(abs(a - b) / s if math.isfinite(a) else math.inf
                        for a, b, s in zip(losses, way["loss"], way["scale"])),
        "grad_gap": leaf_gap(grads, way["grad_norms"], way["grad_norms"]),
        "change_gap": leaf_gap(changes, way["change_norms"], moved),
    }


def readings(losses: list[float], grads: dict[str, float], changes: dict[str, float],
             ref: dict) -> dict[str, float]:
    """The three numbers, from the program's losses (of the compared updates
    and any after them), first-gradient norms and change norms over the
    compared updates, against the way of the reference's :func:`train`
    result that the program lies closest to (its largest number smallest)."""
    return min((way_readings(losses, grads, changes, way) for way in ref["variants"]),
               key=lambda r: max(r.values()))


def judge(values: dict[str, float], limits: dict[str, float]) -> dict[str, dict]:
    """Each number beside its limit; a number passes if it is finite and at
    most its limit."""
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}


def passed(checks: dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
