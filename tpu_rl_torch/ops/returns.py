"""Return / advantage estimators — the port of ``tpu_rl.ops.returns``.

``vtrace`` comes with the IMPALA slice of the port.
"""

from __future__ import annotations

import torch


def gae(deltas: torch.Tensor, gamma: float, lmbda: float) -> torch.Tensor:
    """Generalized advantage estimation over the time axis (axis 1).

    ``deltas``: (B, T, ...) TD errors. Returns (B, T, ...) advantages with
    ``adv[t] = delta[t] + gamma * lmbda * adv[t+1]``; no done-masking inside
    the recursion (the masking is in the deltas), as in the reference.
    """
    advs = [None] * deltas.shape[1]
    adv = torch.zeros_like(deltas[:, 0])
    for t in reversed(range(deltas.shape[1])):
        adv = deltas[:, t] + gamma * lmbda * adv
        advs[t] = adv
    return torch.stack(advs, dim=1)
