"""Return / advantage estimators — the port of ``tpu_rl.ops.returns``:
GAE (PPO, V-MPO) and V-trace (IMPALA)."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=8)
def _discount_matrix(T: int, c: float, device: torch.device) -> torch.Tensor:
    """(T, T) float64 ``w[t, k] = c**(k - t)`` for ``k >= t``, else 0."""
    idx = torch.arange(T, device=device)
    lag = idx[None, :] - idx[:, None]
    w = torch.pow(torch.tensor(c, dtype=torch.float64, device=device), lag.clamp(min=0).double())
    return torch.where(lag >= 0, w, 0.0)


def gae(deltas: torch.Tensor, gamma: float, lmbda: float) -> torch.Tensor:
    """Generalized advantage estimation over the time axis (axis 1).

    ``deltas``: (B, T, ...) TD errors. Returns (B, T, ...) advantages with
    ``adv[t] = delta[t] + gamma * lmbda * adv[t+1]``; no done-masking inside
    the recursion (the masking is in the deltas), as in the reference.

    ``tpu_rl`` runs the recursion as a ``lax.scan``. Here it is its closed
    form, ``adv[t] = sum_{k>=t} (gamma*lmbda)**(k-t) * delta[k]``, one
    product with a cached (T, T) upper-triangular matrix: three launches
    instead of T dependent steps of host-issued ops (6,000 at T=2048). The
    product runs in float64 and is rounded once, so it is closer to the
    exact sums than the f32 scan (on the CPU at (16, 2047): 4.8e-7 against
    the scan's 3.6e-6).
    """
    T = deltas.shape[1]
    w = _discount_matrix(T, float(gamma * lmbda), deltas.device)
    return torch.einsum("tk,bk...->bt...", w, deltas.double()).to(deltas.dtype)


def vtrace(
    behav_log_probs: torch.Tensor,
    target_log_probs: torch.Tensor,
    is_fir: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    gamma: float,
    rho_bar: float = 0.8,
    rho_min: float = 0.1,
    c_bar: float = 1.0,
    v_min: float | None = None,
    v_max: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """V-trace off-policy corrections (IMPALA), ``tpu_rl``'s recursion.

    All inputs are (B, S, 1); time is axis 1. Returns
    ``(rho_clipped (B,S-1,1), advantages (B,S-1,1), values_target (B,S,1))``:

        rho   = clip(exp(target_lp - behav_lp), rho_min, rho_bar)
        c     = min(exp(target_lp - behav_lp), c_bar)
        delta[t] = rho[t] * (r[t] + g*(1-fir[t+1])*V[t+1] - V[t])
        dv[t] = delta[t] + c[t] * g*(1-fir[t+1]) * dv[t+1],  dv[S-1] = 0
        vs    = V + dv
        adv[t] = rho[t] * (r[t] + g*(1-fir[t+1])*vs[t+1] - V[t])

    ``v_min``/``v_max`` (None = no clamp) clamp the values entering the
    recursion and the targets it returns. The coefficients ``c[t]·disc[t]``
    change per step, so :func:`gae`'s product with one constant matrix does
    not carry over: the recursion is a reverse loop of S-1 (B, 1) steps.
    """
    clamp = v_min is not None or v_max is not None
    if clamp:
        values = torch.clamp(values, v_min, v_max)
    ratio = torch.exp(target_log_probs[:, :-1] - behav_log_probs[:, :-1])
    rho_clipped = torch.clamp(ratio, rho_min, rho_bar)
    disc = gamma * (1.0 - is_fir[:, 1:])
    c_disc = torch.clamp(ratio, max=c_bar) * disc

    td_target = rewards[:, :-1] + disc * values[:, 1:]
    deltas = rho_clipped * (td_target - values[:, :-1])

    T = deltas.shape[1]
    dv = [torch.zeros_like(deltas[:, 0])]  # dv[S-1] = 0
    for t in range(T - 1, -1, -1):
        dv.append(deltas[:, t] + c_disc[:, t] * dv[-1])
    values_target = values + torch.stack(dv[::-1], dim=1)
    if clamp:
        values_target = torch.clamp(values_target, v_min, v_max)

    advantages = rho_clipped * (rewards[:, :-1] + disc * values_target[:, 1:] - values[:, :-1])
    return rho_clipped, advantages, values_target
