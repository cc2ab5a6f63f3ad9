"""The algorithms' losses, written out plainly: PPO's clipped objective on
GAE advantages and IMPALA's V-trace actor-critic, each with a smooth-L1
value loss and an entropy bonus. Returns and advantages are worked out in
float64 by their recursions, step by step backwards in time.

Each loss is a mean over the rows' first S-1 steps, so a batch's loss is the
row-weighted mean of the losses of its blocks of rows (:mod:`.step` relies
on it). Each returns the loss; its scale, the sum of its weighted terms'
magnitudes (the loss can pass near 0 where its terms do not, and a gap
measured against the scale does not blow up there); and its kinks.

A kink is a term at which the loss's gradient jumps: PPO's clipped
surrogate where a ratio sits at a clip edge on the side where the clip
binds. Another float32 computation of the same step may put a ratio that
lies within ``KINK`` of an edge on the other side, and then that term's
gradient is in its sum or not. So the reference returns, for each such
term, what the loss gains if the term falls on the other side: its
unclipped contribution where the reference clipped it, and that
contribution taken away where the reference did not. :mod:`.step` works
out the update for every way the kinks can fall (``portbench.check``).
"""

from __future__ import annotations

import torch

KINK = 1e-5  # relative distance from a clip edge within which a ratio may lie on either side


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()


def _entropy(logp: torch.Tensor) -> torch.Tensor:
    return -(logp.exp() * logp).sum(-1)


def _combine(cfg: dict, policy, value, entropy):
    terms = (cfg["policy_loss_coef"] * policy, cfg["value_loss_coef"] * value,
             -cfg["entropy_coef"] * entropy)
    return sum(terms), sum(t.detach().abs() for t in terms)


def _no_kinks(like: torch.Tensor) -> torch.Tensor:
    return like.new_zeros((0,))


def ppo(logp_all, value, batch: dict, cfg: dict) -> torch.Tensor:
    """The PPO loss of rows whose policy gives ``logp_all`` (B,S,A) and
    ``value`` (B,S). The TD target bootstraps from the next step's value
    unless an episode starts there; the advantages are GAE of the TD errors
    with no masking inside the recursion."""
    gamma, lam = cfg["gamma"], cfg["lmbda"]
    act, fir = batch["act"], batch["is_fir"]
    logp = logp_all.gather(-1, act[..., None]).squeeze(-1)
    v = value.detach().double()
    target = batch["rew"][:, :-1].double() + gamma * (1.0 - fir[:, 1:].double()) * v[:, 1:]
    delta = target - v[:, :-1]
    adv = torch.zeros_like(delta)
    run = torch.zeros_like(delta[:, 0])
    for t in range(delta.shape[1] - 1, -1, -1):
        run = delta[:, t] + gamma * lam * run
        adv[:, t] = run
    adv, target = adv.float(), target.float()
    ratio = torch.exp(logp[:, :-1] - batch["log_prob"][:, :-1])
    lo, hi = 1.0 - cfg["eps_clip"], 1.0 + cfg["eps_clip"]
    surrogate = torch.minimum(ratio * adv, ratio.clamp(lo, hi) * adv)
    near = ((adv > 0) & ((ratio - hi).abs() <= KINK * hi)) | (
        (adv < 0) & ((ratio - lo).abs() <= KINK * lo))
    # where the unclipped term is in the sum (the clip passes its gradient at the edge)
    unclipped = ((adv > 0) & (ratio <= hi)) | ((adv < 0) & (ratio >= lo))
    term = -cfg["policy_loss_coef"] * ratio * adv / ratio.numel()
    kinks = torch.where(unclipped, -term, term)[near]
    return (*_combine(cfg, -surrogate.mean(), smooth_l1(value[:, :-1], target),
                      _entropy(logp_all[:, :-1]).mean()), kinks)


def impala(logp_all, value, batch: dict, cfg: dict) -> torch.Tensor:
    """The IMPALA loss: V-trace targets and policy-gradient advantages from
    the detached log-probs and values, truncated importance weights
    rho = clip(w, rho_min, rho_bar) and c = min(w, c_bar)."""
    gamma = cfg["gamma"]
    act, fir = batch["act"], batch["is_fir"]
    logp = logp_all.gather(-1, act[..., None]).squeeze(-1)
    w = torch.exp(logp.detach()[:, :-1] - batch["log_prob"][:, :-1]).double()
    rho = w.clamp(cfg["rho_min"], cfg["rho_bar"])
    c = w.clamp(max=cfg["c_bar"])
    v = value.detach().double()
    disc = gamma * (1.0 - fir[:, 1:].double())
    r = batch["rew"][:, :-1].double()
    S = v.shape[1]
    vs = v.clone()
    acc = torch.zeros_like(v[:, 0])
    for t in range(S - 2, -1, -1):
        acc = rho[:, t] * (r[:, t] + disc[:, t] * v[:, t + 1] - v[:, t]) + c[:, t] * disc[:, t] * acc
        vs[:, t] = v[:, t] + acc
    adv = (rho * (r + disc * vs[:, 1:] - v[:, :-1])).float()
    return (*_combine(cfg, -(logp[:, :-1] * adv).mean(),
                      smooth_l1(value[:, :-1], vs[:, :-1].float()),
                      _entropy(logp_all[:, :-1]).mean()), _no_kinks(value))


LOSSES = {"PPO": ppo, "IMPALA": impala}
