"""PPO (discrete and continuous) train step — the port of ``tpu_rl.algos.ppo``.

The clipped-surrogate update with GAE advantages masked by
``(1 - is_fir[:, 1:])``, a smooth-L1 value loss against a no-grad TD
target, an entropy bonus, a global-norm gradient clip and RMSprop;
``K_epoch`` epochs per step. PPO-Continuous takes per-dimension Gaussian
log-probs, so its ratio, clip and diag rows broadcast over the action
dimensions. The whole step stays on the device: metrics come back as 0-d
tensors, and the update guard selects with ``torch.where``.
"""

from __future__ import annotations

import torch

from tpu_rl_torch.algos.base import TrainState, make_on_policy_step
from tpu_rl_torch.config import Config
from tpu_rl_torch.obs.learn import rows_mean
from tpu_rl_torch.ops import distributions as D
from tpu_rl_torch.ops.losses import smooth_l1
from tpu_rl_torch.parallel.mesh import NO_SYNC
from tpu_rl_torch.ops.returns import gae
from tpu_rl_torch.types import Batch


def policy_outputs(family, params, batch: Batch):
    """Shared-torso forward of the on-policy families. Returns (log_probs
    (B,S,1), or per dimension (B,S,A) for a Gaussian policy; entropy
    (B,S,1); value (B,S,1); logits (B,S,A), zeros for a Gaussian policy)."""
    carry0 = (batch.hx[:, 0], batch.cx[:, 0])
    if family.continuous:
        mu, std, value, _ = family.actor_unroll(params["actor"], batch.obs, carry0, batch.is_fir)
        log_probs = D.normal_log_prob(mu, std, batch.act)
        entropy = torch.mean(D.normal_entropy(std), dim=-1, keepdim=True)
        return log_probs, entropy, value, torch.zeros_like(mu)
    logits, value, _ = family.actor_unroll(params["actor"], batch.obs, carry0, batch.is_fir)
    log_probs = D.categorical_log_prob(logits, batch.act[..., 0])[..., None]
    entropy = D.categorical_entropy(logits)[..., None]
    return log_probs, entropy, value, logits


def td_target_and_gae(cfg: Config, batch: Batch, value: torch.Tensor):
    """No-grad TD target and GAE advantages."""
    v = value.detach()
    td_target = batch.rew[:, :-1] + cfg.gamma * (1.0 - batch.is_fir[:, 1:]) * v[:, 1:]
    delta = td_target - v[:, :-1]
    return td_target, gae(delta, cfg.gamma, cfg.lmbda)


def make_train_step(cfg: Config, family, sync=NO_SYNC):
    """``train_step(state, batch, generator=None) -> (state, metrics)``; PPO
    draws nothing, so ``generator`` is unused."""

    def loss_fn(params, batch: Batch):
        log_probs, entropy, value, _ = policy_outputs(family, params, batch)
        td_target, advantage = td_target_and_gae(cfg, batch, value)

        ratio = torch.exp(log_probs[:, :-1] - batch.log_prob[:, :-1])
        surr1 = ratio * advantage
        surr2 = torch.clamp(ratio, 1.0 - cfg.eps_clip, 1.0 + cfg.eps_clip) * advantage
        loss_policy = -torch.mean(torch.minimum(surr1, surr2))
        loss_value = smooth_l1(value[:, :-1], td_target)
        policy_entropy = torch.mean(entropy[:, :-1])

        loss = (
            cfg.policy_loss_coef * loss_policy
            + cfg.value_loss_coef * loss_value
            - cfg.entropy_coef * policy_entropy
        )
        metrics = {
            "loss": loss,
            "policy-loss": loss_policy,
            "value-loss": loss_value,
            "policy-entropy": policy_entropy,
            "min-ratio": torch.min(ratio),
            "max-ratio": torch.max(ratio),
            "avg-ratio": torch.mean(ratio),
        }
        if cfg.learn_diag:
            # Per-row means of quantities the loss already computed, all
            # detached: they never feed back into the update.
            lr = (log_probs[:, :-1] - batch.log_prob[:, :-1]).detach()
            w = torch.exp(lr)
            ent = entropy[:, :-1].detach()
            err = td_target - value[:, :-1].detach()
            metrics["diag"] = {
                "rows": {
                    "ent": rows_mean(ent),
                    # k1 approx-KL estimator: E[logp_behav - logp_new]
                    "kl": rows_mean(-lr),
                    "clip": rows_mean((torch.abs(w - 1.0) > cfg.eps_clip).float()),
                    "w": rows_mean(w),
                    "w2": rows_mean(torch.square(w)),
                    "adv": rows_mean(advantage),
                    "adv2": rows_mean(torch.square(advantage)),
                    "ret": rows_mean(td_target),
                    "ret2": rows_mean(torch.square(td_target)),
                    "err": rows_mean(err),
                    "err2": rows_mean(torch.square(err)),
                },
                "scalars": {},
            }
        return loss, metrics

    step = make_on_policy_step(cfg, loss_fn, sync=sync)

    def train_step(state: TrainState, batch: Batch, generator: torch.Generator | None = None):
        return step(state, batch)

    train_step.sync = sync
    return train_step
