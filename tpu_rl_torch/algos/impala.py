"""IMPALA (V-trace actor-critic) train step — the port of
``tpu_rl.algos.impala``.

V-trace targets and advantages computed with no grad (rho in [rho_min,
rho_bar], c clipped at c_bar, optional ``value_target_clip``), the
policy-gradient loss ``-(log_probs * advantages)``, a smooth-L1 value loss
to the V-trace targets and an entropy bonus; the update loop is
:func:`~tpu_rl_torch.algos.base.make_on_policy_step`'s.
"""

from __future__ import annotations

import torch

from tpu_rl_torch.algos.base import TrainState, make_on_policy_step
from tpu_rl_torch.algos.ppo import policy_outputs
from tpu_rl_torch.config import Config
from tpu_rl_torch.obs.learn import rows_mean
from tpu_rl_torch.ops.losses import smooth_l1
from tpu_rl_torch.parallel.mesh import NO_SYNC
from tpu_rl_torch.ops.returns import vtrace
from tpu_rl_torch.types import Batch


def make_train_step(cfg: Config, family, sync=NO_SYNC):
    """``train_step(state, batch, generator=None) -> (state, metrics)``;
    IMPALA draws nothing, so ``generator`` is unused."""
    v_lo, v_hi = cfg.value_target_clip or (None, None)

    def loss_fn(params, batch: Batch):
        log_probs, entropy, value, logits = policy_outputs(family, params, batch)
        ratio, advantages, values_target = vtrace(
            behav_log_probs=batch.log_prob,
            target_log_probs=log_probs.detach(),
            is_fir=batch.is_fir,
            rewards=batch.rew,
            values=value.detach(),
            gamma=cfg.gamma,
            rho_bar=cfg.rho_bar,
            rho_min=cfg.rho_min,
            c_bar=cfg.c_bar,
            v_min=v_lo,
            v_max=v_hi,
        )

        loss_policy = -torch.mean(log_probs[:, :-1] * advantages)
        loss_value = smooth_l1(value[:, :-1], values_target[:, :-1])
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
            # Saturation: whether a collapse is advantage-driven or a logit
            # runaway.
            "max-abs-logit": torch.max(torch.abs(logits)),
            "mean-value": torch.mean(value),
            "max-abs-advantage": torch.max(torch.abs(advantages)),
            "mean-advantage": torch.mean(advantages),
        }
        if cfg.learn_diag:
            # The UNCLIPPED importance ratio drives the KL and clip-rate
            # rows: vtrace's clipped rho would hide the tail they measure.
            lr = (log_probs[:, :-1] - batch.log_prob[:, :-1]).detach()
            w = torch.exp(lr)
            vt = values_target[:, :-1]
            err = vt - value[:, :-1].detach()
            metrics["diag"] = {
                "rows": {
                    "ent": rows_mean(entropy[:, :-1].detach()),
                    "kl": rows_mean(-lr),
                    "rho-clip": rows_mean((w >= cfg.rho_bar).float()),
                    "c-clip": rows_mean((w >= cfg.c_bar).float()),
                    "w": rows_mean(w),
                    "w2": rows_mean(torch.square(w)),
                    "adv": rows_mean(advantages),
                    "adv2": rows_mean(torch.square(advantages)),
                    "ret": rows_mean(vt),
                    "ret2": rows_mean(torch.square(vt)),
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
