"""V-MPO train step — the port of ``tpu_rl.algos.vmpo``.

- GAE advantages (no grad), then the top half of the batch per time step
  (:func:`top_half_mask`);
- softmax weights psi over the selected advantages / eta, and the weighted
  maximum-likelihood policy loss;
- the temperature dual ``eta*coef_eta + eta*(logsumexp - log N)``, with N
  the number of entries the mask actually selected;
- the KL Lagrange loss against a KL bound drawn log-uniform in
  ``[coef_alpha_below, coef_alpha_upper]`` once per epoch;
- one RMSprop over the actor and the duals ``log_eta``/``log_alpha``, the
  global-norm clip on the actor only, and the floor ``log_eta >= log 1e-6``
  projected inside the guard's apply branch.
"""

from __future__ import annotations

import math

import torch

from tpu_rl_torch.algos.base import Params, TrainState, make_on_policy_step
from tpu_rl_torch.algos.ppo import policy_outputs, td_target_and_gae
from tpu_rl_torch.config import Config
from tpu_rl_torch.obs.learn import rows_mean
from tpu_rl_torch.ops.distributions import categorical_kl
from tpu_rl_torch.ops.losses import smooth_l1
from tpu_rl_torch.parallel.mesh import NO_SYNC
from tpu_rl_torch.types import Batch

def top_half_mask(adv: torch.Tensor, k: int) -> torch.Tensor:
    """0/1 mask over the batch axis of ``adv`` (B, T, 1) selecting each time
    step's top-``k`` advantages: the k-th largest value by one sort, then a
    compare. Where entries tie at that value all of them are kept (more
    than k), as ``tpu_rl`` keeps them; the temperature dual counts the mask,
    so the extra entries do not bias eta."""
    kth_largest = -torch.sort(-adv, dim=0).values[k - 1]  # (T, 1)
    return (adv >= kth_largest).to(adv.dtype)


def log_uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """A draw log-uniform in [lo, hi] from its unit uniform ``u`` in [0, 1),
    in ``tpu_rl``'s f32 arithmetic: ``exp(max(a, u * (b - a) + a))`` with
    ``a, b = log lo, log hi``."""
    a = torch.tensor(math.log(lo), dtype=torch.float32, device=u.device)
    b = torch.tensor(math.log(hi), dtype=torch.float32, device=u.device)
    return torch.exp(torch.maximum(a, u * (b - a) + a))


def make_train_step(cfg: Config, family, sync=NO_SYNC):
    """``train_step(state, batch, generator=None, coef_alpha_u=None) ->
    (state, metrics)``. ``coef_alpha_u`` holds one unit uniform per epoch,
    the draw behind that epoch's KL bound; without it the draws come from
    ``generator``.

    Under data parallelism (``sync`` a mesh) the top-half selection, the
    softmax normaliser and the selected count are the global batch's: the
    advantages are all-gathered over the data group before the sort, and
    this rank's policy term, a sum over its entries of the global softmax,
    is scaled by the data-axis size so that the ranks' mean is the global
    sum."""

    def loss_fn(params, batch: Batch, coef_alpha_u: torch.Tensor):
        log_probs, entropy, value, logits = policy_outputs(family, params, batch)
        td_target, advantage = td_target_and_gae(cfg, batch, value)

        eta = torch.exp(params["duals"]["log_eta"])
        alpha = torch.exp(params["duals"]["log_alpha"])

        adv_all = sync.gather_rows(advantage)  # the global batch's
        k = math.ceil(adv_all.shape[0] / 2)
        mask_all = top_half_mask(adv_all, k)
        ratio_all = adv_all / (eta.detach() + 1e-7)

        # psi: softmax over the selected (b, t) entries, by a masked
        # logsumexp; unselected entries weigh 0.
        lse = torch.logsumexp(torch.where(mask_all > 0, ratio_all, -math.inf).reshape(-1), dim=0)
        rows = sync.rows(advantage.shape[0])
        mask, ratio = mask_all[rows], ratio_all[rows]
        psi = mask * torch.exp(ratio - lse)
        loss_policy = -torch.sum(psi * torch.where(mask > 0, log_probs[:, :-1], 0.0)) * sync.n_data

        loss_value = smooth_l1(value[:, :-1], td_target)

        n_selected = torch.sum(mask_all).detach()
        loss_temperature = eta * cfg.coef_eta + eta * (lse - torch.log(n_selected))

        coef_alpha = log_uniform(coef_alpha_u, cfg.coef_alpha_below, cfg.coef_alpha_upper)
        kl = categorical_kl(batch.logits[:, :-1], logits[:, :-1])
        loss_alpha = torch.mean(alpha * (coef_alpha - kl.detach()) + alpha.detach() * kl)

        loss = (
            cfg.policy_loss_coef * loss_policy
            + cfg.value_loss_coef * loss_value
            + loss_temperature
            + loss_alpha
        )
        metrics = {
            "loss": loss,
            "policy-loss": loss_policy,
            "value-loss": loss_value,
            "loss-temperature": loss_temperature,
            "loss-alpha": loss_alpha,
            "eta": eta,
            "vmpo-alpha": alpha,
            "kl": torch.mean(kl),
        }
        if cfg.learn_diag:
            # Action-level k1 approx-KL and importance weights against the
            # behaviour policy (the full-distribution KL above feeds the
            # dual).
            lr = (log_probs[:, :-1] - batch.log_prob[:, :-1]).detach()
            w = torch.exp(lr)
            err = td_target - value[:, :-1].detach()
            metrics["diag"] = {
                "rows": {
                    "ent": rows_mean(entropy[:, :-1].detach()),
                    "kl": rows_mean(-lr),
                    "w": rows_mean(w),
                    "w2": rows_mean(torch.square(w)),
                    "adv": rows_mean(advantage),
                    "adv2": rows_mean(torch.square(advantage)),
                    "ret": rows_mean(td_target),
                    "ret2": rows_mean(torch.square(td_target)),
                    "err": rows_mean(err),
                    "err2": rows_mean(torch.square(err)),
                },
                "scalars": {"eta": eta.detach(), "vmpo-alpha": alpha.detach()},
            }
        return loss, metrics

    def project(params: Params) -> Params:
        # eta -> 0 makes psi one-hot and the ratios unbounded: a floor,
        # projected after the step (a clip inside the loss would zero the
        # dual's gradient below it).
        duals = params["duals"]
        floor = torch.log(torch.full_like(duals["log_eta"], 1e-6))
        return {**params, "duals": {**duals, "log_eta": torch.maximum(duals["log_eta"], floor)}}

    step = make_on_policy_step(cfg, loss_fn, clip_subtree="actor", project=project, sync=sync)

    def train_step(
        state: TrainState,
        batch: Batch,
        generator: torch.Generator | None = None,
        coef_alpha_u: torch.Tensor | None = None,
    ):
        if coef_alpha_u is None:
            coef_alpha_u = torch.rand(
                (cfg.K_epoch,), generator=generator, device=batch.obs.device
            )
        return step(state, batch, [(coef_alpha_u[e],) for e in range(cfg.K_epoch)])

    train_step.sync = sync
    return train_step
