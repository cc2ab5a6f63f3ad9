"""SAC train steps, discrete and continuous — the port of ``tpu_rl.algos.sac``.

Per epoch, three updates in order, each behind its own guard: the actor
(Adam), the temperature ``log_alpha`` (its own Adam, ``alpha_lr``, floor
``alpha_min``), then the twin critic (Adam) against soft TD targets from the
separate target critic, with the Polyak target update inside the critic's
apply branch (a skipped critic step leaves the target too). The continuous
variant reparameterizes through the tanh-squashed Gaussian, sampling twice
per epoch: the actor loss's actions and the TD target's.

LSTM unroll launches per epoch (B1 forward / B2 backward), which
``chip_smoke.py`` asserts: discrete 8 / 3 (actor with grad 1/1, q1 and q2
under the actor loss with no grad 2/0, actor for the target 1/0, target q1
and q2 2/0, q1 and q2 with grad 2/2); continuous 8 / 5 (the actor loss's q1
and q2 carry the action's gradient, 2/2).
"""

from __future__ import annotations

import torch

from tpu_rl_torch.algos.base import Adam, SACState
from tpu_rl_torch.config import Config
from tpu_rl_torch.heal.guards import guarded, update_ok
from tpu_rl_torch.obs.learn import module_grad_norms, rows_mean, tree_delta_norm, tree_norm
from tpu_rl_torch.ops.distributions import normal_log_prob, tanh_normal_sample
from tpu_rl_torch.ops.losses import clip_subtree_by_global_norm, smooth_l1
from tpu_rl_torch.ops.target import polyak_update
from tpu_rl_torch.parallel.mesh import NO_SYNC
from tpu_rl_torch.types import Batch
from tpu_rl_torch.utils.tree import value_and_grad


def target_entropy_for(cfg: Config, continuous: bool) -> float:
    """The temperature's target entropy: ``+action_space`` under
    ``sac_reference_alpha`` (the reference's rule), else
    ``cfg.target_entropy`` when set, else ``-dim(A)`` for a tanh-Gaussian and
    ``0.98·log|A|`` for a categorical policy."""
    if cfg.sac_reference_alpha:
        return float(cfg.action_space)
    if cfg.target_entropy is not None:
        return float(cfg.target_entropy)
    if continuous:
        return -float(cfg.action_space)
    return 0.98 * float(torch.log(torch.tensor(float(cfg.action_space))))


def make_train_step(cfg: Config, family, sync=NO_SYNC):
    """``train_step(state, batch, generator=None, noise=None) -> (state,
    metrics)``. For SAC-Continuous ``noise`` holds one pair of unit-normal
    (B,S,A) draws per epoch, the actor loss's and the TD target's; without
    it they come from ``generator``. Discrete SAC draws nothing.

    ``sync`` is the collective hook (the identity by default): each of the
    three updates takes the mean of its grads over the ranks, its loss
    riding along for the guard, before its clip; drawn noise has the global
    batch's shape and this rank takes its rows, so a data-parallel run
    draws what the single-device run draws."""
    opt_actor, opt_critic = Adam(cfg.lr), Adam(cfg.lr)
    opt_alpha = Adam(cfg.lr if cfg.alpha_lr is None else cfg.alpha_lr)
    continuous = family.continuous
    target_entropy = target_entropy_for(cfg, continuous)
    # The reference's alpha loss is +alpha*(logpi + target), whose feedback
    # runs backwards; the default minimizes -alpha*(logpi + target).
    ref_sign = 1.0 if cfg.sac_reference_alpha else -1.0
    guard = cfg.update_guard

    def critic_apply(cp, batch: Batch, act, carry0):
        if continuous:
            return family.critic_unroll(cp, batch.obs, act, carry0, batch.is_fir)
        return family.critic_unroll(cp, batch.obs, carry0, batch.is_fir)

    def one_epoch(state: SACState, batch: Batch, n_pol, n_cri):
        carry0 = (batch.hx[:, 0], batch.cx[:, 0])
        fir = batch.is_fir
        alpha_d = torch.exp(state.log_alpha).detach()

        # ---- 1) actor
        def actor_loss(ap):
            if continuous:
                mu, log_std = family.actor_unroll(ap, batch.obs, carry0, fir)
                a_pol, logp = tanh_normal_sample(mu, torch.exp(log_std), noise=n_pol)
                q1, q2 = critic_apply(state.critic_params, batch, a_pol, carry0)
                min_q = torch.minimum(q1, q2)
                # total log-prob over the action dims, so the entropy the
                # policy feels and the -dim(A) target agree
                logp_tot = torch.sum(logp, dim=-1, keepdim=True)
                loss_policy = torch.mean((alpha_d * logp_tot - min_q)[:, :-1])
                ent_neg = logp_tot[:, :-1, 0]
            else:
                probs, logp = family.actor_unroll(ap, batch.obs, carry0, fir)
                with torch.no_grad():  # no gradient reaches the critic here
                    q1, q2 = critic_apply(state.critic_params, batch, None, carry0)
                min_q = torch.minimum(q1, q2)
                loss_policy = torch.mean(
                    torch.sum((probs * (alpha_d * logp - min_q))[:, :-1], dim=-1)
                )
                ent_neg = torch.sum((probs * logp)[:, :-1], dim=-1)
            return loss_policy, ent_neg.detach()

        loss_policy, ent_neg, g_actor = value_and_grad(actor_loss, state.actor_params)
        g_actor, loss_policy = sync.grads(g_actor, loss_policy)
        g_actor, gn_actor = clip_subtree_by_global_norm(g_actor, cfg.max_grad_norm)

        def apply_actor():
            return opt_actor.apply(g_actor, state.actor_opt, state.actor_params)

        if guard:
            ok_a = update_ok(loss_policy, gn_actor)
            actor_params, actor_opt = guarded(
                ok_a, apply_actor, (state.actor_params, state.actor_opt)
            )
        else:
            actor_params, actor_opt = apply_actor()

        # ---- 2) temperature
        def alpha_loss(log_alpha):
            loss = ref_sign * torch.mean(torch.exp(log_alpha) * (ent_neg + target_entropy))
            return loss, None

        loss_alpha, _, g_alpha = value_and_grad(alpha_loss, state.log_alpha)
        g_alpha, loss_alpha = sync.grads(g_alpha, loss_alpha)

        def apply_alpha():
            la, alpha_opt = opt_alpha.apply(g_alpha, state.alpha_opt, state.log_alpha)
            if cfg.alpha_min > 0.0:
                # exploration floor: the controller may raise alpha freely
                la = torch.maximum(la, torch.log(torch.full_like(la, cfg.alpha_min)))
            return la, alpha_opt

        if guard:
            ok_al = torch.isfinite(loss_alpha)
            log_alpha, alpha_opt = guarded(
                ok_al, apply_alpha, (state.log_alpha, state.alpha_opt)
            )
        else:
            log_alpha, alpha_opt = apply_alpha()

        # ---- 3) critic, against the updated actor and temperature
        alpha2 = torch.exp(log_alpha).detach()
        with torch.no_grad():
            if continuous:
                mu, log_std = family.actor_unroll(actor_params, batch.obs, carry0, fir)
                a_cri, logp_cri = tanh_normal_sample(mu, torch.exp(log_std), noise=n_cri)
                tq1, tq2 = critic_apply(state.target_critic_params, batch, a_cri, carry0)
                soft_q = torch.minimum(tq1, tq2) - alpha2 * torch.sum(
                    logp_cri, dim=-1, keepdim=True
                )
            else:
                probs_cri, logp_cri = family.actor_unroll(actor_params, batch.obs, carry0, fir)
                tq1, tq2 = critic_apply(state.target_critic_params, batch, None, carry0)
                soft_q = probs_cri * (torch.minimum(tq1, tq2) - alpha2 * logp_cri)
            td_target = batch.rew[:, :-1] + (1.0 - fir[:, 1:]) * cfg.gamma * torch.sum(
                soft_q[:, 1:], dim=-1, keepdim=True
            )

        def critic_loss(cp):
            if continuous:
                q1, q2 = critic_apply(cp, batch, batch.act, carry0)
            else:
                q1, q2 = critic_apply(cp, batch, None, carry0)
                a_idx = batch.act.long()
                q1 = torch.gather(q1, -1, a_idx)
                q2 = torch.gather(q2, -1, a_idx)
            return smooth_l1(q1[:, :-1], td_target) + smooth_l1(q2[:, :-1], td_target), None

        loss_value, _, g_critic = value_and_grad(critic_loss, state.critic_params)
        g_critic, loss_value = sync.grads(g_critic, loss_value)
        g_critic, gn_critic = clip_subtree_by_global_norm(g_critic, cfg.max_grad_norm)

        def apply_critic():
            cp, critic_opt = opt_critic.apply(g_critic, state.critic_opt, state.critic_params)
            # Polyak tracks only applied critic steps.
            return cp, critic_opt, polyak_update(cp, state.target_critic_params, cfg.tau)

        if guard:
            ok_c = update_ok(loss_value, gn_critic)
            critic_params, critic_opt, target_critic_params = guarded(
                ok_c, apply_critic,
                (state.critic_params, state.critic_opt, state.target_critic_params),
            )
        else:
            critic_params, critic_opt, target_critic_params = apply_critic()

        metrics = {
            "loss": cfg.policy_loss_coef * loss_policy + cfg.value_loss_coef * loss_value,
            "policy-loss": loss_policy,
            "value-loss": loss_value,
            "loss_alpha": loss_alpha,
            "alpha": torch.exp(log_alpha),
        }
        if cfg.learn_diag:
            # Off-policy staleness: the current actor's log-prob of the
            # replayed action against the stored behaviour log-prob, and the
            # soft TD target's moments; from the critic section's forward.
            if continuous:
                pre = torch.atanh(torch.clamp(batch.act, -1.0 + 1e-6, 1.0 - 1e-6))
                logp_act = normal_log_prob(mu, torch.exp(log_std), pre) - torch.log(
                    1.0 - torch.square(batch.act) + 1e-7
                )
                lr = torch.sum(logp_act - batch.log_prob, dim=-1)[:, :-1]
            else:
                logp_new = torch.gather(logp_cri, -1, batch.act.long())
                lr = (logp_new - batch.log_prob)[:, :-1, 0]
            w = torch.exp(lr)
            metrics["diag"] = {
                "rows": {
                    "ent": rows_mean(-ent_neg),
                    "kl": rows_mean(-lr),
                    "w": rows_mean(w),
                    "w2": rows_mean(torch.square(w)),
                    "tq": rows_mean(td_target),
                    "tq2": rows_mean(torch.square(td_target)),
                },
                "scalars": {
                    "alpha": torch.exp(log_alpha),
                    **{
                        f"grad-norm-{k}": v
                        for k, v in module_grad_norms(
                            {"actor": g_actor, "critic": g_critic}
                        ).items()
                    },
                },
            }
        if guard:
            metrics["grad-norm"] = gn_actor + gn_critic
            metrics["nonfinite-updates"] = 1.0 - (ok_a & ok_al & ok_c).float()
        return (
            state.replace(
                actor_params=actor_params,
                critic_params=critic_params,
                target_critic_params=target_critic_params,
                log_alpha=log_alpha,
                actor_opt=actor_opt,
                critic_opt=critic_opt,
                alpha_opt=alpha_opt,
            ),
            metrics,
        )

    def trained(state: SACState) -> dict:
        return {
            "actor": state.actor_params,
            "critic": state.critic_params,
            "alpha": {"log_alpha": state.log_alpha},
        }

    def train_step(
        state: SACState,
        batch: Batch,
        generator: torch.Generator | None = None,
        noise=None,
    ):
        if continuous and noise is None:
            n_local = batch.obs.shape[0]
            shape = (n_local * sync.n_data, batch.obs.shape[1], family.n_actions)
            rows = sync.rows(n_local)
            noise = [
                tuple(torch.randn(shape, generator=generator, device=batch.obs.device)[rows]
                      for _ in range(2))
                for _ in range(cfg.K_epoch)
            ]
        params0 = trained(state)
        metrics: dict = {}
        nf = None
        for e in range(cfg.K_epoch):
            n_pol, n_cri = noise[e] if continuous else (None, None)
            state, metrics = one_epoch(state, batch, n_pol, n_cri)
            if guard:
                skipped = metrics.pop("nonfinite-updates")
                nf = skipped if nf is None else nf + skipped
        if guard:
            metrics["nonfinite-updates"] = nf
        if cfg.learn_diag:
            params1 = trained(state)
            metrics["diag"]["scalars"]["update-norm"] = tree_delta_norm(params1, params0)
            metrics["diag"]["scalars"]["param-norm"] = tree_norm(params1)
        return state.replace(step=state.step + 1), metrics

    train_step.sync = sync
    return train_step
