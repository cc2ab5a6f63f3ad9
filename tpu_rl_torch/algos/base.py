"""Train states, optimizers and the on-policy update loop — the port of
``tpu_rl.algos.base``.

The optimizers are functional (RMSprop and Adam over a parameter tree, not
``torch.optim``): the train step computes the new params and state as
tensors, and the update guard then picks the new or the old ones with
``torch.where`` on the device, with no host read.

Parameter trees are nested dicts of tensors. The on-policy algorithms keep
``{"actor": state_dict}``; V-MPO adds ``{"duals": {"log_eta", "log_alpha"}}``,
its two 0-d Lagrange multipliers (``tpu_rl`` keeps them at the top of its
tree; every helper counts them as it does: clipped never, ``heads`` in the
per-module grad norms, in the update and param norms).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch

from tpu_rl_torch.config import Config
from tpu_rl_torch.heal.guards import guarded, update_ok
from tpu_rl_torch.obs.learn import module_grad_norms, tree_delta_norm, tree_norm
from tpu_rl_torch.obs.trace import span
from tpu_rl_torch.ops.losses import clip_subtree_by_global_norm
from tpu_rl_torch.parallel.mesh import NO_SYNC
from tpu_rl_torch.utils.tree import tree_leaves, tree_map, value_and_grad

Params = dict[str, dict[str, torch.Tensor]]


@dataclass
class TrainState:
    """State of the single-optimizer on-policy algorithms (PPO, IMPALA,
    V-MPO): the update count ``step`` (0-d int32 tensor), ``params``
    (``{"actor": state_dict}``, plus V-MPO's ``"duals"``) and ``opt_state``
    ``{"nu": ...}`` with one leaf per parameter (optax's
    ``ScaleByRmsState.nu``, leaf for leaf)."""

    step: torch.Tensor
    params: Params
    opt_state: dict[str, Any]

    def replace(self, **kw: Any) -> "TrainState":
        return dataclasses.replace(self, **kw)


@dataclass
class SACState:
    """State of the SAC algorithms: actor, twin critic and a separate target
    critic (state_dicts; the critics' keys start ``q1.``/``q2.``), the 0-d
    ``log_alpha`` and one Adam state each (``{"mu", "nu", "count"}``)."""

    step: torch.Tensor
    actor_params: dict[str, torch.Tensor]
    critic_params: dict[str, torch.Tensor]
    target_critic_params: dict[str, torch.Tensor]
    log_alpha: torch.Tensor
    actor_opt: dict[str, Any]
    critic_opt: dict[str, Any]
    alpha_opt: dict[str, Any]

    def replace(self, **kw: Any) -> "SACState":
        return dataclasses.replace(self, **kw)


class RMSprop:
    """RMSprop with torch's semantics (``RMSprop(lr, eps=1e-5)``, alpha
    0.99, epsilon outside the square root) as ``tpu_rl`` configures optax:

        nu = (1 - decay) * g^2 + decay * nu        (nu starts at 0)
        p  = p + (g / (sqrt(nu) + eps)) * -lr
    """

    decay = 0.99
    eps = 1e-5

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params) -> dict[str, Any]:
        return {"nu": tree_map(torch.zeros_like, params)}

    def apply(self, grads, opt_state: dict[str, Any], params):
        """-> (new params, new opt_state); the inputs are not modified."""
        d, eps, lr = self.decay, self.eps, self.lr
        nu = tree_map(lambda g, v: (1.0 - d) * torch.square(g) + d * v, grads, opt_state["nu"])
        new = tree_map(lambda p, g, v: p + (g / (torch.sqrt(v) + eps)) * -lr, params, grads, nu)
        return new, {"nu": nu}


class Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 outside the square
    root, bias correction from the optimizer's own update count:

        mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g^2 + b2 * nu
        count += 1
        p  = p + (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count)) + eps) * -lr
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params) -> dict[str, Any]:
        leaf = tree_leaves(params)[0]
        return {
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device),
        }

    def apply(self, grads, opt_state: dict[str, Any], params):
        """-> (new params, new opt_state); the inputs are not modified."""
        b1, b2, eps, lr = self.b1, self.b2, self.eps, self.lr
        mu = tree_map(lambda g, m: (1.0 - b1) * g + b1 * m, grads, opt_state["mu"])
        nu = tree_map(lambda g, v: (1.0 - b2) * torch.square(g) + b2 * v, grads, opt_state["nu"])
        count = opt_state["count"] + 1
        n = count.float()
        c1 = 1.0 - torch.pow(torch.full_like(n, b1), n)
        c2 = 1.0 - torch.pow(torch.full_like(n, b2), n)
        new = tree_map(
            lambda p, m, v: p + ((m / c1) / (torch.sqrt(v / c2) + eps)) * -lr, params, mu, nu
        )
        return new, {"mu": mu, "nu": nu, "count": count}


def rmsprop(cfg: Config) -> RMSprop:
    return RMSprop(cfg.lr)


def make_train_state(cfg: Config, family, generator: torch.Generator | None = None):
    """The initial state of ``cfg.algo``: the family's init drawn from
    ``generator`` (a CPU generator), on the family's device. SAC gets a
    :class:`SACState` with a target critic copied from the critic and
    ``log_alpha = log(cfg.alpha)``; V-MPO's duals start at
    ``log(v_mpo_lagrange_multiplier_init)``, two separate tensors."""
    params = family.init_params(generator)
    step = torch.zeros((), dtype=torch.int32, device=family.device)
    f32 = dict(dtype=torch.float32, device=family.device)
    if family.separate:
        log_alpha = torch.log(torch.tensor(cfg.alpha, **f32))
        return SACState(
            step=step,
            actor_params=params["actor"],
            critic_params=params["critic"],
            target_critic_params=tree_map(torch.clone, params["critic"]),
            log_alpha=log_alpha,
            actor_opt=Adam(cfg.lr).init(params["actor"]),
            critic_opt=Adam(cfg.lr).init(params["critic"]),
            alpha_opt=Adam(cfg.lr).init(log_alpha),
        )
    if cfg.algo == "V-MPO":
        init = torch.log(torch.tensor(cfg.v_mpo_lagrange_multiplier_init, **f32))
        params = {**params, "duals": {"log_eta": init.clone(), "log_alpha": init.clone()}}
    return TrainState(step=step, params=params, opt_state=rmsprop(cfg).init(params))


def make_on_policy_step(
    cfg: Config,
    loss_fn: Callable,
    clip_subtree: str | None = None,
    project: Callable[[Params], Params] | None = None,
    sync=NO_SYNC,
):
    """The update loop PPO, IMPALA and V-MPO share, ``tpu_rl``'s
    ``train_step`` body: ``K_epoch`` epochs of value-and-grad of
    ``loss_fn(params, batch, *epoch_args[e]) -> (loss, metrics)``, the
    global-norm clip (of ``clip_subtree`` only, when given), RMSprop and
    ``project`` (V-MPO's floor on ``log_eta``) behind the update guard; then
    ``grad-norm``, ``nonfinite-updates`` and the diag scalars.

    ``sync`` is the collective hook (:class:`~tpu_rl_torch.parallel.mesh.Mesh`
    under data parallelism, the identity by default): ``sync.grads`` takes
    the grads' mean over the ranks, with the loss riding along, before the
    clip, so the clip, the guard and the optimizer see global numbers and
    every rank decides the same.

    The step's phases are spans (:func:`tpu_rl_torch.obs.trace.span`, off
    by default): ``train_step`` around each call, with the call's index
    counted on the host as ``update``; in each epoch ``train_step.forward``
    (``loss_fn``), ``train_step.backward`` (the gradients) and
    ``train_step.optimizer`` (the clip, the guard, RMSprop and
    ``project``); after the epochs ``train_step.diag``.

    Returns ``step(state, batch, epoch_args=None) -> (state, metrics)``."""
    opt = rmsprop(cfg)
    guard = cfg.update_guard
    calls = 0  # the step's calls so far; state.step would be a device read

    def apply(grads, state: TrainState):
        params, opt_state = opt.apply(grads, state.opt_state, state.params)
        return (project(params) if project else params), opt_state

    def step(state: TrainState, batch, epoch_args=None):
        nonlocal calls
        with span("train_step", update=calls):
            calls += 1
            params0 = state.params
            metrics: dict = {}
            grads = None
            nf = None
            for e in range(cfg.K_epoch):
                extra = () if epoch_args is None else epoch_args[e]
                loss, metrics, grads = value_and_grad(
                    loss_fn, state.params, batch, *extra,
                    phases=(span("train_step.forward"), span("train_step.backward")))
                metrics = {k: (v.detach() if torch.is_tensor(v) else v)
                           for k, v in metrics.items()}
                grads, loss = sync.grads(grads, loss)
                with span("train_step.optimizer"):
                    grads, gnorm = clip_subtree_by_global_norm(
                        grads, cfg.max_grad_norm, clip_subtree)
                    if guard:
                        ok = update_ok(loss, gnorm)
                        params, opt_state = guarded(
                            ok, lambda grads=grads, state=state: apply(grads, state),
                            (state.params, state.opt_state),
                        )
                        skipped = 1.0 - ok.float()
                        nf = skipped if nf is None else nf + skipped
                    else:
                        params, opt_state = apply(grads, state)
                state = state.replace(params=params, opt_state=opt_state)
                metrics["grad-norm"] = gnorm
            if guard:
                metrics["nonfinite-updates"] = nf
            if cfg.learn_diag:
                with span("train_step.diag"):
                    scalars = metrics["diag"]["scalars"]
                    scalars.update(
                        {f"grad-norm-{k}": v for k, v in module_grad_norms(grads).items()}
                    )
                    scalars["update-norm"] = tree_delta_norm(state.params, params0)
                    scalars["param-norm"] = tree_norm(state.params)
            return state.replace(step=state.step + 1), metrics

    return step

