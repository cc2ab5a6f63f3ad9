"""Model-family registry — the port of ``tpu_rl.models.families``.

A family bundles the modules with plain functions over a separate parameter
dict, ``{"actor": state_dict}`` (and ``"critic"`` for SAC), so a server can
swap one params reference without touching the module. ``act(params, obs,
h, c, generator=None, gumbel=None | noise=None)`` returns ``(action f32,
behaviour logits (B,A), log_prob, h', c')``, the contract of ``tpu_rl``'s
``family.act``: a (B,1) action index and (B,1) log-prob for a categorical
policy (log-softmax logits), a (B,A) action and per-dimension (B,A)
log-prob for a Gaussian one (zero logits). ``actor_unroll(actor_params,
obs, carry0, firsts)`` and ``critic_unroll(critic_params, *args)`` are the
learner's sequence forwards; ``act_greedy`` (continuous families) the
deterministic act.

Families by ``cfg.algo``: PPO, IMPALA and V-MPO share the LSTM
``DiscreteActorCritic`` (or, with ``cfg.model="transformer"``, the
``TransformerActorCritic``, which acts through KV-cached ``decode`` and
carries its caches in the (h, c) slots; ``_act_transformer_window``, the
full-window recompute, is the oracle that act is held against); PPO-Continuous the
``ContinuousActorCritic``; SAC and SAC-Continuous an actor with a separate
twin critic.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable

import torch
from torch import nn
from torch.func import functional_call

from tpu_rl_torch import resolve_device
from tpu_rl_torch.config import Config
from tpu_rl_torch.models.policies import (
    ContinuousActorCritic,
    DiscreteActorCritic,
    SACContinuousActor,
    SACContinuousTwinCritic,
    SACDiscreteActor,
    SACDiscreteTwinCritic,
)
from tpu_rl_torch.models.transformer import TransformerActorCritic
from tpu_rl_torch.ops import distributions as D

Params = dict[str, dict[str, torch.Tensor]]

ALGOS = ("PPO", "PPO-Continuous", "IMPALA", "V-MPO", "SAC", "SAC-Continuous")


@dataclass(frozen=True)
class ModelFamily:
    algo: str
    actor: nn.Module
    obs_dim: int
    n_actions: int
    hidden: int
    device: torch.device
    # Builds a fresh actor module on the CPU (the module of ``actor``).
    make_actor: Callable[[], nn.Module] = field(repr=False, default=None)
    act: Callable[..., tuple[torch.Tensor, ...]] = field(repr=False, default=None)
    # Widths of the acting carry (h, c). LSTM: (hidden, hidden). Transformer:
    # (K caches, V caches + step counter).
    act_carry_widths: tuple[int, int] | None = None
    # Whether the per-step carry must be stored into the batch (LSTM training
    # starts from the stored seq-step-0 states), so replies carry hx/cx.
    # Transformer training ignores the carry.
    store_carry: bool = True
    # Gaussian actions (PPO-Continuous, SAC-Continuous).
    continuous: bool = False
    # A separate critic with its own optimizer (the SAC families).
    separate: bool = False
    critic: nn.Module | None = None
    make_critic: Callable[[], nn.Module] | None = field(repr=False, default=None)
    # Deterministic act, ``(params, obs, h, c) -> (action, h', c')``: the
    # distribution's (squashed) mean; continuous families only.
    act_greedy: Callable[..., tuple[torch.Tensor, ...]] | None = field(repr=False, default=None)

    @property
    def carry_widths(self) -> tuple[int, int]:
        """Widths of the acting carry (h, c)."""
        return self.act_carry_widths or (self.hidden, self.hidden)

    @property
    def stored_carry_widths(self) -> tuple[int, int]:
        """Widths of a batch's ``hx``/``cx``: the acting carry's, or 1-wide
        zero placeholders when the family stores no carry
        (``tpu_rl.data.layout.BatchLayout.from_config``)."""
        return self.carry_widths if self.store_carry else (1, 1)

    def init_params(self, generator: torch.Generator | None = None) -> Params:
        """A fresh ``{"actor": state_dict}`` (and ``"critic"`` for a family
        with a separate critic) on the family's device, drawn with flax's
        init from ``generator`` (a CPU generator, so a seed gives the same
        weights on every machine), the actor first."""
        params = {}
        for group, make in (("actor", self.make_actor), ("critic", self.make_critic)):
            if make is None:
                continue
            module = make()
            module.reset_parameters(generator)
            params[group] = {k: v.detach().to(self.device) for k, v in module.state_dict().items()}
        return params

    def actor_unroll(self, actor_params, obs, carry0, firsts):
        return functional_call(self.actor, actor_params, (obs, carry0, firsts))

    def critic_unroll(self, critic_params, *args):
        """The twin critic's ``(q1, q2)``: ``(obs, carry0, firsts)`` for the
        discrete critic, ``(obs, act, carry0, firsts)`` for the continuous."""
        assert self.critic is not None
        return functional_call(self.critic, critic_params, args)


def _act_discrete_ac(
    actor: DiscreteActorCritic,
    params: Params,
    obs: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
):
    logits, _v, (h2, c2) = functional_call(actor, params["actor"], (obs, (h, c)))
    a = D.categorical_sample(logits, generator, gumbel=gumbel)
    log_prob = D.categorical_log_prob(logits, a)
    return a[..., None].float(), logits, log_prob[..., None], h2, c2


def _act_continuous_ac(
    actor: ContinuousActorCritic, params: Params, obs, h, c,
    generator: torch.Generator | None = None, noise: torch.Tensor | None = None,
):
    mu, std, _v, (h2, c2) = functional_call(actor, params["actor"], (obs, (h, c)))
    a = D.normal_sample(mu, std, generator, noise=noise)
    return a, torch.zeros_like(mu), D.normal_log_prob(mu, std, a), h2, c2


def _greedy_continuous_ac(actor: ContinuousActorCritic, params: Params, obs, h, c):
    mu, _std, _v, (h2, c2) = functional_call(actor, params["actor"], (obs, (h, c)))
    return mu, h2, c2


def _act_sac_discrete(
    actor: SACDiscreteActor, params: Params, obs, h, c,
    generator: torch.Generator | None = None, gumbel: torch.Tensor | None = None,
):
    logits, (h2, c2) = functional_call(actor, params["actor"], (obs, (h, c)))
    a = D.categorical_sample(logits, generator, gumbel=gumbel)
    return a[..., None].float(), logits, D.categorical_log_prob(logits, a)[..., None], h2, c2


def _act_sac_continuous(
    actor: SACContinuousActor, params: Params, obs, h, c,
    generator: torch.Generator | None = None, noise: torch.Tensor | None = None,
):
    mu, log_std, (h2, c2) = functional_call(actor, params["actor"], (obs, (h, c)))
    a, log_prob = D.tanh_normal_sample(mu, torch.exp(log_std), generator, noise=noise)
    return a, torch.zeros_like(mu), log_prob, h2, c2


def _greedy_sac_continuous(actor: SACContinuousActor, params: Params, obs, h, c):
    mu, _log_std, (h2, c2) = functional_call(actor, params["actor"], (obs, (h, c)))
    return torch.tanh(mu), h2, c2


def _act_transformer(
    actor: TransformerActorCritic,
    ctx: int,
    n_layers: int,
    n_heads: int,
    hidden: int,
    params: Params,
    obs: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
):
    """KV-cached acting: ``h`` is the flattened per-layer K caches
    (n_layers·ctx·hidden), ``c`` the flattened V caches plus a trailing
    1-float step counter. Zeroing both at an episode start empties the
    caches; positions are episode-relative (the counter)."""
    head_d = hidden // n_heads
    B = h.shape[0]
    k_caches = h.reshape(B, n_layers, ctx, n_heads, head_d)
    v_caches = c[:, :-1].reshape(B, n_layers, ctx, n_heads, head_d)
    count = c[:, -1].to(torch.int32)  # (B,), per env row
    logits, _v, k2, v2 = functional_call(actor, params["actor"], (obs, (k_caches, v_caches, count)))
    a = D.categorical_sample(logits, generator, gumbel=gumbel)
    log_prob = D.categorical_log_prob(logits, a)
    h2 = k2.reshape(B, -1)
    c2 = torch.cat([v2.reshape(B, -1), (count + 1).float()[:, None]], dim=1)
    return a[..., None].float(), logits, log_prob[..., None], h2, c2


def _act_transformer_window(
    actor: TransformerActorCritic,
    ctx: int,
    obs_dim: int,
    params: Params,
    obs: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
):
    """Full-window recompute acting, one env row: ``h`` is the flattened
    history of the last ``ctx`` observations (newest last), ``c`` a 1-float
    count of valid steps. O(ctx²·d) a step: the oracle that the KV-cached
    :func:`_act_transformer` is held against while an episode fits the
    window; nothing on the acting path calls it."""
    hist = h.reshape(1, ctx, obs_dim)
    hist = torch.cat([hist[:, 1:], obs[:, None, :]], dim=1)
    n_valid = torch.clamp(c[0, 0] + 1.0, max=float(ctx))
    n = n_valid.to(torch.int32)
    idx = torch.arange(ctx, device=obs.device)
    # Rows before the episode get segment 0, its rows segment 1: the query
    # (the last row) is always valid, so the padding is masked out exactly.
    seg = (idx >= ctx - n)[None].to(torch.int32)
    # Episode-relative positions: the oldest valid row is position 0 (or the
    # sliding offset once the episode outgrows the window).
    pos = torch.clamp(idx - (ctx - n), min=0)[None].to(torch.int32)
    firsts = torch.zeros((1, ctx, 1), device=obs.device)
    logits, _value, _ = functional_call(
        actor, params["actor"], (hist, None, firsts), {"pos": pos, "seg": seg}
    )
    last = logits[:, -1]
    a = D.categorical_sample(last, generator, gumbel=gumbel)
    log_prob = D.categorical_log_prob(last, a)
    return (a[..., None].float(), last, log_prob[..., None], hist.reshape(1, ctx * obs_dim),
            torch.zeros_like(c) + n_valid)


def build_family(
    cfg: Config, device: str | torch.device | None = "cuda", mesh=None
) -> ModelFamily:
    """Build the model family for ``cfg.algo`` and ``cfg.model`` on
    ``device`` (CUDA unless the caller passes ``device="cpu"``). ``mesh``
    (a rank mesh) is read only by the sequence-parallel transformer
    (``attention_impl`` ring/ulysses), whose training unroll it splits."""
    dev = resolve_device(device)
    obs_dim = int(cfg.obs_shape[0])
    n = int(cfg.action_space)
    if cfg.model == "transformer":
        assert cfg.algo in ("PPO", "IMPALA", "V-MPO"), (
            "transformer backbone supports the discrete on-policy algorithms"
        )
        make = partial(
            TransformerActorCritic, obs_dim, n, cfg.hidden_size, cfg.n_heads, cfg.n_layers,
            attention_impl=cfg.attention_impl,
            dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None,
        )
        actor = make(mesh=mesh).to(dev)
        ctx = cfg.effective_act_ctx
        kv = cfg.n_layers * ctx * cfg.hidden_size
        return ModelFamily(
            cfg.algo, actor, obs_dim, n, cfg.hidden_size, dev, make_actor=make,
            act=partial(_act_transformer, actor, ctx, cfg.n_layers, cfg.n_heads, cfg.hidden_size),
            act_carry_widths=(kv, kv + 1),
            store_carry=False,
        )
    # Mixed precision for the LSTM families: params f32, the torso and LSTM
    # products in bf16 with f32 sums, heads and carry f32 (LSTMCell.dtype).
    kw = dict(
        hidden=cfg.hidden_size, reset_on_first=cfg.reset_carry_on_first,
        dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None,
    )
    base = dict(algo=cfg.algo, obs_dim=obs_dim, n_actions=n, hidden=cfg.hidden_size, device=dev)
    if cfg.algo in ("PPO", "IMPALA", "V-MPO"):
        make = partial(DiscreteActorCritic, obs_dim, n, **kw)
        actor = make().to(dev)
        return ModelFamily(actor=actor, make_actor=make, act=partial(_act_discrete_ac, actor), **base)
    if cfg.algo == "PPO-Continuous":
        make = partial(ContinuousActorCritic, obs_dim, n, std_floor=cfg.std_floor, **kw)
        actor = make().to(dev)
        return ModelFamily(
            actor=actor, make_actor=make, act=partial(_act_continuous_ac, actor),
            act_greedy=partial(_greedy_continuous_ac, actor), continuous=True, **base,
        )
    if cfg.algo == "SAC":
        make = partial(SACDiscreteActor, obs_dim, n, **kw)
        make_critic = partial(SACDiscreteTwinCritic, obs_dim, n, **kw)
        actor = make().to(dev)
        return ModelFamily(
            actor=actor, make_actor=make, act=partial(_act_sac_discrete, actor), separate=True,
            critic=make_critic().to(dev), make_critic=make_critic, **base,
        )
    if cfg.algo == "SAC-Continuous":
        make = partial(SACContinuousActor, obs_dim, n, **kw)
        make_critic = partial(SACContinuousTwinCritic, obs_dim, n, **kw)
        actor = make().to(dev)
        return ModelFamily(
            actor=actor, make_actor=make, act=partial(_act_sac_continuous, actor),
            act_greedy=partial(_greedy_sac_continuous, actor), continuous=True, separate=True,
            critic=make_critic().to(dev), make_critic=make_critic, **base,
        )
    raise ValueError(f"unknown algo {cfg.algo!r}")


def to_device_params(params: Any, device: torch.device) -> Any:
    """Fresh contiguous copies of a parameter tree (nested dicts of numpy
    arrays or tensors) on ``device``: float32, except bf16 and int8 tensors
    (the serving precisions of :mod:`tpu_rl_torch.models.quant`), which keep
    their dtype. Always copies, so the caller may go on mutating what it
    passed."""
    if isinstance(params, dict):
        return {k: to_device_params(v, device) for k, v in params.items()}
    t = torch.as_tensor(params).detach()
    dtype = t.dtype if t.dtype in (torch.bfloat16, torch.int8) else torch.float32
    return t.to(device=device, dtype=dtype, copy=True).contiguous()
