"""Model-family registry — the port of ``tpu_rl.models.families``.

A family bundles the module with plain functions over a separate parameter
dict, ``{"actor": state_dict}``, so a server can swap one params reference
without touching the module. ``act(params, obs, h, c, generator=None,
gumbel=None)`` returns ``(action f32 (B,1), log-softmax logits (B,A),
log_prob (B,1), h', c')``, the contract of ``tpu_rl``'s ``family.act``;
``actor_unroll(actor_params, obs, carry0, firsts)`` returns the sequence
forward ``(logits (B,S,A), value (B,S,1), carry)`` for the learner.
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
from tpu_rl_torch.models.policies import DiscreteActorCritic
from tpu_rl_torch.ops import distributions as D

Params = dict[str, dict[str, torch.Tensor]]


@dataclass(frozen=True)
class ModelFamily:
    algo: str
    actor: nn.Module
    obs_dim: int
    n_actions: int
    hidden: int
    device: torch.device
    act: Callable[..., tuple[torch.Tensor, ...]] = field(repr=False, default=None)
    # Whether the per-step carry must be stored into the batch (LSTM training
    # starts from the stored seq-step-0 states), so replies carry hx/cx.
    store_carry: bool = True

    @property
    def carry_widths(self) -> tuple[int, int]:
        """Widths of the acting carry (h, c)."""
        return self.hidden, self.hidden

    def init_params(self, generator: torch.Generator | None = None) -> Params:
        """A fresh ``{"actor": state_dict}`` on the family's device, drawn
        with flax's init from ``generator`` (a CPU generator, so a seed gives
        the same weights on every machine)."""
        module = DiscreteActorCritic(self.obs_dim, self.n_actions, self.hidden)
        module.reset_parameters(generator)
        return {
            "actor": {k: v.detach().to(self.device) for k, v in module.state_dict().items()}
        }

    def actor_unroll(self, actor_params, obs, carry0, firsts):
        return functional_call(self.actor, actor_params, (obs, carry0, firsts))


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


def build_family(cfg: Config, device: str | torch.device | None = "cuda") -> ModelFamily:
    """Build the model family for ``cfg.algo`` on ``device`` (CUDA unless
    the caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    if cfg.model != "lstm":
        raise NotImplementedError(
            f"model={cfg.model!r}: the transformer family and its attention "
            "kernel come with the last slice of the port"
        )
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: bf16 compute (mixed_dot, "
            "LSTMCell.dtype) comes with the bf16-compute slice of the port"
        )
    if cfg.algo not in ("PPO", "IMPALA", "V-MPO"):
        raise NotImplementedError(
            f"algo={cfg.algo!r}: the continuous and SAC families come with the "
            "other-algorithms slice of the port"
        )
    obs_dim = int(cfg.obs_shape[0])
    n = int(cfg.action_space)
    actor = DiscreteActorCritic(
        obs_dim, n, cfg.hidden_size, reset_on_first=cfg.reset_carry_on_first
    ).to(dev)
    return ModelFamily(
        cfg.algo, actor, obs_dim, n, cfg.hidden_size, dev, act=partial(_act_discrete_ac, actor)
    )


def to_device_params(params: Any, device: torch.device) -> Params:
    """Fresh float32 contiguous copies of a ``{"actor": {name: array}}`` tree
    (numpy arrays or tensors) on ``device``. Always copies, so the caller may
    go on mutating what it passed."""
    return {
        group: {
            k: torch.as_tensor(v).detach().to(device=device, dtype=torch.float32, copy=True)
            .contiguous()
            for k, v in tree.items()
        }
        for group, tree in params.items()
    }
