"""Policy modules — the port of ``tpu_rl.models.policies.DiscreteActorCritic``.

Modules return distribution parameters (log-softmax logits); sampling lives
in :mod:`tpu_rl_torch.ops.distributions` with explicit generators.
"""

from __future__ import annotations

import torch
from torch import nn

from tpu_rl_torch.models.cells import Carry, LSTMCell, init_dense_


class DiscreteActorCritic(nn.Module):
    """Shared-torso categorical actor-critic: Dense+relu torso, LSTM cell, a
    logits head and a value head. Submodule names (``body``, ``cell``,
    ``logits``, ``value``) are the flax names, so the state_dict keys follow
    the flax tree paths."""

    def __init__(
        self, obs_dim: int, n_actions: int, hidden: int = 64, reset_on_first: bool = True
    ):
        super().__init__()
        self.n_actions = n_actions
        self.hidden = hidden
        self.reset_on_first = reset_on_first
        self.body = nn.Linear(obs_dim, hidden)
        self.cell = LSTMCell(hidden, hidden)
        self.logits = nn.Linear(hidden, n_actions)
        self.value = nn.Linear(hidden, 1)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """flax's init: lecun_normal kernels, zero biases, drawn in the
        module order body, cell, logits, value."""
        init_dense_(self.body, generator)
        self.cell.reset_parameters(generator)
        init_dense_(self.logits, generator)
        init_dense_(self.value, generator)

    def act(self, obs: torch.Tensor, carry: Carry):
        """Single-step inference. Returns (log-softmax logits, value, new
        carry); sampling is external."""
        x = torch.relu(self.body(obs))
        carry, h = self.cell(carry, x)
        return torch.log_softmax(self.logits(h), dim=-1), self.value(h), carry

    def unroll(self, obs: torch.Tensor, carry0: Carry, firsts: torch.Tensor):
        """Batched sequence forward: obs (B, S, D), carry0 ((B,H),(B,H)),
        firsts (B, S, 1) -> (logits (B,S,A) log-softmax, value (B,S,1),
        carry)."""
        x = torch.relu(self.body(obs))
        carry, hs = self.cell.unroll(x, carry0, firsts, self.reset_on_first)
        return torch.log_softmax(self.logits(hs), dim=-1), self.value(hs), carry

    def forward(self, obs: torch.Tensor, carry: Carry, firsts: torch.Tensor | None = None):
        """``torch.func.functional_call`` calls ``forward``, so the family's
        functions go through it: one act step without ``firsts``, the
        sequence unroll with them (flax's ``apply(..., method=)``)."""
        if firsts is None:
            return self.act(obs, carry)
        return self.unroll(obs, carry, firsts)
