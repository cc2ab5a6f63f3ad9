"""Policy and critic modules — the port of ``tpu_rl.models.policies``.

Modules return distribution parameters (log-softmax logits, or mu and std /
log_std); sampling lives in :mod:`tpu_rl_torch.ops.distributions` with
explicit generators. Submodule names are the flax names, so the state_dict
keys follow the flax tree paths and the bridge maps them with no special
case. Each module's ``forward`` is what ``torch.func.functional_call``
calls: an actor's one act step without ``firsts``, its sequence unroll with
them (flax's ``apply(..., method=)``); a critic's forward is its unroll.

``dtype`` is the compute dtype of ``tpu_rl``'s modules (None = f32): the
torso Dense(s) and the LSTM cell compute in it (``LSTMCell.dtype``), the
heads stay f32, and the parameters are f32 either way, so one parameter
tree serves both.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from tpu_rl_torch.models.cells import Carry, LSTMCell, dense, init_dense_

LOG_STD_MIN = -20.0
LOG_STD_MAX = 2.0


class DiscreteActorCritic(nn.Module):
    """Shared-torso categorical actor-critic: Dense+relu torso, LSTM cell, a
    logits head and a value head. Submodule names (``body``, ``cell``,
    ``logits``, ``value``) are the flax names, so the state_dict keys follow
    the flax tree paths."""

    def __init__(
        self, obs_dim: int, n_actions: int, hidden: int = 64, reset_on_first: bool = True,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.n_actions = n_actions
        self.hidden = hidden
        self.reset_on_first = reset_on_first
        self.body = nn.Linear(obs_dim, hidden)
        self.cell = LSTMCell(hidden, hidden, dtype)
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
        x = torch.relu(dense(self.body, obs, self.dtype))
        carry, h = self.cell(carry, x)
        return torch.log_softmax(self.logits(h), dim=-1), self.value(h), carry

    def unroll(self, obs: torch.Tensor, carry0: Carry, firsts: torch.Tensor):
        """Batched sequence forward: obs (B, S, D), carry0 ((B,H),(B,H)),
        firsts (B, S, 1) -> (logits (B,S,A) log-softmax, value (B,S,1),
        carry)."""
        x = torch.relu(dense(self.body, obs, self.dtype))
        carry, hs = self.cell.unroll(x, carry0, firsts, self.reset_on_first)
        return torch.log_softmax(self.logits(hs), dim=-1), self.value(hs), carry

    def forward(self, obs: torch.Tensor, carry: Carry, firsts: torch.Tensor | None = None):
        """``torch.func.functional_call`` calls ``forward``, so the family's
        functions go through it: one act step without ``firsts``, the
        sequence unroll with them (flax's ``apply(..., method=)``)."""
        if firsts is None:
            return self.act(obs, carry)
        return self.unroll(obs, carry, firsts)


class ContinuousActorCritic(nn.Module):
    """Shared-torso Gaussian actor-critic: Dense+relu torso, LSTM cell,
    ``mu = tanh(Dense)``, ``std = softplus(Dense) + std_floor`` and a value
    head (``body``, ``cell``, ``mu``, ``std``, ``value``)."""

    def __init__(
        self, obs_dim: int, n_actions: int, hidden: int = 64, reset_on_first: bool = True,
        std_floor: float = 0.0, dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.reset_on_first = reset_on_first
        self.std_floor = std_floor
        self.body = nn.Linear(obs_dim, hidden)
        self.cell = LSTMCell(hidden, hidden, dtype)
        self.mu = nn.Linear(hidden, n_actions)
        self.std = nn.Linear(hidden, n_actions)
        self.value = nn.Linear(hidden, 1)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for m in (self.body, self.cell, self.mu, self.std, self.value):
            _reset(m, generator)

    def _dist(self, h: torch.Tensor):
        return torch.tanh(self.mu(h)), F.softplus(self.std(h)) + self.std_floor

    def act(self, obs: torch.Tensor, carry: Carry):
        """-> (mu, std, value, new carry)."""
        carry, h = self.cell(carry, torch.relu(dense(self.body, obs, self.dtype)))
        mu, std = self._dist(h)
        return mu, std, self.value(h), carry

    def unroll(self, obs: torch.Tensor, carry0: Carry, firsts: torch.Tensor):
        """-> (mu (B,S,A), std (B,S,A), value (B,S,1), carry)."""
        x = torch.relu(dense(self.body, obs, self.dtype))
        carry, hs = self.cell.unroll(x, carry0, firsts, self.reset_on_first)
        mu, std = self._dist(hs)
        return mu, std, self.value(hs), carry

    def forward(self, obs: torch.Tensor, carry: Carry, firsts: torch.Tensor | None = None):
        if firsts is None:
            return self.act(obs, carry)
        return self.unroll(obs, carry, firsts)


class SACDiscreteActor(nn.Module):
    """Categorical SAC actor (``body``, ``cell``, ``logits``): the act step
    returns the log-softmax logits, the unroll ``(probs, log_probs)``."""

    def __init__(self, obs_dim: int, n_actions: int, hidden: int = 64, reset_on_first: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.reset_on_first = reset_on_first
        self.body = nn.Linear(obs_dim, hidden)
        self.cell = LSTMCell(hidden, hidden, dtype)
        self.logits = nn.Linear(hidden, n_actions)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for m in (self.body, self.cell, self.logits):
            _reset(m, generator)

    def act(self, obs: torch.Tensor, carry: Carry):
        carry, h = self.cell(carry, torch.relu(dense(self.body, obs, self.dtype)))
        return torch.log_softmax(self.logits(h), dim=-1), carry

    def unroll(self, obs: torch.Tensor, carry0: Carry, firsts: torch.Tensor):
        x = torch.relu(dense(self.body, obs, self.dtype))
        _, hs = self.cell.unroll(x, carry0, firsts, self.reset_on_first)
        logp = torch.log_softmax(self.logits(hs), dim=-1)
        return torch.exp(logp), logp

    def forward(self, obs: torch.Tensor, carry: Carry, firsts: torch.Tensor | None = None):
        if firsts is None:
            return self.act(obs, carry)
        return self.unroll(obs, carry, firsts)


class SACDiscreteCritic(nn.Module):
    """Per-action Q critic (``body``, ``cell``, ``q``): (B,S,A) values."""

    def __init__(self, obs_dim: int, n_actions: int, hidden: int = 64, reset_on_first: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.reset_on_first = reset_on_first
        self.body = nn.Linear(obs_dim, hidden)
        self.cell = LSTMCell(hidden, hidden, dtype)
        self.q = nn.Linear(hidden, n_actions)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for m in (self.body, self.cell, self.q):
            _reset(m, generator)

    def forward(self, obs: torch.Tensor, carry0: Carry, firsts: torch.Tensor):
        x = torch.relu(dense(self.body, obs, self.dtype))
        _, hs = self.cell.unroll(x, carry0, firsts, self.reset_on_first)
        return self.q(hs)


class SACDiscreteTwinCritic(nn.Module):
    """Twin per-action Q critics ``q1`` and ``q2``, separate parameters."""

    def __init__(self, obs_dim: int, n_actions: int, hidden: int = 64, reset_on_first: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.q1 = SACDiscreteCritic(obs_dim, n_actions, hidden, reset_on_first, dtype)
        self.q2 = SACDiscreteCritic(obs_dim, n_actions, hidden, reset_on_first, dtype)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.q1.reset_parameters(generator)
        self.q2.reset_parameters(generator)

    def forward(self, obs: torch.Tensor, carry0: Carry, firsts: torch.Tensor):
        return self.q1(obs, carry0, firsts), self.q2(obs, carry0, firsts)


class SACContinuousActor(nn.Module):
    """Tanh-squashed Gaussian SAC actor (``body``, ``cell``, ``mu``,
    ``log_std``): returns ``(mu, log_std clamped to [-20, 2])`` (and the
    carry from the act step); the squashed sample is
    :func:`~tpu_rl_torch.ops.distributions.tanh_normal_sample`'s."""

    def __init__(self, obs_dim: int, n_actions: int, hidden: int = 64, reset_on_first: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.reset_on_first = reset_on_first
        self.body = nn.Linear(obs_dim, hidden)
        self.cell = LSTMCell(hidden, hidden, dtype)
        self.mu = nn.Linear(hidden, n_actions)
        self.log_std = nn.Linear(hidden, n_actions)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for m in (self.body, self.cell, self.mu, self.log_std):
            _reset(m, generator)

    def _dist(self, h: torch.Tensor):
        return self.mu(h), torch.clamp(self.log_std(h), LOG_STD_MIN, LOG_STD_MAX)

    def act(self, obs: torch.Tensor, carry: Carry):
        carry, h = self.cell(carry, torch.relu(dense(self.body, obs, self.dtype)))
        mu, log_std = self._dist(h)
        return mu, log_std, carry

    def unroll(self, obs: torch.Tensor, carry0: Carry, firsts: torch.Tensor):
        x = torch.relu(dense(self.body, obs, self.dtype))
        _, hs = self.cell.unroll(x, carry0, firsts, self.reset_on_first)
        return self._dist(hs)

    def forward(self, obs: torch.Tensor, carry: Carry, firsts: torch.Tensor | None = None):
        if firsts is None:
            return self.act(obs, carry)
        return self.unroll(obs, carry, firsts)


class SACContinuousCritic(nn.Module):
    """Two-stream (obs, action) Q critic: ``obs_body`` and ``act_body`` of
    width ``hidden // 2`` each, concatenated into the LSTM cell, so the
    cell's input is ``2 * (hidden // 2)`` wide (``hidden - 1`` for an odd
    ``hidden``); a scalar ``q`` head."""

    def __init__(self, obs_dim: int, n_actions: int, hidden: int = 64, reset_on_first: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.reset_on_first = reset_on_first
        half = hidden // 2
        self.obs_body = nn.Linear(obs_dim, half)
        self.act_body = nn.Linear(n_actions, half)
        self.cell = LSTMCell(2 * half, hidden, dtype)
        self.q = nn.Linear(hidden, 1)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for m in (self.obs_body, self.act_body, self.cell, self.q):
            _reset(m, generator)

    def forward(self, obs: torch.Tensor, act: torch.Tensor, carry0: Carry, firsts: torch.Tensor):
        x = torch.cat([torch.relu(dense(self.obs_body, obs, self.dtype)),
                       torch.relu(dense(self.act_body, act, self.dtype))], dim=-1)
        _, hs = self.cell.unroll(x, carry0, firsts, self.reset_on_first)
        return self.q(hs)


class SACContinuousTwinCritic(nn.Module):
    """Twin continuous critics ``q1`` and ``q2``, separate parameters."""

    def __init__(self, obs_dim: int, n_actions: int, hidden: int = 64, reset_on_first: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.q1 = SACContinuousCritic(obs_dim, n_actions, hidden, reset_on_first, dtype)
        self.q2 = SACContinuousCritic(obs_dim, n_actions, hidden, reset_on_first, dtype)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.q1.reset_parameters(generator)
        self.q2.reset_parameters(generator)

    def forward(self, obs: torch.Tensor, act: torch.Tensor, carry0: Carry, firsts: torch.Tensor):
        return self.q1(obs, act, carry0, firsts), self.q2(obs, act, carry0, firsts)


def _reset(m: nn.Module, generator: torch.Generator | None) -> None:
    """flax's init of one submodule: a Dense's or the cell's."""
    if isinstance(m, nn.Linear):
        init_dense_(m, generator)
    else:
        m.reset_parameters(generator)
