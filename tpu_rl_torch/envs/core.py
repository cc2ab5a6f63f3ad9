"""EnvSpec contract and the batched auto-reset wrapper — the port of
``tpu_rl.envs.core``.

An :class:`EnvSpec` holds one env's dynamics as batched torch ops:

- ``reset(n, generator, device) -> (state, obs)``: ``n`` fresh states;
- ``step(state, action) -> (state, obs, reward, done)`` for a batch, with
  ``action`` the policy's float column ((n, 1) index for discrete envs) and
  ``done`` termination only; truncation is the wrapper's.

:func:`make_vec_env` lifts a spec to an ``n_envs`` batch with per-env
auto-reset: an env that terminates or reaches the horizon comes back reset
in place (fresh state, ``t = 0``, the reset observation), while its reward is
still the real transition's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

State = Any


@dataclass(frozen=True)
class EnvSpec:
    name: str
    obs_shape: tuple[int, ...]
    action_space: int  # n discrete actions, or continuous action dim
    is_continuous: bool
    reset: Callable[[int, torch.Generator | None, torch.device], tuple[State, torch.Tensor]]
    step: Callable[[State, torch.Tensor], tuple[State, torch.Tensor, torch.Tensor, torch.Tensor]]


def make_vec_env(spec: EnvSpec, n_envs: int, horizon: int):
    """Batch ``spec`` over ``n_envs`` instances with auto-reset.

    Returns ``(v_reset, v_step)``:

    - ``v_reset(generator, device) -> (state, obs)`` with
      ``state = {"phys": ..., "t": (n,) int32}``;
    - ``v_step(state, action, generator) -> (state, obs, reward, done)`` with
      ``done = terminated | (t >= horizon)``; done slots come back reset.
      ``reward`` is the raw (n,) reward.

    Every env draws a reset state at every step and ``torch.where`` keeps the
    live ones, so the step has no data-dependent host read.
    """

    def v_reset(generator: torch.Generator | None, device: torch.device):
        phys, obs = spec.reset(n_envs, generator, device)
        return {"phys": phys, "t": torch.zeros((n_envs,), dtype=torch.int32, device=device)}, obs

    def v_step(state, action: torch.Tensor, generator: torch.Generator | None):
        phys, obs, reward, term = spec.step(state["phys"], action)
        t = state["t"] + 1
        done = term | (t >= horizon)
        phys_r, obs_r = spec.reset(n_envs, generator, obs.device)

        def sel(fresh: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
            return torch.where(done.reshape((-1,) + (1,) * (live.dim() - 1)), fresh, live)

        phys = sel(phys_r, phys)
        obs = sel(obs_r, obs)
        t = sel(torch.zeros_like(t), t)
        return {"phys": phys, "t": t}, obs, reward, done

    return v_reset, v_step
