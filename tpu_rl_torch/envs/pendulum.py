"""Pendulum-v1 dynamics as batched torch ops — the port of
``tpu_rl.envs.pendulum``.

gymnasium's physics: semi-implicit Euler at ``dt=0.05`` with ``g=10, m=1,
l=1``, torque clipped to ``[-2, 2]``, angular velocity clipped to ``[-8,
8]``, cost ``angle_normalize(theta)^2 + 0.1*thdot^2 + 0.001*u^2`` from the
pre-step state, reset ``theta ~ U(-pi, pi)``, ``thdot ~ U(-1, 1)``. The env
never terminates: gymnasium truncates at 200 steps, which the colocated
loop expresses as ``Config.time_horizon=200``. In float32. The state is
``(n, 2)`` ``[theta, theta_dot]``; the observation ``[cos, sin, theta_dot]``.
"""

from __future__ import annotations

import math

import torch

from tpu_rl_torch.envs.core import EnvSpec

MAX_SPEED = 8.0
MAX_TORQUE = 2.0
DT = 0.05
G = 10.0
M = 1.0
L = 1.0


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    return ((x + math.pi) % (2 * math.pi)) - math.pi


def _obs(state: torch.Tensor) -> torch.Tensor:
    theta, theta_dot = state.unbind(-1)
    return torch.stack([torch.cos(theta), torch.sin(theta), theta_dot], dim=-1)


def reset(n: int, generator: torch.Generator | None, device: torch.device):
    u = torch.rand((n, 2), generator=generator, device=device)
    theta = u[:, 0] * (2 * math.pi) - math.pi
    theta_dot = u[:, 1] * 2.0 - 1.0
    state = torch.stack([theta, theta_dot], dim=-1)
    return state, _obs(state)


def step(state: torch.Tensor, action: torch.Tensor):
    theta, theta_dot = state.unbind(-1)
    # action: (n, 1) torque from the Gaussian policy.
    u = torch.clamp(action.reshape(-1), -MAX_TORQUE, MAX_TORQUE)
    cost = _angle_normalize(theta) ** 2 + 0.1 * theta_dot**2 + 0.001 * u**2
    theta_dot = theta_dot + (3.0 * G / (2.0 * L) * torch.sin(theta) + 3.0 / (M * L**2) * u) * DT
    theta_dot = torch.clamp(theta_dot, -MAX_SPEED, MAX_SPEED)
    theta = theta + theta_dot * DT  # semi-implicit: the new rate advances the angle
    state = torch.stack([theta, theta_dot], dim=-1)
    return state, _obs(state), -cost, torch.zeros_like(theta, dtype=torch.bool)


PENDULUM = EnvSpec(
    name="Pendulum-v1",
    obs_shape=(3,),
    action_space=1,
    is_continuous=True,
    reset=reset,
    step=step,
)
