"""CartPole-v1 dynamics as batched torch ops — the port of
``tpu_rl.envs.cartpole``.

gymnasium's physics: Euler integration at ``tau=0.02`` of the
Barto-Sutton-Anderson cart-pole, termination at ``|x| > 2.4`` or
``|theta| > 12°``, reward 1.0 every step (the terminating one included),
reset uniform in ``[-0.05, 0.05]^4``. In float32, in gymnasium's update
order. The state is ``(n, 4)`` ``[x, x_dot, theta, theta_dot]`` and is the
observation.
"""

from __future__ import annotations

import math

import torch

from tpu_rl_torch.envs.core import EnvSpec

GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
TOTAL_MASS = MASSPOLE + MASSCART
LENGTH = 0.5  # half the pole's length
POLEMASS_LENGTH = MASSPOLE * LENGTH
FORCE_MAG = 10.0
TAU = 0.02
X_THRESHOLD = 2.4
THETA_THRESHOLD = 12 * 2 * math.pi / 360  # ~0.2095 rad


def reset(n: int, generator: torch.Generator | None, device: torch.device):
    state = torch.rand((n, 4), generator=generator, device=device) * 0.1 - 0.05
    return state, state.clone()


def step(state: torch.Tensor, action: torch.Tensor):
    x, x_dot, theta, theta_dot = state.unbind(-1)
    # action: (n, 1) float index from the discrete policy (0 = push left).
    force = torch.where(action.reshape(-1) > 0.5, FORCE_MAG, -FORCE_MAG)
    costheta = torch.cos(theta)
    sintheta = torch.sin(theta)
    temp = (force + POLEMASS_LENGTH * theta_dot**2 * sintheta) / TOTAL_MASS
    thetaacc = (GRAVITY * sintheta - costheta * temp) / (
        LENGTH * (4.0 / 3.0 - MASSPOLE * costheta**2 / TOTAL_MASS)
    )
    xacc = temp - POLEMASS_LENGTH * thetaacc * costheta / TOTAL_MASS
    # Euler, in gymnasium's order: positions first, from the old rates.
    x = x + TAU * x_dot
    x_dot = x_dot + TAU * xacc
    theta = theta + TAU * theta_dot
    theta_dot = theta_dot + TAU * thetaacc
    state = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
    done = (torch.abs(x) > X_THRESHOLD) | (torch.abs(theta) > THETA_THRESHOLD)
    reward = torch.ones_like(x)
    return state, state.clone(), reward, done


CARTPOLE = EnvSpec(
    name="CartPole-v1",
    obs_shape=(4,),
    action_space=2,
    is_continuous=False,
    reset=reset,
    step=step,
)
