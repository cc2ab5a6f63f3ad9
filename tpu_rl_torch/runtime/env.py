"""Environment adapter — the port of ``tpu_rl.runtime.env``.

A gymnasium env with float32 flat observations, ``terminated or truncated``
collapsed into one done flag, continuous actions reshaped between the
policy's flat vector and the env's Box, ``cfg.action_repeat`` held actions,
and the conv flags (``need_conv``, ``height``, ``width``, ``is_gray``) as a
nearest-neighbour resize with optional grayscale. Host code only: numpy in,
numpy out; ``gymnasium`` is imported inside the functions that need it.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from tpu_rl_torch.config import Config


def probe_spaces(cfg: Config) -> Config:
    """``cfg`` with the runtime-derived ``obs_shape``, ``action_space`` and
    ``is_continuous`` filled in: read off the device env's spec in colocated
    mode (no gymnasium), else by making the gymnasium env once."""
    if cfg.env_mode == "colocated":
        from tpu_rl_torch.envs import get_spec

        spec = get_spec(cfg.env)
        return cfg.replace(
            obs_shape=spec.obs_shape,
            action_space=spec.action_space,
            is_continuous=spec.is_continuous,
        )
    import gymnasium as gym

    env = gym.make(cfg.env)
    obs_space = env.observation_space
    act_space = env.action_space
    env.close()
    if hasattr(act_space, "n"):  # Discrete
        action_space, continuous = int(act_space.n), False
    else:  # Box
        action_space, continuous = int(np.prod(act_space.shape)), True
    if cfg.need_conv:
        # the adapter resizes to (height, width[, c]) and flattens: obs_shape
        # is the preprocessed observation the models consume
        channels = 1 if cfg.is_gray else (
            obs_space.shape[-1] if len(obs_space.shape) == 3 else 1
        )
        obs_shape: tuple[int, ...] = (cfg.height * cfg.width * channels,)
    else:
        obs_shape = tuple(int(s) for s in obs_space.shape)
    return cfg.replace(
        obs_shape=obs_shape,
        action_space=action_space,
        is_continuous=continuous,
    )


class EnvAdapter:
    """Reset/step with preprocessed observations and a single done flag."""

    def __init__(self, cfg: Config, seed: int | None = None):
        import gymnasium as gym

        self.cfg = cfg
        self.env = gym.make(cfg.env)
        self._seed = seed
        self._continuous = cfg.is_continuous
        self._act_space = self.env.action_space

    def _preprocess(self, obs: Any) -> np.ndarray:
        arr = np.asarray(obs, np.float32)
        if self.cfg.need_conv:
            arr = self._conv_preprocess(arr)
        return arr.reshape(-1) if arr.ndim > 1 else arr

    def _conv_preprocess(self, arr: np.ndarray) -> np.ndarray:
        """Nearest-neighbour resize to (height, width), grayscale first when
        ``is_gray`` and the image has 3 channels; scaled to [0, 1]."""
        h, w = self.cfg.height, self.cfg.width
        if self.cfg.is_gray and arr.ndim == 3 and arr.shape[-1] == 3:
            arr = arr @ np.asarray([0.299, 0.587, 0.114], np.float32)
        ys = (np.linspace(0, arr.shape[0] - 1, h)).astype(np.int64)
        xs = (np.linspace(0, arr.shape[1] - 1, w)).astype(np.int64)
        return arr[np.ix_(ys, xs)].astype(np.float32) / 255.0

    def reset(self) -> np.ndarray:
        if self._seed is not None:
            obs, _ = self.env.reset(seed=self._seed)
            self._seed = None  # seed once, then let the env's RNG evolve
        else:
            obs, _ = self.env.reset()
        return self._preprocess(obs)

    def step(self, action: np.ndarray) -> tuple[np.ndarray, float, bool]:
        """``action``: the policy's float vector, a (1,) index for a discrete
        env or (A,) for a continuous one. With ``cfg.action_repeat`` k > 1
        the action is held for k env steps, rewards summed, stopping early
        at done: the policy's MDP is the wrapped env."""
        if self._continuous:
            env_action = np.asarray(action, np.float32).reshape(
                self._act_space.shape
            )
        else:
            env_action = int(np.asarray(action).reshape(-1)[0])
        total_rew, done = 0.0, False
        for _ in range(self.cfg.action_repeat):
            obs, rew, term, trunc, _info = self.env.step(env_action)
            total_rew += float(rew)
            if term or trunc:
                done = True
                break
        return self._preprocess(obs), total_rew, done

    def close(self) -> None:
        self.env.close()
