"""Algorithm registry — the port of ``tpu_rl.algos.registry`` (PPO so far)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from tpu_rl_torch.algos import ppo
from tpu_rl_torch.algos.base import make_train_state
from tpu_rl_torch.config import Config
from tpu_rl_torch.models.families import build_family

# tpu_rl's other algorithms; each comes with the other-algorithms slice.
_LATER = ("PPO-Continuous", "IMPALA", "V-MPO", "SAC", "SAC-Continuous")


@dataclass(frozen=True)
class AlgoSpec:
    name: str
    on_policy: bool
    make_train_step: Callable

    def build(
        self,
        cfg: Config,
        generator: torch.Generator | None = None,
        device: str | torch.device | None = "cuda",
    ):
        """Returns (family, initial state, train_step) on ``device`` (CUDA
        unless the caller passes ``device="cpu"``); the initial weights are
        drawn from ``generator`` (a CPU generator)."""
        family = build_family(cfg, device=device)
        state = make_train_state(cfg, family, generator)
        return family, state, self.make_train_step(cfg, family)


_REGISTRY: dict[str, AlgoSpec] = {"PPO": AlgoSpec("PPO", True, ppo.make_train_step)}


def get_algo(name: str) -> AlgoSpec:
    if name in _LATER:
        raise NotImplementedError(
            f"algo={name!r}: comes with the other-algorithms slice of the port"
        )
    if name not in _REGISTRY:
        raise ValueError(f"unknown algo {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
