"""Algorithm registry — the port of ``tpu_rl.algos.registry``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from tpu_rl_torch.algos import impala, ppo, sac, vmpo
from tpu_rl_torch.algos.base import make_train_state
from tpu_rl_torch.config import Config, is_off_policy
from tpu_rl_torch.models.families import ALGOS, build_family
from tpu_rl_torch.parallel.mesh import NO_SYNC


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
        mesh=None,
    ):
        """Returns (family, initial state, train_step) on ``device`` (CUDA
        unless the caller passes ``device="cpu"``); the initial weights are
        drawn from ``generator`` (a CPU generator). ``train_step(state,
        batch, generator=None, ...)`` draws what it samples from
        ``generator`` (a generator on ``device``), or takes that noise as
        an argument (V-MPO's ``coef_alpha_u``, SAC-Continuous's ``noise``).

        With ``mesh`` (a :class:`~tpu_rl_torch.parallel.mesh.Mesh`) the
        train step takes it as its collective hook, and a sequence-parallel
        transformer attends over its seq group; wrap the step with
        :func:`~tpu_rl_torch.parallel.dp.make_parallel_train_step`."""
        family = build_family(cfg, device=device, mesh=mesh)
        state = make_train_state(cfg, family, generator)
        return family, state, self.make_train_step(cfg, family, sync=mesh or NO_SYNC)


_REGISTRY: dict[str, AlgoSpec] = {
    "PPO": AlgoSpec("PPO", True, ppo.make_train_step),
    "PPO-Continuous": AlgoSpec("PPO-Continuous", True, ppo.make_train_step),
    "IMPALA": AlgoSpec("IMPALA", True, impala.make_train_step),
    "V-MPO": AlgoSpec("V-MPO", True, vmpo.make_train_step),
    "SAC": AlgoSpec("SAC", False, sac.make_train_step),
    "SAC-Continuous": AlgoSpec("SAC-Continuous", False, sac.make_train_step),
}

assert set(_REGISTRY) == set(ALGOS)
assert all(spec.on_policy != is_off_policy(name) for name, spec in _REGISTRY.items())


def get_algo(name: str) -> AlgoSpec:
    if name not in _REGISTRY:
        raise ValueError(f"unknown algo {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
