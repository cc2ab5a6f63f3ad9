"""Vectorized environments on the device for the colocated loop — the port
of ``tpu_rl.envs``: batched torch dynamics under the gymnasium ids the
distributed path uses, so the loop never imports gym."""

from tpu_rl_torch.envs.cartpole import CARTPOLE
from tpu_rl_torch.envs.core import EnvSpec, make_vec_env
from tpu_rl_torch.envs.pendulum import PENDULUM

SPECS: dict[str, EnvSpec] = {CARTPOLE.name: CARTPOLE, PENDULUM.name: PENDULUM}


def get_spec(name: str) -> EnvSpec:
    if name not in SPECS:
        raise ValueError(
            f"no device dynamics for env {name!r}; the colocated loop knows {sorted(SPECS)}"
        )
    return SPECS[name]


__all__ = ["CARTPOLE", "PENDULUM", "SPECS", "EnvSpec", "get_spec", "make_vec_env"]
