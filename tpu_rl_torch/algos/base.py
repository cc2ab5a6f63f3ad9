"""Train state and optimizer — the port of ``tpu_rl.algos.base``.

The optimizer is a functional RMSprop over the parameter dict, not
``torch.optim``: the train step computes the new params and state as
tensors, and the update guard then picks the new or the old ones with
``torch.where`` on the device, with no host read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from tpu_rl_torch.config import Config

Params = dict[str, dict[str, torch.Tensor]]


@dataclass
class TrainState:
    """State of the single-optimizer on-policy algorithms: the update count
    ``step`` (0-d int32 tensor), ``params`` ``{"actor": state_dict}`` and
    ``opt_state`` ``{"nu": ...}`` with one leaf per parameter (optax's
    ``ScaleByRmsState.nu``, leaf for leaf)."""

    step: torch.Tensor
    params: Params
    opt_state: dict[str, Any]

    def replace(self, **kw: Any) -> "TrainState":
        return dataclasses.replace(self, **kw)


class RMSprop:
    """RMSprop with torch's semantics (``RMSprop(lr, eps=1e-5)``, alpha
    0.99, epsilon outside the square root) as ``tpu_rl`` configures optax:

        nu = (1 - decay) * g^2 + decay * nu        (nu starts at 0)
        p  = p + (g / (sqrt(nu) + eps)) * -lr
    """

    decay = 0.99
    eps = 1e-5

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params: Params) -> dict[str, Any]:
        return {"nu": {k: {n: torch.zeros_like(p) for n, p in g.items()} for k, g in params.items()}}

    def apply(self, grads: Params, opt_state: dict[str, Any], params: Params):
        """-> (new params, new opt_state); the inputs are not modified."""
        d, eps, lr = self.decay, self.eps, self.lr
        new_nu, new_params = {}, {}
        for k, group in params.items():
            new_nu[k], new_params[k] = {}, {}
            for n, p in group.items():
                g = grads[k][n]
                nu = (1.0 - d) * torch.square(g) + d * opt_state["nu"][k][n]
                new_nu[k][n] = nu
                new_params[k][n] = p + (g / (torch.sqrt(nu) + eps)) * -lr
        return new_params, {"nu": new_nu}


def rmsprop(cfg: Config) -> RMSprop:
    return RMSprop(cfg.lr)


def make_train_state(cfg: Config, family, generator: torch.Generator | None = None) -> TrainState:
    """The initial state: the family's init drawn from ``generator`` (a CPU
    generator), zero ``nu``, step 0, all on the family's device."""
    params = family.init_params(generator)
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=family.device),
        params=params,
        opt_state=rmsprop(cfg).init(params),
    )
