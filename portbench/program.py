"""The system under test: the port's train step for one configuration on
one card, through its normal entry (``get_algo(algo).build``), started
from the harness's weights. The harness reads from it only what a learner's user
could: each update's reported loss, its optimizer state and its
parameters.

A fault can be planted for the tests and for the calibration of the check
(``FAULTS``); the benchmark's runs plant none.
"""

from __future__ import annotations

import torch

FAULTS = (
    "unchanged",  # every update returns the state it was given
    "half_batch",  # every update sees the first half of its rows only
)


class Program:
    def __init__(self, cfg: dict, weights: dict, device, fault: str | None = None):
        from tpu_rl_torch.algos.registry import get_algo
        from tpu_rl_torch.config import Config

        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault {fault!r}, want one of {FAULTS}")
        self.cfg = Config.from_dict(cfg)
        _family, state, step = get_algo(self.cfg.algo).build(
            self.cfg, torch.Generator().manual_seed(0), device=device)
        theirs = {k: tuple(v.shape) for k, v in state.params["actor"].items()}
        ours = {k: tuple(v.shape) for k, v in weights.items()}
        if theirs != ours:
            raise ValueError(f"the program's parameters {theirs} are not the reference's {ours}")
        self.state = state.replace(params={"actor": {k: v.clone() for k, v in weights.items()}})
        self.step = step
        self.fault = fault

    def batch(self, fields: dict):
        from tpu_rl_torch.types import Batch

        if self.fault == "half_batch":
            fields = {k: v[: v.shape[0] // 2] for k, v in fields.items()}
        return Batch(**fields)

    def update(self, batch) -> dict:
        state, metrics = self.step(self.state, batch)
        if self.fault != "unchanged":
            self.state = state
        return metrics

    def params(self) -> dict[str, torch.Tensor]:
        return self.state.params["actor"]

    def first_grad_norms(self, decay: float = 0.99) -> dict[str, float]:
        """Leaf by leaf, the norm of the gradient the optimizer got in the
        first update, from its state after it: RMSprop's ``nu`` starts at 0,
        so after one update it holds ``(1 - decay) * g**2``."""
        nu = self.state.opt_state["nu"]["actor"]
        return {k: float(torch.sqrt(v.double().sum() / (1.0 - decay))) for k, v in nu.items()}
