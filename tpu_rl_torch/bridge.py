"""Weight bridge between ``tpu_rl``'s flax parameter trees and the port's
``state_dict``s, both sides as plain arrays (numpy in, torch CPU tensors out,
and back), so neither package imports the other.

- A flax ``Dense`` (a dict holding ``kernel (in, out)`` and ``bias``) becomes
  ``<path>.weight (out, in)`` — transposed — and ``<path>.bias``.
- Any other leaf (``cell/recurrent_kernel (H, 4H)``) is copied as it is.
- The flax collection ``params`` is the top of the tree:
  ``params/body`` -> ``body.*``, ``params/cell/x_proj`` -> ``cell.x_proj.*``,
  ``params/cell/recurrent_kernel`` -> ``cell.recurrent_kernel``,
  ``params/logits`` -> ``logits.*``, ``params/value`` -> ``value.*``.

:func:`train_state_from_flax` carries a whole ``tpu_rl`` ``TrainState``
(step, params, optax RMSprop state) into the port's
:class:`~tpu_rl_torch.algos.base.TrainState`.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch


def _is_dense(node: Any) -> bool:
    return isinstance(node, Mapping) and set(node) == {"kernel", "bias"}


def flax_to_state_dict(actor_tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``{"params": {...}}`` (numpy leaves) -> ``state_dict`` of CPU tensors."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name, child in node.items():
            path = f"{prefix}{name}"
            if _is_dense(child):
                out[f"{path}.weight"] = torch.tensor(np.asarray(child["kernel"]).T)
                out[f"{path}.bias"] = torch.tensor(np.asarray(child["bias"]))
            elif isinstance(child, Mapping):
                walk(child, f"{path}.")
            else:
                out[path] = torch.tensor(np.asarray(child))

    walk(actor_tree["params"], "")
    return out


def state_dict_to_flax(state_dict: dict[str, torch.Tensor]) -> dict[str, Any]:
    """Inverse of :func:`flax_to_state_dict`: -> ``{"params": {...}}`` with
    numpy leaves."""
    root: dict[str, Any] = {}
    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy()
        *parents, leaf = key.split(".")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        if leaf == "weight":
            node["kernel"] = np.ascontiguousarray(arr.T)
        else:  # a Dense bias, or a leaf kept as it is (recurrent_kernel)
            node[leaf] = arr.copy()
    return {"params": root}


def train_state_from_flax(state: Any):
    """A ``tpu_rl`` ``TrainState`` with numpy leaves (``jax.device_get``)
    -> the port's ``TrainState`` on the CPU. ``params["actor"]`` and optax's
    RMSprop ``nu`` tree go through the same mapping (a Dense kernel's ``nu``
    is transposed like the kernel); ``step`` is copied."""
    from tpu_rl_torch.algos.base import TrainState

    nu = next(s.nu for s in state.opt_state if hasattr(s, "nu"))
    return TrainState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
        params={"actor": flax_to_state_dict(state.params["actor"])},
        opt_state={"nu": {"actor": flax_to_state_dict(nu["actor"])}},
    )
