"""Weight bridge between ``tpu_rl``'s flax parameter trees and the port's
``state_dict``s, both sides as plain arrays (numpy in, torch CPU tensors out,
and back), so neither package imports the other.

- A flax ``Dense`` (a dict holding ``kernel (in, out)`` and ``bias``) becomes
  ``<path>.weight (out, in)`` — transposed — and ``<path>.bias``.
- A flax ``LayerNorm`` (``scale (C,)`` and ``bias``) becomes
  ``<path>.weight`` and ``<path>.bias``, untransposed. Back from a
  state_dict the two are told apart by ``ndim``: a 1-D ``.weight`` is a
  LayerNorm ``scale``, a 2-D one a Dense ``kernel``.
- Any other leaf (``cell/recurrent_kernel (H, 4H)``) is copied as it is.
- The flax collection ``params`` is the top of the tree. LSTM:
  ``params/body`` -> ``body.*``, ``params/cell/x_proj`` -> ``cell.x_proj.*``,
  ``params/cell/recurrent_kernel`` -> ``cell.recurrent_kernel``,
  ``params/logits`` -> ``logits.*``, ``params/value`` -> ``value.*``.
  Transformer: ``params/embed``, ``params/block{i}/attn/{qkv,out}``,
  ``params/block{i}/{ln1,ln2,ff1,ff2}``, ``params/ln_f``, ``params/logits``
  and ``params/value``, each to the same dotted path.

:func:`train_state_from_flax` carries a whole ``tpu_rl`` ``TrainState``
(step, params, optax RMSprop state) of either family into the port's
:class:`~tpu_rl_torch.algos.base.TrainState`.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch


def _is_dense(node: Any) -> bool:
    return isinstance(node, Mapping) and set(node) == {"kernel", "bias"}


def _is_layer_norm(node: Any) -> bool:
    return isinstance(node, Mapping) and set(node) == {"scale", "bias"}


def flax_to_state_dict(actor_tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``{"params": {...}}`` (numpy leaves) -> ``state_dict`` of CPU tensors."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name, child in node.items():
            path = f"{prefix}{name}"
            if _is_dense(child):
                out[f"{path}.weight"] = torch.tensor(np.asarray(child["kernel"]).T)
                out[f"{path}.bias"] = torch.tensor(np.asarray(child["bias"]))
            elif _is_layer_norm(child):
                out[f"{path}.weight"] = torch.tensor(np.asarray(child["scale"]))
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
        if leaf == "weight" and arr.ndim == 1:  # a LayerNorm scale
            node["scale"] = arr.copy()
        elif leaf == "weight":
            node["kernel"] = np.ascontiguousarray(arr.T)
        else:  # a bias, or a leaf kept as it is (recurrent_kernel)
            node[leaf] = arr.copy()
    return {"params": root}


def train_state_from_flax(state: Any):
    """A ``tpu_rl`` ``TrainState`` with numpy leaves (``jax.device_get``)
    -> the port's ``TrainState`` on the CPU. ``params["actor"]`` and optax's
    RMSprop ``nu`` tree go through the same mapping (a Dense kernel's ``nu``
    is transposed like the kernel, a LayerNorm scale's is not); ``step`` is
    copied."""
    from tpu_rl_torch.algos.base import TrainState

    nu = next(s.nu for s in state.opt_state if hasattr(s, "nu"))
    return TrainState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
        params={"actor": flax_to_state_dict(state.params["actor"])},
        opt_state={"nu": {"actor": flax_to_state_dict(nu["actor"])}},
    )
