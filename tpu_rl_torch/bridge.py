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
- A quantized ``tpu_rl`` tree (``tpu_rl.models.quant``) carries across: an
  int8 leaf ``{"q8", "scale"}`` stays such a dict, its ``q8`` transposed
  exactly as its f32 leaf would be (a Dense ``kernel``) or not (any other
  leaf), its per-tensor ``scale`` as it is; a bfloat16 leaf becomes a
  bfloat16 tensor bit for bit. Back to flax, a bfloat16 tensor comes out
  widened to float32 (exactly; numpy has no bfloat16).
- The flax collection ``params`` is the top of the tree. LSTM:
  ``params/body`` -> ``body.*``, ``params/cell/x_proj`` -> ``cell.x_proj.*``,
  ``params/cell/recurrent_kernel`` -> ``cell.recurrent_kernel``,
  ``params/logits`` -> ``logits.*``, ``params/value`` -> ``value.*``.
  Transformer: ``params/embed``, ``params/block{i}/attn/{qkv,out}``,
  ``params/block{i}/{ln1,ln2,ff1,ff2}``, ``params/ln_f``, ``params/logits``
  and ``params/value``, each to the same dotted path.

:func:`train_state_from_flax` carries a whole ``tpu_rl`` ``TrainState``
(step, params, optax RMSprop state; V-MPO's duals) of either family into the
port's :class:`~tpu_rl_torch.algos.base.TrainState`, and
:func:`sac_state_from_flax` a ``SACState`` (actor, twin and target critics,
``log_alpha``, three optax Adam states) into the port's
:class:`~tpu_rl_torch.algos.base.SACState`. The SAC critics' flax paths
``params/q1/...`` and ``params/q2/...`` become ``q1.*`` and ``q2.*``; the
continuous critic's ``obs_body``, ``act_body``, ``cell`` and ``q``, and the
Gaussian heads ``mu``, ``std`` and ``log_std``, map like any Dense.
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


def _is_q8(node: Any) -> bool:
    return isinstance(node, Mapping) and set(node) == {"q8", "scale"}


def _tensor(leaf: Any, transpose: bool = False):
    """A flax leaf -> a CPU tensor (a bfloat16 array bit for bit), or an int8
    leaf -> ``{"q8", "scale"}`` of tensors; ``transpose`` turns a Dense
    kernel (or its ``q8``) into a Linear weight."""
    if _is_q8(leaf):
        return {"q8": _tensor(leaf["q8"], transpose), "scale": _tensor(leaf["scale"])}
    arr = np.asarray(leaf)
    if transpose:
        arr = arr.T
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.tensor(arr)


def _array(value: Any, transpose: bool = False):
    """Inverse of :func:`_tensor`; a bfloat16 tensor is widened to float32."""
    if isinstance(value, Mapping):
        return {"q8": _array(value["q8"], transpose), "scale": _array(value["scale"])}
    value = value.detach().cpu()
    arr = (value.float() if value.dtype == torch.bfloat16 else value).numpy()
    return np.ascontiguousarray(arr.T) if transpose else arr.copy()


def flax_to_state_dict(actor_tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``{"params": {...}}`` (numpy leaves) -> ``state_dict`` of CPU tensors."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name, child in node.items():
            path = f"{prefix}{name}"
            if _is_dense(child):
                out[f"{path}.weight"] = _tensor(child["kernel"], transpose=True)
                out[f"{path}.bias"] = _tensor(child["bias"])
            elif _is_layer_norm(child):
                out[f"{path}.weight"] = _tensor(child["scale"])
                out[f"{path}.bias"] = _tensor(child["bias"])
            elif isinstance(child, Mapping) and not _is_q8(child):
                walk(child, f"{path}.")
            else:
                out[path] = _tensor(child)

    walk(actor_tree["params"], "")
    return out


def state_dict_to_flax(state_dict: dict[str, torch.Tensor]) -> dict[str, Any]:
    """Inverse of :func:`flax_to_state_dict`: -> ``{"params": {...}}`` with
    numpy leaves."""
    root: dict[str, Any] = {}
    for key, value in state_dict.items():
        *parents, leaf = key.split(".")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        ndim = (value["q8"] if isinstance(value, Mapping) else value).dim()
        if leaf == "weight" and ndim == 1:  # a LayerNorm scale
            node["scale"] = _array(value)
        elif leaf == "weight":
            node["kernel"] = _array(value, transpose=True)
        else:  # a bias, or a leaf kept as it is (recurrent_kernel)
            node[leaf] = _array(value)
    return {"params": root}


def _duals(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """V-MPO's top-level 0-d ``log_eta``/``log_alpha`` leaves -> the port's
    ``duals`` group."""
    return {k: torch.tensor(np.asarray(tree[k])) for k in ("log_eta", "log_alpha")}


def train_state_from_flax(state: Any):
    """A ``tpu_rl`` ``TrainState`` with numpy leaves (``jax.device_get``)
    -> the port's ``TrainState`` on the CPU. ``params["actor"]`` and optax's
    RMSprop ``nu`` tree go through the same mapping (a Dense kernel's ``nu``
    is transposed like the kernel, a LayerNorm scale's is not); V-MPO's
    ``log_eta``/``log_alpha`` and their ``nu`` go to the ``duals`` group;
    ``step`` is copied."""
    from tpu_rl_torch.algos.base import TrainState

    nu = next(s.nu for s in state.opt_state if hasattr(s, "nu"))
    params = {"actor": flax_to_state_dict(state.params["actor"])}
    nu_tree = {"actor": flax_to_state_dict(nu["actor"])}
    if "log_eta" in state.params:
        params["duals"], nu_tree["duals"] = _duals(state.params), _duals(nu)
    return TrainState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
        params=params,
        opt_state={"nu": nu_tree},
    )


def _adam_from_optax(opt_state: Any, to_tree) -> dict[str, Any]:
    """optax's ``adam`` state (a chain whose ``ScaleByAdamState`` holds
    ``count``, ``mu``, ``nu``) -> the port's ``{"mu", "nu", "count"}``, the
    moments mapped by ``to_tree`` like their parameters."""
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    return {
        "mu": to_tree(adam.mu),
        "nu": to_tree(adam.nu),
        "count": torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32),
    }


def sac_state_from_flax(state: Any):
    """A ``tpu_rl`` ``SACState`` with numpy leaves -> the port's
    ``SACState`` on the CPU: the actor, the twin critic (``q1.*``/``q2.*``)
    and the target critic as state_dicts, ``log_alpha``, and the three Adam
    states (moments transposed like their kernels)."""
    from tpu_rl_torch.algos.base import SACState

    def scalar(x):
        return torch.tensor(np.asarray(x))

    return SACState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
        actor_params=flax_to_state_dict(state.actor_params),
        critic_params=flax_to_state_dict(state.critic_params),
        target_critic_params=flax_to_state_dict(state.target_critic_params),
        log_alpha=scalar(state.log_alpha),
        actor_opt=_adam_from_optax(state.actor_opt, flax_to_state_dict),
        critic_opt=_adam_from_optax(state.critic_opt, flax_to_state_dict),
        alpha_opt=_adam_from_optax(state.alpha_opt, scalar),
    )
