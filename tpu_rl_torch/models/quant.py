"""Serving precision of the actor params and the act-step dispatch — the
port of ``tpu_rl.models.quant``.

The learner keeps f32 params; :func:`quantize_tree` casts one copy to
``Config.inference_dtype`` when the inference service takes the params,
and the act step widens them back (:func:`dequantize_tree`) before it runs:

- ``"f32"``: identity.
- ``"bf16"``: every float leaf cast to bfloat16; the step widens to f32,
  so the math runs at full precision on rounded weights.
- ``"int8"``: per-tensor symmetric quantization of every float leaf of 2-D
  or more (the products' weights; biases and other vectors stay f32):
  ``scale = max(max|w|, 1e-12) / 127``, ``q = clip(round(w / scale), -127,
  127)`` (round half to even, as ``jnp.round``), stored as a
  ``{"q8": int8, "scale": f32}`` leaf.

A tree is nested dicts of tensors (``{"actor": state_dict}``), so a weight
keeps the port's layout: a Linear's ``weight`` is (out, in), ``tpu_rl``'s
``kernel`` (in, out). The per-tensor scale does not change under the
transpose, and :mod:`tpu_rl_torch.bridge` carries a ``q8`` leaf across with
the transpose of its f32 leaf. The quantized tree is one ordinary tree: the
service's swap stays one reference assignment.

:func:`make_act_fn` resolves ``Config.act_kernel`` to the act callable the
service runs.
"""

from __future__ import annotations

import re
from typing import Any, Callable

import torch

QUANT_MODES = ("f32", "bf16", "int8")

# Keys of an int8 leaf. A dict with exactly these keys IS a quantized tensor.
_Q8_KEYS = frozenset({"q8", "scale"})


def is_q8_leaf(node: Any) -> bool:
    return isinstance(node, dict) and frozenset(node.keys()) == _Q8_KEYS


def _tree_map(fn: Callable, tree: Any, q8_leaves: bool = True) -> Any:
    """``fn`` over the leaves of nested dicts; a ``{"q8", "scale"}`` dict is
    one leaf when ``q8_leaves``, else its two tensors are."""
    if isinstance(tree, dict) and not (q8_leaves and is_q8_leaf(tree)):
        return {k: _tree_map(fn, v, q8_leaves) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree: Any, prefix: str = "", q8_leaves: bool = True):
    """(dotted path, leaf) pairs in dict order."""
    if isinstance(tree, dict) and not (q8_leaves and is_q8_leaf(tree)):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.", q8_leaves)
    else:
        yield prefix[:-1], tree


def _is_float(leaf: Any) -> bool:
    return torch.is_tensor(leaf) and leaf.is_floating_point()


def quantize_tree(tree: Any, mode: str) -> Any:
    """Cast a parameter tree to the serving precision. Idempotent: leaves
    already in the target representation pass through, so a re-applied swap
    never scales twice."""
    assert mode in QUANT_MODES, mode
    if mode == "f32":
        return tree
    if mode == "bf16":
        # tpu_rl's tree_map walks into a {"q8", "scale"} dict here: its scale
        # is cast too
        return _tree_map(
            lambda leaf: leaf.to(torch.bfloat16) if _is_float(leaf) else leaf, tree,
            q8_leaves=False,
        )

    def quant(leaf):
        if is_q8_leaf(leaf) or not _is_float(leaf) or leaf.dim() < 2:
            # biases, vectors and scalars: a few bytes each, and symmetric
            # int8 would cost them real accuracy; they stay f32
            return leaf
        w = leaf.float()
        # the floor keeps an all-zero tensor from dividing by 0
        scale = torch.clamp(w.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        return {"q8": q, "scale": scale}

    return _tree_map(quant, tree)


def dequantize_tree(tree: Any) -> Any:
    """The inverse cast, run inside the act step: an int8 leaf becomes
    ``q8 * scale``, a bf16 leaf is widened to f32."""

    def dequant(leaf):
        if is_q8_leaf(leaf):
            return leaf["q8"].float() * leaf["scale"]
        if torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16:
            return leaf.float()
        return leaf

    return _tree_map(dequant, tree)


def _dtype_name(leaf: Any) -> str:
    dtype = getattr(leaf, "dtype", None)
    return type(leaf).__name__ if dtype is None else str(dtype).removeprefix("torch.")


def quant_spec(tree: Any) -> dict[str, tuple[str, tuple[int, ...]]]:
    """Per-tensor serving map ``{"actor.cell.x_proj.weight": ("int8",
    (256, 64)), ...}`` in the port's names and layouts, a numeric path
    component wildcarded to ``*`` as in ``tpu_rl``. Debug and
    observability only."""
    out: dict[str, tuple[str, tuple[int, ...]]] = {}
    for path, leaf in _leaves(tree):
        name = ".".join(re.sub(r"^\d+$", "*", part) for part in path.split("."))
        if is_q8_leaf(leaf):
            out[name] = ("int8", tuple(leaf["q8"].shape))
        else:
            out[name] = (_dtype_name(leaf), tuple(getattr(leaf, "shape", ())))
    return out


def tree_bytes(tree: Any) -> int:
    """Bytes of the parameters the act step reads per dispatch (metadata
    only, no device sync)."""
    return int(sum(
        leaf.numel() * leaf.element_size()
        for _path, leaf in _leaves(tree, q8_leaves=False) if torch.is_tensor(leaf)
    ))


# ------------------------------------------------------- act-step dispatch
def make_act_fn(cfg, family):
    """Resolve ``Config.act_kernel`` to the act callable serving consumers
    run. ``"xla"`` -> ``family.act`` (the unfused module forward);
    ``"pallas"`` -> the fused act kernel (:mod:`tpu_rl_torch.ops.fused_act`),
    which raises for a family out of its scope. The name ``"pallas"`` is
    kept so ``tpu_rl`` params files load."""
    if cfg.act_kernel != "pallas":
        return family.act
    from tpu_rl_torch.ops.fused_act import make_fused_act

    return make_fused_act(family)
