"""Nested-dict parameter trees: the few ``jax.tree_util`` helpers the train
steps need, over dicts of tensors (insertion order is the leaf order)."""

from __future__ import annotations

from typing import Any, Callable

import torch

Tree = Any  # a tensor, or a dict of trees


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf over ``tree`` and trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def value_and_grad(fn: Callable, params: Tree, *args: Any):
    """``jax.value_and_grad(fn, has_aux=True)``: ``fn(params, *args)`` returns
    ``(loss, aux)``; returns ``(loss, aux, grads)`` with ``grads`` in
    ``params``' structure (zeros for a leaf the loss does not reach). The
    loss is detached; ``fn`` sees leaves that require grad."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, aux = fn(leaves, *args)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p) for g, p in zip(grads, flat))
    return loss.detach(), aux, tree_map(lambda _: next(it), leaves)
