"""Data-parallel train steps on a rank mesh — the port of
``tpu_rl.parallel.dp``.

``tpu_rl`` jits the pure ``train_step(state, batch, key)`` with the batch
sharded over the mesh's ``"data"`` axis, and GSPMD inserts the gradient
all-reduce. In the port each rank calls the step on its own rows, and the
step itself was built with the mesh as its collective hook
(``get_algo(...).build(cfg, ..., mesh=mesh)``): the grads' mean over the
ranks before the clip, V-MPO's top-half selection over the global batch,
the update guard on the reduced grads (so every rank decides the same),
and noise drawn at the global shape and sliced by rank. This module wraps
such a step: the reported metrics become global numbers
(:meth:`~tpu_rl_torch.parallel.mesh.Mesh.reduce_metrics`), and
``chain=K`` runs K updates per call with ``tpu_rl``'s chained metrics
(summed ``nonfinite-updates``, accumulated ``diag``).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from tpu_rl_torch.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    Mesh,
    batch_sharding,
    check_divisible,
)
from tpu_rl_torch.types import BATCH_FIELDS, Batch
from tpu_rl_torch.utils.tree import tree_leaves


def _check_built_for(train_step: Callable, mesh: Mesh) -> None:
    sync = getattr(train_step, "sync", None)
    if sync is not mesh:
        raise ValueError(
            "the train step was not built with this mesh as its collective hook: build it "
            "with get_algo(cfg.algo).build(cfg, ..., mesh=mesh)"
        )


def make_parallel_train_step(
    train_step: Callable, mesh: Mesh, cfg=None, chain: int = 1
) -> Callable:
    """``pstep(state, batch, generator=None, **kw) -> (state, metrics)`` on
    this rank's rows of the global batch, with global metrics.

    ``chain > 1``: ``batch`` is a sequence of K per-update batches; the K
    updates run in a row (each draws from ``generator`` in turn, as K
    separate calls would), and the last update's metrics come back, with
    ``nonfinite-updates`` summed over the chain and ``diag`` accumulated
    (rows of every update in update-major, global row order; scalars
    summed; ``n-updates`` = K)."""
    if cfg is not None:
        check_divisible(cfg.batch_size, mesh)
    _check_built_for(train_step, mesh)

    def pstep(state, batch, generator: torch.Generator | None = None, **kw):
        if chain == 1:
            state, metrics = train_step(state, batch, generator, **kw)
            return state, mesh.reduce_metrics(metrics)
        if len(batch) != chain:
            raise ValueError(f"chained step wants {chain} batches, got {len(batch)}")
        ms = []
        for b in batch:
            state, m = train_step(state, b, generator, **kw)
            ms.append(m)
        diags = [m.pop("diag", None) for m in ms]
        out = dict(ms[-1])
        if "nonfinite-updates" in out:
            out["nonfinite-updates"] = torch.stack(
                [m["nonfinite-updates"] for m in ms]).sum(0)
        out = mesh.reduce_metrics(out)
        if diags[-1] is not None:
            rows = {k: torch.stack([d["rows"][k] for d in diags]) for k in diags[-1]["rows"]}
            scal = torch.stack([torch.stack([d["scalars"][k] for k in diags[-1]["scalars"]])
                                for d in diags]).sum(0) if diags[-1]["scalars"] else None
            red = mesh.reduce_metrics({"diag": {
                "rows": {k: v.T.contiguous() for k, v in rows.items()},  # (B_l, K)
                "scalars": ({k: scal[i] for i, k in enumerate(diags[-1]["scalars"])}
                            if scal is not None else {}),
            }})["diag"]
            out["diag"] = {
                # gathered (B_global, K) -> update-major (K * B_global,)
                "rows": {k: v.T.reshape(-1) for k, v in red["rows"].items()},
                "scalars": red["scalars"],
                "n-updates": torch.tensor(float(chain), device=out["loss"].device),
            }
        return state, out

    pstep.mesh = mesh
    return pstep


def make_sp_train_step(train_step: Callable, mesh: Mesh, cfg=None) -> Callable:
    """The train step over a 2-D (data, seq) mesh. Each rank takes the full
    windows of its data rows (:func:`shard_batch`); the transformer built
    on the mesh runs this rank's ``T / n_seq`` tokens, attends through
    ring or Ulysses attention over the seq group, and all-gathers its
    per-token outputs along the seq group before the loss (GAE and V-trace
    recurse over the whole window)."""
    if cfg is not None:
        if cfg.batch_size % mesh.shape[DATA_AXIS] != 0:
            raise ValueError("batch_size not divisible by data axis")
        if cfg.seq_len % mesh.shape[SEQ_AXIS] != 0:
            raise ValueError("seq_len not divisible by seq axis")
    return make_parallel_train_step(train_step, mesh)


def shard_batch(batch: Batch, mesh: Mesh) -> Batch:
    """This rank's rows of a global batch (every field's leading axis)."""
    rows = batch_sharding(mesh).of(batch.obs.shape[0])
    return Batch(**{f: getattr(batch, f)[rows] for f in BATCH_FIELDS})


def shard_chained_batch(batches: Sequence[Batch], mesh: Mesh) -> list[Batch]:
    """This rank's rows of each of K per-update global batches, in update
    order: the chained step's input."""
    return [shard_batch(b, mesh) for b in batches]


def replicate(tree: Any, mesh: Mesh, check: bool = True) -> Any:
    """Rank 0's values of every tensor in ``tree`` (a train state, a dict
    or a tensor) on every rank, in place; returns ``tree``. With ``check``
    it first verifies that every rank already holds rank 0's values (a
    seed-built init or a resume from the same checkpoint) and raises
    otherwise: replicas that disagree are a bug, not a state to paper
    over."""
    leaves = _state_leaves(tree)
    if mesh.world == 1 or not leaves:
        return tree
    mine = [t.detach().clone() for t in leaves]
    mesh.broadcast_(leaves)
    if check:
        bad = torch.tensor(
            [float(not all(torch.equal(a, b) for a, b in zip(mine, leaves)))], device=mesh.device
        )
        mesh.all_reduce_(bad)
        if float(bad) > 0:
            raise ValueError(
                f"replicate: {int(bad)} of {mesh.world} ranks held another state than rank 0 "
                "(a different seed or checkpoint)"
            )
    return tree


def _state_leaves(tree: Any) -> list[torch.Tensor]:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return tree_leaves(tree) if tree else []
    if hasattr(tree, "__dataclass_fields__"):
        out = []
        for name in tree.__dataclass_fields__:
            out += _state_leaves(getattr(tree, name))
        return out
    return []
