"""Rank meshes for data- and sequence-parallel training on
``torch.distributed`` — the port of ``tpu_rl.parallel.mesh``.

``tpu_rl`` drives many devices from one process through a
``jax.sharding.Mesh``, and GSPMD inserts the collectives. The port runs one
process (rank) per device, the PyTorch idiom, and writes the collectives
out. A :class:`Mesh` holds the world size, this rank, its device, one
process group per named axis (``"data"``, and ``"seq"`` for a
sequence-parallel mesh) and the backend, with the few collectives the train
steps need:

- :meth:`Mesh.grads`: the grads' mean over every rank, in one flattened
  buffer per update, with any scalars (the loss, for the update guard)
  riding along;
- :meth:`Mesh.gather_rows`: an all-gather along the batch axis over the
  data group, in global row order (V-MPO's top-half selection, the ``diag``
  rows);
- :meth:`Mesh.reduce_metrics`: the reported metrics as global means
  (``min-*``/``max-*`` as global extrema);
- :meth:`Mesh.broadcast_`: rank 0's tensors on every rank.

**Backend rule.** ``nccl`` when every rank has a card of its own; ``gloo``
on the CPU, or when ranks share a card (NCCL refuses two ranks on one
device). Under gloo on a card the mesh stages every collective through host
memory (:attr:`Mesh.host_staging`): the copy is explicit, set only for that
case, and counted (:attr:`Mesh.staged_bytes`); it is never a fallback taken
after a failure.

**Rendezvous** goes through an explicit ``init_method`` (``tcp://host:port``
from :mod:`~tpu_rl_torch.parallel.multihost`, or ``file://`` in a run
directory); no fixed default port is ever assumed.

:class:`NoSync` is the identity the train steps take by default: a
single-device step never touches ``torch.distributed``.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SEQ_AXIS = "seq"

# Collectives wait at most this long: a learner rank may idle while storage
# has no batch for it.
TIMEOUT = datetime.timedelta(hours=2)


def backend_for(device: torch.device, ranks_share_card: bool) -> str:
    """The backend rule: ``nccl`` when every rank has a card of its own,
    else ``gloo`` (the CPU, or ranks that share a card)."""
    if device.type == "cuda" and not ranks_share_card:
        return "nccl"
    return "gloo"


def rank_device(
    local_rank: int, local_ranks: int, device: str | torch.device = "cuda", first: int = 0
) -> tuple[torch.device, bool]:
    """This rank's device, and whether the host's ``local_ranks`` ranks
    share cards (more ranks than cards: then every rank of the host
    decides the same, so they all pick gloo): of the cards from ``first``
    on (a sebulba learner group's, after its actor cards),
    ``cuda:first + local_rank`` on a host with a card per rank, else card
    ``first + local_rank % cards``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu"), False
    from tpu_rl_torch import resolve_device

    resolve_device("cuda")
    n = torch.cuda.device_count() - first
    return torch.device("cuda", first + local_rank % n), local_ranks > n


def init_process_group(
    init_method: str, world_size: int, rank: int, device: torch.device, ranks_share_card: bool
) -> str:
    """Join the process group (idempotent within a process) by the backend
    rule; prints the backend, returns it."""
    if dist.is_initialized():
        return dist.get_backend()
    backend = backend_for(device, ranks_share_card)
    _DEVICE[0] = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw: dict[str, Any] = {}
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank, timeout=TIMEOUT, **kw
    )
    print(
        f"[mesh] rank {rank}/{world_size} on {device}: backend {backend}"
        + (" (ranks share the card: collectives staged through host memory)"
           if ranks_share_card and device.type == "cuda" else ""),
        flush=True,
    )
    return backend


@dataclass
class Mesh:
    """One rank's view of a (data[, seq]) rank mesh; see the module doc."""

    world: int
    rank: int
    device: torch.device
    backend: str
    shape: dict[str, int]
    coords: dict[str, int]
    groups: dict[str, Any]
    host_staging: bool = False
    staged_bytes: int = 0

    # ------------------------------------------------------------ plumbing
    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def data_index(self) -> int:
        return self.coords[DATA_AXIS]

    @property
    def n_seq(self) -> int:
        return self.shape.get(SEQ_AXIS, 1)

    @property
    def seq_index(self) -> int:
        return self.coords.get(SEQ_AXIS, 0)

    def stage(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective takes: a host copy under
        :attr:`host_staging` (counted), else ``t`` itself."""
        if self.host_staging and t.is_cuda:
            self.staged_bytes += t.numel() * t.element_size()
            return t.detach().cpu()
        return t

    def unstage(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if self.host_staging and like.is_cuda:
            self.staged_bytes += t.numel() * t.element_size()
            return t.to(like.device)
        return t

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM, axis: str | None = None) -> torch.Tensor:
        """In-place all-reduce of ``t`` over ``axis``'s group (the world by
        default); returns ``t``."""
        s = self.stage(t)
        dist.all_reduce(s, op=op, group=self.groups.get(axis) if axis else None)
        if s is not t:
            t.copy_(self.unstage(s, t))
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """``t`` of every rank of ``axis``'s group concatenated along
        ``dim`` in the group's rank order (no gradient)."""
        n = self.shape[axis]
        if n == 1:
            return t
        s = self.stage(t.contiguous())
        parts = [torch.empty_like(s) for _ in range(n)]
        dist.all_gather(parts, s, group=self.groups[axis])
        return self.unstage(torch.cat(parts, dim=dim), t)

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
        """Rank ``src``'s values into ``tensors`` on every rank (of
        ``group``, the world by default; ``src`` is a world rank), one
        flattened buffer per dtype."""
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            s = self.stage(flat)
            dist.broadcast(s, src=src, group=group)
            flat = self.unstage(s, flat)
            off = 0
            for t in ts:
                n = t.numel()
                t.copy_(flat[off:off + n].view_as(t))
                off += n

    # ----------------------------------------------------- train-step hook
    def grads(self, tree, *scalars: torch.Tensor):
        """Mean over every rank of the grads in ``tree`` (a tensor or a dict
        of them) and of ``scalars``: one all-reduce of one flattened
        buffer. Returns ``(tree, *scalars)``. Under sequence parallelism
        each seq rank holds ``n_seq`` times its own tokens' contribution
        (the outputs' all-gather sums its cotangents), so the world mean is
        the data-parallel mean."""
        from tpu_rl_torch.utils.tree import tree_leaves, tree_map

        leaves = tree_leaves(tree)
        flat = torch.cat([x.reshape(-1).float() for x in leaves]
                         + [s.reshape(1).float() for s in scalars])
        self.all_reduce_(flat)
        flat = flat / self.world
        it = iter(range(len(leaves)))
        offs = [0]
        for x in leaves:
            offs.append(offs[-1] + x.numel())

        def take(x):
            i = next(it)
            return flat[offs[i]:offs[i + 1]].view_as(x).to(x.dtype)

        out = tree_map(take, tree)
        rest = flat[offs[-1]:]
        return (out, *(rest[i].to(s.dtype) for i, s in enumerate(scalars)))

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (batch-leading) of every data rank, in global row order."""
        return self.all_gather(t, DATA_AXIS, dim=0)

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch axis of ``n_local * n_data``."""
        return slice(self.data_index * n_local, (self.data_index + 1) * n_local)

    def reduce_metrics(self, metrics: dict) -> dict:
        """The step's metrics as global numbers: ``min-*``/``max-*`` as
        extrema, every other scalar as the mean over ranks (the loss terms
        are per-rank means over equal shards), the ``diag`` rows gathered in
        global row order and its scalars averaged. One all-reduce per kind
        of reduction."""
        out = dict(metrics)
        diag = out.pop("diag", None)
        means = {k: v for k, v in out.items() if torch.is_tensor(v)
                 and not k.startswith(("min-", "max-"))}
        exts = {k: v for k, v in out.items() if torch.is_tensor(v)
                and k.startswith(("min-", "max-"))}
        if diag is not None:
            means.update({("diag", k): v for k, v in diag["scalars"].items()})
        if means:
            vals = list(means.values())
            flat = torch.stack([v.reshape(()).float() for v in vals])
            self.all_reduce_(flat)
            flat = flat / self.world
            for i, (k, v) in enumerate(means.items()):
                means[k] = flat[i].to(v.dtype)
        if exts:
            # one MAX over [max-*, -min-*]
            flat = torch.stack([(v if k.startswith("max-") else -v).reshape(()).float()
                                for k, v in exts.items()])
            self.all_reduce_(flat, op=dist.ReduceOp.MAX)
            for i, (k, v) in enumerate(exts.items()):
                exts[k] = (flat[i] if k.startswith("max-") else -flat[i]).to(v.dtype)
        for k, v in {**means, **exts}.items():
            if not isinstance(k, tuple):
                out[k] = v
        if diag is not None:
            out["diag"] = {
                "rows": {k: self.gather_rows(v) for k, v in diag["rows"].items()},
                "scalars": {k: means[("diag", k)] for k in diag["scalars"]},
                **{k: v for k, v in diag.items() if k not in ("rows", "scalars")},
            }
        return out


def publish_mesh(reg, mesh: Mesh) -> None:
    """The mesh's telemetry fields on a metrics registry: ``mesh-world``,
    ``mesh-backend`` (1, labelled with the backend) and this rank's
    host-staged bytes."""
    reg.gauge("mesh-world").set(mesh.world)
    reg.gauge("mesh-backend", {"backend": mesh.backend}).set(1.0)
    reg.counter("mesh-staged-bytes").set_total(mesh.staged_bytes)


class NoSync:
    """The single-device identity of :class:`Mesh`'s train-step hook: a step
    built with it is the plain step."""

    world = 1
    n_data = 1
    data_index = 0
    n_seq = 1
    seq_index = 0

    def grads(self, tree, *scalars):
        return (tree, *scalars)

    def gather_rows(self, t):
        return t

    def rows(self, n_local: int) -> slice:
        return slice(0, n_local)

    def reduce_metrics(self, metrics: dict) -> dict:
        return metrics


NO_SYNC = NoSync()


def _world() -> tuple[int, int]:
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


# The device this process joined the group with (init_process_group sets
# it); the CPU until then.
_DEVICE = [torch.device("cpu")]


def _build(shape: dict[str, int], device: torch.device | None) -> Mesh:
    world, rank = _world()
    need = 1
    for n in shape.values():
        if n < 1:
            raise ValueError(f"mesh size must be >= 1, got {shape}")
        need *= n
    if need != world:
        raise ValueError(
            f"mesh {shape} needs {need} ranks, the world has {world} (one rank per device)"
        )
    dev = torch.device(device) if device is not None else _DEVICE[0]
    backend = dist.get_backend() if dist.is_initialized() else "none"
    n_seq = shape.get(SEQ_AXIS, 1)
    coords = {DATA_AXIS: rank // n_seq}
    groups: dict[str, Any] = {}
    if dist.is_initialized():
        # every rank creates every group, in the same order
        if SEQ_AXIS in shape:
            coords[SEQ_AXIS] = rank % n_seq
            for d in range(shape[DATA_AXIS]):
                g = dist.new_group([d * n_seq + s for s in range(n_seq)])
                if d == coords[DATA_AXIS]:
                    groups[SEQ_AXIS] = g
            for s in range(n_seq):
                g = dist.new_group([d * n_seq + s for d in range(shape[DATA_AXIS])])
                if s == coords[SEQ_AXIS]:
                    groups[DATA_AXIS] = g
        else:
            groups[DATA_AXIS] = None  # the world group
    elif SEQ_AXIS in shape:
        coords[SEQ_AXIS] = 0
    return Mesh(
        world=world, rank=rank, device=dev, backend=backend, shape=dict(shape),
        coords=coords, groups=groups,
        host_staging=backend == "gloo" and dev.type == "cuda",
    )


def make_mesh(n_data: int | None = None, device: str | torch.device | None = None) -> Mesh:
    """1-D data-parallel mesh over every rank of the joined process group
    (``n_data`` must equal its world size: one rank per device). Without a
    process group, a one-rank mesh."""
    world, _ = _world()
    n = world if n_data is None else int(n_data)
    if n < 1:
        raise ValueError(f"mesh size must be >= 1, got {n}")
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} ranks joined")
    return _build({DATA_AXIS: n}, device)


def make_sp_mesh(n_data: int, n_seq: int, device: str | torch.device | None = None) -> Mesh:
    """2-D (data, seq) mesh, seq minor: rank ``r`` is data index
    ``r // n_seq`` and seq index ``r % n_seq``, so a ring's hops are
    between neighbouring ranks."""
    world, _ = _world()
    if n_data * n_seq > world:
        raise ValueError(f"need {n_data * n_seq} devices, have {world}")
    return _build({DATA_AXIS: int(n_data), SEQ_AXIS: int(n_seq)}, device)


@dataclass(frozen=True)
class RowShard:
    """A row-slice descriptor: block ``index`` of ``count`` equal blocks of
    a batch axis."""

    index: int
    count: int

    def of(self, n_global: int) -> slice:
        if n_global % self.count:
            raise ValueError(f"{n_global} rows do not split into {self.count} equal blocks")
        n = n_global // self.count
        return slice(self.index * n, (self.index + 1) * n)


def batch_sharding(mesh: Mesh) -> RowShard:
    """This rank's block of the leading (batch) dimension."""
    return RowShard(mesh.data_index, mesh.n_data)


def replicated(mesh: Mesh) -> RowShard:
    """Every row on every rank."""
    return RowShard(0, 1)


def check_divisible(batch_size: int, mesh: Mesh) -> None:
    n = mesh.shape[DATA_AXIS]
    if batch_size % n != 0:
        raise ValueError(
            f"batch_size={batch_size} not divisible by mesh data axis ({n})"
        )
