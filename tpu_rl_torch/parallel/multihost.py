"""Multi-host learner initialization on ``torch.distributed`` — the port of
``tpu_rl.parallel.multihost``.

``tpu_rl`` brings every host into the JAX distributed runtime, after which
one process per host drives every device of its host. The port runs one
process (rank) per device, so a host contributes one rank per card (the
role spawns them, :func:`~tpu_rl_torch.runtime.runner._host_ranks`) and
the global rank is ``process_id * local_ranks + local_rank``, the host's
share read from ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` as the role's rank
group (or ``torchrun``) sets them. The params file keeps ``tpu_rl``'s
shape, and only its keys:

    {"multihost": {"coordinator": "10.0.0.1:8476",
                   "num_processes": 4, "process_id": <host idx>}}

and :func:`init_multihost` joins the process group at
``tcp://<coordinator>`` (the coordinator's rank-0 store listens there).

Host-sharded feeding: each rank keeps its own rows of the global batch
(:func:`host_local_batch_to_global`), with ``tpu_rl``'s coverage assert.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from tpu_rl_torch.parallel.mesh import RowShard, init_process_group, rank_device

_INITIALIZED = False


def host_rank() -> tuple[int, int]:
    """This process's ``(local_rank, local_ranks)`` on its host, from
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``; ``(0, 1)`` for a process
    started alone."""
    return int(os.environ.get("LOCAL_RANK", 0)), int(os.environ.get("LOCAL_WORLD_SIZE", 1))


def init_multihost(
    coordinator: str,
    num_processes: int,
    process_id: int,
    device: str | torch.device = "cuda",
) -> str | None:
    """Join the process group of ``num_processes`` hosts through
    ``tcp://{coordinator}``, each host contributing its :func:`host_rank`
    ranks. No-op (returns None) when there is one host with one rank, and
    idempotent within a process (roles construct their loop objects more
    than once in tests). Returns the backend."""
    global _INITIALIZED
    local_rank, local_ranks = host_rank()
    world = int(num_processes) * local_ranks
    if world <= 1:
        return None
    if _INITIALIZED or dist.is_initialized():
        _INITIALIZED = True
        return dist.get_backend()
    dev, share = rank_device(local_rank, local_ranks, device)
    backend = init_process_group(
        f"tcp://{coordinator}", world, int(process_id) * local_ranks + local_rank,
        dev, share,
    )
    _INITIALIZED = True
    return backend


def is_multihost() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def host_local_batch_to_global(batch: dict, sharding: RowShard, host_rows: RowShard | None = None):
    """This rank's rows of the global batch from its host's LOCAL rows.

    ``batch``: dict of host arrays/tensors holding the host's contiguous
    block ``host_rows`` of the global batch (by default the block of this
    rank's host: one host per rank). ``sharding``: the rank's block of the
    global batch (:func:`~tpu_rl_torch.parallel.mesh.batch_sharding`).
    Returns the rank's rows as tensors."""
    if host_rows is None:
        host_rows = sharding

    def place(x):
        x = torch.as_tensor(x)
        n_host = x.shape[0]
        n_global = n_host * host_rows.count
        want = sharding.of(n_global)
        row0 = host_rows.index * n_host
        start, stop = want.start - row0, want.stop - row0
        assert 0 <= start < stop <= n_host, (
            "host-local batch does not cover this host's shard rows "
            f"({start}:{stop} of {n_host}); feed each host exactly "
            "its rows of the global batch"
        )
        return x[start:stop]

    return {k: place(v) for k, v in batch.items()}
