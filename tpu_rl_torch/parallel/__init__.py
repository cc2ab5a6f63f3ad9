"""Multi-device training on ``torch.distributed`` and the transformer's
attention primitives — the port of ``tpu_rl.parallel``: rank meshes
(:mod:`.mesh`), multi-host bring-up (:mod:`.multihost`), data-parallel train
steps (:mod:`.dp`) and the attention schemes, ring and Ulysses among them
(:mod:`.sequence`)."""

from tpu_rl_torch.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    Mesh,
    batch_sharding,
    check_divisible,
    make_mesh,
    make_sp_mesh,
    replicated,
)
from tpu_rl_torch.parallel.dp import (
    make_parallel_train_step,
    make_sp_train_step,
    replicate,
    shard_batch,
    shard_chained_batch,
)
from tpu_rl_torch.parallel.sequence import (
    full_attention,
    ring_attention,
    segment_ids_from_firsts,
    ulysses_attention,
)

__all__ = [
    "DATA_AXIS",
    "SEQ_AXIS",
    "Mesh",
    "batch_sharding",
    "check_divisible",
    "make_mesh",
    "make_sp_mesh",
    "replicated",
    "make_parallel_train_step",
    "make_sp_train_step",
    "replicate",
    "shard_batch",
    "shard_chained_batch",
    "full_attention",
    "ring_attention",
    "ulysses_attention",
    "segment_ids_from_firsts",
]
