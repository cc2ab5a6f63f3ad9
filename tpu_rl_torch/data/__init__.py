"""Host-side data plane of the port — the port of ``tpu_rl.data``: the
batch layout, trajectory assembly, shared-memory batch stores and the
pipelined learner feed. Everything but :mod:`tpu_rl_torch.data.prefetch`'s
placement onto the card is numpy.
"""

from tpu_rl_torch.data.layout import BatchLayout
from tpu_rl_torch.data.assembler import RolloutAssembler, Trajectory
from tpu_rl_torch.data.prefetch import (
    PrefetchPipeline,
    SynchronousFeed,
    UpdateRatioGate,
)
from tpu_rl_torch.data.shm_ring import OnPolicyStore, ReplayStore, make_store

__all__ = [
    "BatchLayout",
    "RolloutAssembler",
    "Trajectory",
    "OnPolicyStore",
    "PrefetchPipeline",
    "ReplayStore",
    "SynchronousFeed",
    "UpdateRatioGate",
    "make_store",
]
