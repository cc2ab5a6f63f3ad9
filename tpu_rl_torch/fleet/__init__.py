"""Elastic inference fleet — the port of ``tpu_rl.fleet``.

Scales the single :class:`~tpu_rl_torch.runtime.inference_service.
InferenceService` into N replicas serving the acting plane side by side:

- :mod:`tpu_rl_torch.fleet.replica`: :class:`InferenceReplica`, a
  continuous-batching, optionally sharded service with version-keyed
  (never rolled back) weight swaps, and ``replica_main``, the supervised
  standalone process fed by the learner's model broadcast;
- :mod:`tpu_rl_torch.fleet.client`: :class:`FleetClient`, the workers' and
  load generator's client: replica discovery from the config's port plan,
  power-of-two load-aware selection, hedged retries, failover, and a pinned
  version floor;
- :mod:`tpu_rl_torch.fleet.membership`: :class:`ReplicaTable`, storage's
  lease table of replicas, with each replica's version and the fleet's
  version floor, which never decreases.

Replica 0 lives in the learner (swapped in-process after every update);
replicas 1..N-1 are supervisor children named ``inference-<i>`` that take
weights from the model broadcast the workers use.
"""

from tpu_rl_torch.fleet.client import FleetClient
from tpu_rl_torch.fleet.membership import ReplicaTable
from tpu_rl_torch.fleet.replica import InferenceReplica, replica_main

__all__ = [
    "FleetClient",
    "InferenceReplica",
    "ReplicaTable",
    "replica_main",
]
