"""Storage-side replica membership — the port of ``tpu_rl.fleet.membership``:
the worker lease table, version-aware.

Inference replicas announce themselves on the stat/telemetry channel (their
snapshots carry a top-level ``rid`` and ``ver``); storage folds those frames
into a :class:`ReplicaTable` the way worker frames feed the worker
``MembershipTable``. On top of the leases:

- **per-replica versions**: the newest policy version each replica reported
  serving, so a replica lagging the rollout shows;
- **the fleet version floor**: the highest version any replica has ever
  reported. It never decreases, across evictions and restarts: a killed
  replica rejoining on random-init weights (version -1) must not lower the
  floor clients already observed; the ``FleetClient`` holds the same floor
  on its side by discarding replies below it.

A replica's join raises the same mailbox flag a worker's join does
(``SLOT_JOIN_REQ``), so the learner's join push re-publishes the current
weights and version.
"""

from __future__ import annotations

import time

from tpu_rl_torch.runtime.storage import MembershipTable


class ReplicaTable(MembershipTable):
    """Lease-based live membership of inference replicas, keyed by rid,
    with each replica's served version and the fleet's version floor."""

    def __init__(self, lease_s: float, clock=time.monotonic):
        super().__init__(lease_s, clock)
        self.versions: dict[int, int] = {}  # rid -> newest reported version
        self.floor = -1  # the highest version ever reported; never decreases

    def touch(self, rid: int, ver: int = -1, now: float | None = None) -> bool:
        """Renew rid's lease and raise its version; True iff a (re)join."""
        joined = super().touch(rid, now)
        if ver > self.versions.get(rid, -1):
            self.versions[rid] = ver
            if ver > self.floor:
                self.floor = ver
        return joined

    def evict_expired(self, now: float | None = None) -> list[int]:
        dead = super().evict_expired(now)
        for rid in dead:
            # The replica's row goes; the floor stays: clients may have seen
            # its weights, and "never older than seen" outlives any replica.
            self.versions.pop(rid, None)
        return dead

    def min_active_version(self) -> int:
        """The oldest version among live replicas (-1 when none reported):
        the worst staleness a balanced request can land on now."""
        vers = [self.versions.get(rid, -1) for rid in self.active]
        return min(vers) if vers else -1
