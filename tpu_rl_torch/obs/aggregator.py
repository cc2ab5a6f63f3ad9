"""Learner-side collection point for the fleet's Telemetry snapshots.

The port's own copy of ``tpu_rl.obs.aggregator``, unchanged in behaviour.

The aggregator runs in the storage process — the learner-side edge of the
stat channel, the one hop every role already reaches: workers' snapshots
arrive via the manager relay, the manager's own snapshots ride its PUB, and
the learner process publishes its snapshots on a tiny PUB connected to the
same port (``LearnerService``). Storage's own registry is folded in
in-process. The exporters (:mod:`tpu_rl_torch.obs.exporters`) read everything
from here.

Responsibilities:

- keep the latest snapshot per source ``(role, host, pid[, wid])`` with its
  arrival time — staleness per source is what ``/healthz`` reports;
- **policy-staleness tracking**: every ``RolloutBatch`` frame echoes the
  policy version (the learner's update index, tagged onto ``Model``
  broadcasts and inference replies) it was acted with.
  :meth:`observe_staleness` compares that echo against the newest version
  the aggregator has seen anywhere — learner snapshots carry the
  authoritative ``learner-update-index`` gauge, and the echoes themselves
  ratchet the bound — and records ``current - acted`` into a per-worker
  ``policy-staleness-updates`` histogram (IMPALA's policy-lag signal,
  PAPERS.md 1802.01561);
- stay O(sources) in memory and O(1) per ingest: snapshots replace, they
  never accumulate.

When telemetry is disabled the aggregator is simply never constructed —
:func:`maybe_aggregator` returns None and every call site guards on that,
so the disabled path allocates nothing per frame (pinned by
``tests/test_obs.py::test_disabled_telemetry_allocates_nothing``).
"""

from __future__ import annotations

import time
from typing import Callable

from tpu_rl_torch.obs.registry import MetricsRegistry

# A source whose last snapshot is older than this is reported dead by
# /healthz. Generous vs the default 5 s emit interval: one lost frame on the
# best-effort PUB/SUB fabric must not flap liveness.
DEFAULT_STALE_AFTER_S = 30.0

LEARNER_VERSION_GAUGE = "learner-update-index"
STALENESS_HIST = "policy-staleness-updates"


class TelemetryAggregator:
    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        stale_after_s: float = DEFAULT_STALE_AFTER_S,
        clock: Callable[[], float] = time.monotonic,
    ):
        # The aggregator's own registry: the storage role's metrics plus the
        # per-worker staleness histograms (storage is where rollout frames
        # are decoded, so the version echoes surface here).
        self.registry = registry or MetricsRegistry(role="storage")
        self.stale_after_s = float(stale_after_s)
        self._clock = clock
        # (role, host, pid, wid) -> {"snap": dict, "at": monotonic}
        self.sources: dict[tuple, dict] = {}
        self.n_ingested = 0
        self.n_rejected = 0
        self._max_version = -1

    # ----------------------------------------------------------------- ingest
    def ingest(self, snap: dict, now: float | None = None) -> bool:
        """One Telemetry payload off the wire. Returns False (and counts)
        for frames that decoded fine but are not snapshot-shaped — a foreign
        publisher on the stat channel must not poison the plane."""
        if (
            not isinstance(snap, dict)
            or not isinstance(snap.get("role"), str)
            or not isinstance(snap.get("pid"), int)
        ):
            self.n_rejected += 1
            return False
        now = self._clock() if now is None else now
        key = (
            snap["role"],
            str(snap.get("host", "?")),
            snap["pid"],
            str(snap.get("wid", "")),
        )
        self.sources[key] = {"snap": snap, "at": now}
        self.n_ingested += 1
        if snap["role"] == "learner":
            for name, _labels, value in snap.get("gauges", ()):
                if name == LEARNER_VERSION_GAUGE:
                    self._max_version = max(self._max_version, int(value))
        return True

    # -------------------------------------------------------------- staleness
    @property
    def max_version(self) -> int:
        """Newest policy version seen anywhere (learner gauge or rollout
        echo); -1 until the first versioned frame arrives."""
        return self._max_version

    def observe_staleness(self, wid: int, version: int) -> None:
        """One rollout frame acted with policy ``version`` by worker
        ``wid``. The staleness, in learner updates, is the gap to the newest
        version known fleet-wide; the echoes themselves ratchet that bound,
        so the metric works even before the learner's first snapshot lands
        (it then under-reports by at most the broadcast in flight)."""
        if version < 0:
            return  # unversioned frame (pre-upgrade worker): nothing to say
        if version > self._max_version:
            self._max_version = version
        self.registry.histogram(
            STALENESS_HIST, labels={"wid": str(wid)}
        ).observe(self._max_version - version)

    # ---------------------------------------------------------------- reading
    def all_snapshots(self, now: float | None = None) -> list[tuple[dict, float]]:
        """Every known snapshot with its age in seconds — the fleet sources
        plus the aggregator's own registry (age 0, it lives here)."""
        now = self._clock() if now is None else now
        out = [(e["snap"], now - e["at"]) for e in self.sources.values()]
        out.append((self.registry.snapshot(), 0.0))
        return out

    def role_health(self, now: float | None = None) -> dict[str, dict]:
        """Per-role liveness: a role is alive while ANY of its sources
        emitted within ``stale_after_s``. The aggregator's own role is
        always alive (it is answering)."""
        now = self._clock() if now is None else now
        roles: dict[str, dict] = {
            self.registry.role: {"sources": 1, "age_s": 0.0, "alive": True}
        }
        for (role, _host, _pid, _wid), entry in self.sources.items():
            age = now - entry["at"]
            r = roles.setdefault(
                role, {"sources": 0, "age_s": age, "alive": False}
            )
            r["sources"] += 1
            r["age_s"] = min(r["age_s"], age) if r["sources"] > 1 else age
            r["alive"] = r["alive"] or age <= self.stale_after_s
        return roles

    def healthy(self, now: float | None = None) -> bool:
        return all(r["alive"] for r in self.role_health(now).values())


def maybe_aggregator(cfg) -> TelemetryAggregator | None:
    """The single gate for the whole plane: an aggregator exists iff
    telemetry has somewhere to go (``cfg.telemetry_enabled``)."""
    return TelemetryAggregator() if cfg.telemetry_enabled else None
