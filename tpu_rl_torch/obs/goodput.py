"""Goodput ledger: exhaustive, non-overlapping wall-clock attribution.

The port's own copy of ``tpu_rl.obs.goodput``, unchanged in behaviour.

Every role's main loop owns one ``GoodputLedger`` (telemetry-gated — the
plane-off path is one ``is None`` check) and attributes each span of loop
wall time to exactly one bucket via ``add(BUCKET, secs)``. The taxonomy is
closed::

    compute / h2d / queue-wait / wire / ckpt / rollback / recompile /
    idle / overhead

``snapshot()`` turns the accumulators into an exhaustive breakdown: any
elapsed time the loop did not explicitly attribute spills into ``overhead``
(so the buckets sum to elapsed wall time by construction), while attributed
time EXCEEDING elapsed — the double-count failure mode, e.g. a feeder
thread's spans leaking into the main lane — surfaces as ``overcommit``
instead of being silently normalized away. The invariant the tests and
``make goodput-smoke`` pin is ``overcommit_ratio <= 1%``: buckets sum to
elapsed wall time within 1%, nothing counted twice.

Ledger rules (documented in ARCHITECTURE.md §Goodput):

- one ledger per loop THREAD — work done on other lanes (the learner's
  prefetch feeder, the async checkpoint writer, the async weight
  publisher) is never added; it overlaps the main lane and would
  double-count. The synchronous remnants (sync-feed h2d, the device-side
  checkpoint snapshot) ARE main-lane time and are attributed.
- ``goodput`` is the compute share: the fraction of wall time the role
  spent on the work it exists for (train steps, acting math, ingest).

Gauges published on the telemetry cadence (``publish``): the per-role
family ``{role}-goodput-ratio`` plus one ``{role}-time-{bucket}-ratio``
per bucket and ``{role}-time-overcommit-ratio`` — they ride the existing
registry → aggregator → Prometheus path, so SLO rules like
``gauge:learner-goodput-ratio>0.6`` need no engine change.

Straggler analytics (storage-side, report-only): per-wid frame-rate /
policy-staleness / rtt robust z-scores against the fleet median, rolled
into a ``worker-straggler-score`` gauge and a top-k report on
``GET /goodput``. Quarantine (the heal plane) stays the enforcement arm.
"""

from __future__ import annotations

import time

# The closed bucket taxonomy. Order is the accumulator layout; the integer
# aliases below are what hot loops pass to ``add`` (STRICT hot-path tier:
# no per-call string hashing, no literals).
BUCKETS = (
    "compute",
    "h2d",
    "queue-wait",
    "wire",
    "ckpt",
    "rollback",
    "recompile",
    "idle",
    "overhead",
)
(
    COMPUTE,
    H2D,
    QUEUE_WAIT,
    WIRE,
    CKPT,
    ROLLBACK,
    RECOMPILE,
    IDLE,
    OVERHEAD,
) = range(len(BUCKETS))

# Gauge-name families (role-prefixed at ledger construction). The constants
# carry the family suffixes so the drift checker sees the documented
# ``*-goodput-ratio`` / ``*-time-*-ratio`` wildcard rows matched in code.
GOODPUT_RATIO_GAUGE = "-goodput-ratio"
TIME_RATIO_GAUGE = "-time-%s-ratio"
STRAGGLER_GAUGE = "worker-straggler-score"

_OVERCOMMIT = "overcommit"


class GoodputLedger:
    """Per-loop wall-clock attribution into the closed bucket taxonomy."""

    __slots__ = ("role", "_clock", "_t0", "_acc", "_goodput_name", "_names")

    def __init__(self, role: str, clock=time.perf_counter):
        self.role = role
        self._clock = clock
        self._t0 = clock()
        self._acc = [0.0] * len(BUCKETS)
        self._goodput_name = role + GOODPUT_RATIO_GAUGE
        names = [role + (TIME_RATIO_GAUGE % b) for b in BUCKETS]
        names.append(role + (TIME_RATIO_GAUGE % _OVERCOMMIT))
        self._names = tuple(names)

    # ------------------------------------------------------------- hot path
    def add(self, bucket: int, secs: float) -> None:
        """Attribute ``secs`` of main-lane wall time to one bucket.

        STRICT hot-path tier (tools/analysis manifest): one float add,
        no allocation beyond float boxing.
        """
        if secs > 0.0:
            self._acc[bucket] += secs

    def now(self) -> float:
        return self._clock()

    # ------------------------------------------------------------ snapshots
    def elapsed(self) -> float:
        return self._clock() - self._t0

    def snapshot(self) -> dict:
        """Exhaustive breakdown: buckets sum to max(elapsed, attributed).

        Unattributed time spills into ``overhead``; attributed time past
        elapsed (double-count) is reported as ``overcommit_s`` /
        ``overcommit_ratio`` rather than hidden by normalization.
        """
        elapsed = self.elapsed()
        explicit = sum(self._acc)
        spill = elapsed - explicit
        buckets = dict(zip(BUCKETS, self._acc, strict=True))
        if spill > 0.0:
            buckets["overhead"] += spill
            total, overcommit = elapsed, 0.0
        else:
            total, overcommit = explicit, -spill
        denom = total if total > 0.0 else 1.0
        ratios = {b: v / denom for b, v in buckets.items()}
        return {
            "role": self.role,
            "elapsed_s": elapsed,
            "buckets": buckets,
            "ratios": ratios,
            "goodput": ratios["compute"],
            "overcommit_s": overcommit,
            "overcommit_ratio": overcommit / denom,
        }

    def publish(self, registry) -> dict:
        """Set the per-role gauges from a fresh snapshot; returns it."""
        snap = self.snapshot()
        registry.gauge(self._goodput_name).set(snap["goodput"])
        for i, b in enumerate(BUCKETS):
            registry.gauge(self._names[i]).set(snap["ratios"][b])
        registry.gauge(self._names[len(BUCKETS)]).set(snap["overcommit_ratio"])
        return snap


def maybe_ledger(role: str, enabled: bool) -> GoodputLedger | None:
    """The plane gate: None when telemetry is off (hot loops pay one
    ``is None`` check, same discipline as every other obs subsystem)."""
    return GoodputLedger(role) if enabled else None


# ------------------------------------------------------------- stragglers
def robust_z(values: dict, floor: float = 0.0) -> dict:
    """Robust z-score per key: (x - median) / scale, where scale is the
    scaled MAD floored at 5% of |median| (a uniform fleet with measurement
    noise must NOT produce stragglers — MAD alone collapses to ~0 there
    and would amplify jitter into false positives). ``floor`` is an
    absolute scale floor in the signal's own units, for signals whose
    healthy median is exactly 0 (staleness): without it one lagging member
    divides by ~0 and the score loses all magnitude meaning."""
    if not values:
        return {}
    xs = sorted(values.values())
    med = _median(xs)
    mad = _median(sorted(abs(x - med) for x in xs))
    scale = max(1.4826 * mad, 0.05 * abs(med), floor, 1e-9)
    return {k: (v - med) / scale for k, v in values.items()}


def _median(xs: list) -> float:
    n = len(xs)
    mid = n // 2
    if n % 2:
        return float(xs[mid])
    return (xs[mid - 1] + xs[mid]) / 2.0


def straggler_report(
    frame_rate: dict | None = None,
    staleness: dict | None = None,
    rtt: dict | None = None,
    k: int = 5,
) -> tuple[dict, list]:
    """Per-wid straggler scores + the top-k report.

    Signals are oriented so positive = straggling: a frame rate BELOW the
    fleet median (negated z), staleness or rtt ABOVE it (raw z). The score
    is the worst oriented z across available signals, floored at 0 — any
    single bad signal marks the wid; a wid missing a signal (e.g. no rtt
    estimate yet) is judged on what it has. Returns ``(scores_by_wid,
    top_k_entries)`` with entries shaped for ``GET /goodput``::

        {"wid": 1, "score": 20.1, "signals": {"frame-rate": 0.0, ...},
         "z": {"frame-rate": 20.1, ...}}

    Report-only by design: quarantine is the enforcement arm.
    """
    frame_rate = frame_rate or {}
    staleness = staleness or {}
    rtt = rtt or {}
    oriented = {
        "frame-rate": {w: -z for w, z in robust_z(frame_rate).items()},
        # Absolute scale floors: a healthy fleet sits at staleness ~0 and
        # sub-ms rtt jitter, so z is "excess over one update" / "excess
        # over 1 ms" there rather than a division by ~0.
        "staleness": robust_z(staleness, floor=1.0),
        "rtt": robust_z(rtt, floor=1e-3),
    }
    raw = {"frame-rate": frame_rate, "staleness": staleness, "rtt": rtt}
    wids = set(frame_rate) | set(staleness) | set(rtt)
    scores: dict = {}
    entries = []
    for wid in wids:
        zs = {s: d[wid] for s, d in oriented.items() if wid in d}
        score = max(0.0, max(zs.values()))
        scores[wid] = score
        entries.append(
            {
                "wid": wid,
                "score": round(score, 3),
                "signals": {
                    s: round(d[wid], 6) for s, d in raw.items() if wid in d
                },
                "z": {s: round(z, 3) for s, z in zs.items()},
            }
        )
    entries.sort(key=lambda e: (-e["score"], str(e["wid"])))
    return scores, entries[:k]
