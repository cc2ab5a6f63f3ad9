"""Per-role metrics registry: the fleet-wide replacement for ad-hoc stat dicts.

The port's own copy of ``tpu_rl.obs.registry``, unchanged in behaviour.

Every role process (worker, manager, storage, inference service, learner)
owns one :class:`MetricsRegistry`, registers counters / gauges / histograms
into it, and periodically emits ``registry.snapshot()`` as a
``Protocol.Telemetry`` frame riding the existing stat ZMQ channel
(worker PUB -> manager -> storage SUB). The storage-side
:class:`~tpu_rl_torch.obs.aggregator.TelemetryAggregator` collects the snapshots
and the exporters (:mod:`tpu_rl_torch.obs.exporters`) serve them as Prometheus
text, a rolling JSON file, and tensorboard scalars.

Design constraints:

- **wire-safe snapshots**: ``snapshot()`` returns only the closed type set
  the wire protocol packs (str-keyed dicts, lists, str, int, float) — a
  snapshot IS a Telemetry payload, no adapter layer;
- **fixed log-scale histogram buckets** (:data:`HIST_BUCKETS`): every
  histogram in the fleet shares one bucket layout, so snapshots merge by
  elementwise addition and the Prometheus exposition needs no per-metric
  schema. The 2^-14 .. 2^20 span covers microsecond timings and
  million-update policy lags alike;
- **cheap when idle**: metric updates are a lock + a float add. Roles that
  run with telemetry disabled simply never construct a registry — the hot
  paths guard on ``is None``, not on a config read.

Metric names follow the repo's dash convention (``learner-queue-depth``);
the Prometheus exporter sanitizes to underscores at exposition time.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from bisect import bisect_left
from typing import Callable

# One fixed log-scale bucket layout for every histogram in the fleet
# (Prometheus ``le`` upper bounds; an implicit +Inf overflow slot follows).
# Shared buckets are what make snapshot merge a plain elementwise sum.
HIST_BUCKETS: tuple[float, ...] = tuple(2.0**e for e in range(-14, 21))


def _label_key(labels: dict[str, str] | None) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((labels or {}).items()))


class Counter:
    """Monotonic cumulative count."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def inc(self, delta: float = 1.0) -> None:
        with self._lock:
            self.value += delta

    def set_total(self, total: float) -> None:
        """Mirror an externally-maintained monotonic count (e.g. a transport
        socket's ``n_rejected``) — the total never moves backwards."""
        with self._lock:
            if total > self.value:
                self.value = total


class Gauge:
    """Last-written instantaneous value."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


def hist_quantile(counts: list[int] | tuple[int, ...], q: float) -> float | None:
    """Quantile estimate over a :data:`HIST_BUCKETS`-shaped slot-count list
    (the wire form snapshots carry), geometric interpolation inside buckets.

    Every bucket spans exactly one octave (``hi = 2 * lo``, including the
    synthetic ``(2^-15, 2^-14]`` floor for the first slot and the capped
    ``(2^20, 2^21]`` overflow slot), so the interpolated value is
    ``lo * 2**frac`` where ``frac`` is the rank's position within the
    bucket. Log-linear interpolation matches the log-scale layout: the
    estimate is exact when observations are log-uniform within a bucket and
    never leaves the bucket's bounds. Returns ``None`` on an empty
    histogram — callers (SLO engine, exporter) must treat no-data
    explicitly, not as 0.
    """
    total = sum(counts)
    if total <= 0:
        return None
    q = min(1.0, max(0.0, float(q)))
    rank = q * total  # fractional rank in (0, total]
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= rank:
            hi = HIST_BUCKETS[i] if i < len(HIST_BUCKETS) else HIST_BUCKETS[-1] * 2.0
            lo = hi / 2.0
            frac = (rank - cum) / c
            return lo * (2.0**frac)
        cum += c
    hi = HIST_BUCKETS[-1] * 2.0  # unreachable unless counts drifted negative
    return hi


class Histogram:
    """Fixed-bucket distribution (:data:`HIST_BUCKETS` + overflow slot).
    ``counts`` are per-slot (non-cumulative); the Prometheus exporter
    renders the cumulative ``le`` form."""

    __slots__ = ("counts", "sum", "count", "_lock")

    def __init__(self, lock: threading.Lock):
        self.counts = [0] * (len(HIST_BUCKETS) + 1)
        self.sum = 0.0
        self.count = 0
        self._lock = lock

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.counts[bisect_left(HIST_BUCKETS, v)] += 1
            self.sum += v
            self.count += 1

    def observe_n(self, value: float, n: int) -> None:
        """Bulk-observe ``n`` identical samples — delta replay of an
        externally-counted event stream (e.g. the inference service's
        per-bucket flush counts) without n lock round-trips."""
        if n <= 0:
            return
        v = float(value)
        with self._lock:
            self.counts[bisect_left(HIST_BUCKETS, v)] += n
            self.sum += v * n
            self.count += n

    def quantile(self, q: float) -> float | None:
        """p50/p90/p99/p999 estimate (see :func:`hist_quantile`)."""
        with self._lock:
            counts = list(self.counts)
        return hist_quantile(counts, q)


class MetricsRegistry:
    """One process-role's metric namespace, labeled ``(role, host, pid)``
    plus any extra constant labels (e.g. a worker's ``wid``)."""

    def __init__(
        self,
        role: str,
        labels: dict[str, str] | None = None,
        host: str | None = None,
        pid: int | None = None,
    ):
        self.role = role
        self.host = host if host is not None else socket.gethostname()
        self.pid = int(pid if pid is not None else os.getpid())
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._hists: dict[tuple, Histogram] = {}
        self._seq = 0

    # ----------------------------------------------------------- metric access
    def counter(self, name: str, labels: dict[str, str] | None = None) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, labels: dict[str, str] | None = None) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, labels: dict[str, str] | None = None) -> Histogram:
        return self._get(self._hists, Histogram, name, labels)

    def _get(self, table: dict, cls, name: str, labels: dict[str, str] | None):
        key = (name, _label_key(labels))
        with self._lock:
            m = table.get(key)
            if m is None:
                m = table[key] = cls(self._lock)
            return m

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """Wire-safe dump of every metric: the ``Protocol.Telemetry``
        payload. Labels are the registry's constant labels merged with the
        metric's own (metric labels win on collision)."""
        with self._lock:
            self._seq += 1
            snap = {
                "role": self.role,
                "host": self.host,
                "pid": self.pid,
                "seq": self._seq,
                "ts": time.time(),
                "counters": [
                    [name, self._merged_labels(lk), c.value]
                    for (name, lk), c in self._counters.items()
                ],
                "gauges": [
                    [name, self._merged_labels(lk), g.value]
                    for (name, lk), g in self._gauges.items()
                ],
                "hists": [
                    [name, self._merged_labels(lk), list(h.counts), h.sum, h.count]
                    for (name, lk), h in self._hists.items()
                ],
            }
        return snap

    def _merged_labels(self, label_key: tuple) -> dict[str, str]:
        return {**self.labels, **dict(label_key)}


# --------------------------------------------------------------- snapshot ops
def _series_key(entry: list) -> tuple:
    name, labels = entry[0], entry[1]
    return (name, tuple(sorted(labels.items())))


def merge_snapshots(a: dict, b: dict) -> dict:
    """Elementwise combine two snapshots into one (counters and histogram
    slots add; gauges: the newer snapshot — by ``ts`` — wins). Metadata is
    kept from ``a`` except ``ts`` (max). Inputs are not mutated."""
    newer_b = float(b.get("ts", 0.0)) >= float(a.get("ts", 0.0))
    out = {
        k: a.get(k)
        for k in ("role", "host", "pid", "seq")
    }
    out["ts"] = max(float(a.get("ts", 0.0)), float(b.get("ts", 0.0)))

    counters: dict[tuple, list] = {}
    for src in (a, b):
        for name, labels, value in src.get("counters", ()):
            key = (name, tuple(sorted(labels.items())))
            if key in counters:
                counters[key][2] += value
            else:
                counters[key] = [name, dict(labels), float(value)]
    out["counters"] = list(counters.values())

    gauges: dict[tuple, list] = {}
    first, second = (a, b) if newer_b else (b, a)
    for src in (first, second):  # second (newer) overwrites
        for name, labels, value in src.get("gauges", ()):
            key = (name, tuple(sorted(labels.items())))
            gauges[key] = [name, dict(labels), float(value)]
    out["gauges"] = list(gauges.values())

    hists: dict[tuple, list] = {}
    for src in (a, b):
        for name, labels, counts, total, count in src.get("hists", ()):
            key = (name, tuple(sorted(labels.items())))
            if key in hists:
                h = hists[key]
                h[2] = [x + y for x, y in zip(h[2], counts, strict=True)]
                h[3] += total
                h[4] += count
            else:
                hists[key] = [name, dict(labels), list(counts), float(total), int(count)]
    out["hists"] = list(hists.values())
    return out


def diff_snapshots(cur: dict, prev: dict) -> dict:
    """Per-interval deltas: counters and histogram slots subtract (floored
    at zero, so a restarted source never yields negative rates); gauges pass
    through from ``cur``. The inverse of :func:`merge_snapshots` over the
    additive fields."""
    prev_counters = {_series_key(e): e[2] for e in prev.get("counters", ())}
    prev_hists = {_series_key(e): e for e in prev.get("hists", ())}
    out = {k: cur.get(k) for k in ("role", "host", "pid", "seq", "ts")}
    out["counters"] = [
        [name, dict(labels), max(0.0, value - prev_counters.get(_series_key([name, labels]), 0.0))]
        for name, labels, value in cur.get("counters", ())
    ]
    out["gauges"] = [list(e) for e in cur.get("gauges", ())]
    hists = []
    for name, labels, counts, total, count in cur.get("hists", ()):
        p = prev_hists.get(_series_key([name, labels]))
        if p is None:
            hists.append([name, dict(labels), list(counts), float(total), int(count)])
        else:
            hists.append(
                [
                    name,
                    dict(labels),
                    [max(0, x - y) for x, y in zip(counts, p[2], strict=True)],
                    max(0.0, total - p[3]),
                    max(0, count - p[4]),
                ]
            )
    out["hists"] = hists
    return out


class PeriodicSnapshot:
    """Wall-clock-gated snapshot emitter: call :meth:`maybe_emit` from a
    role's loop; every ``interval_s`` it ships ``registry.snapshot()``
    through the supplied ``send`` callable (transport-agnostic — the roles
    bind it to their existing PUB). This is what makes idle/stuck roles
    visible: emission is on the clock, not on episode completion."""

    def __init__(
        self,
        registry: MetricsRegistry,
        send: Callable[[dict], None],
        interval_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.registry = registry
        self._send = send
        self.interval_s = float(interval_s)
        self._clock = clock
        self._last = float("-inf")
        self.n_emitted = 0

    def due(self, now: float | None = None) -> bool:
        """Would :meth:`maybe_emit` emit right now? Lets roles refresh
        emit-cadence-only metrics (``/proc/self`` reads, fd counts) just
        before the snapshot they'll ride, without paying for them every
        tick."""
        now = self._clock() if now is None else now
        return now - self._last >= self.interval_s

    def maybe_emit(self, now: float | None = None) -> bool:
        now = self._clock() if now is None else now
        if now - self._last < self.interval_s:
            return False
        self._last = now
        self._send(self.registry.snapshot())
        self.n_emitted += 1
        return True
