"""Autopilot signal plane: poll the fleet's read-only HTTP endpoints into
a windowed store — the port's own copy of ``tpu_rl.autopilot.signals``,
unchanged in behaviour.

Zero new member-side protocol (the population controller's discipline): every
signal the decision engine consumes already exists on the storage (or
smoke-local) telemetry server —

- ``GET /slo`` — per-rule verdicts with burn rates *and* the burn-rate
  history the engine's sustain windows align with;
- ``GET /goodput`` — per-role goodput ratios + the straggler top-k;
- ``GET /metrics`` — the raw Prometheus exposition for any gauge/counter
  a rule names directly.

The scraper flattens one poll into the flat ``{"kind:name": value}``
signal dict :meth:`~tpu_rl_torch.autopilot.policy.DecisionEngine.decide`
takes, and appends every sample into a :class:`SignalStore` ring so the
controller's status document (and the dashboard) can show short series,
not just the latest point. Prometheus sanitizes the repo's dash-named
metrics to underscores; the scraper maps them back (``_`` -> ``-``) so
rules are written in the same dash convention as every spec grammar in
the repo.

stdlib-only (urllib via :mod:`tpu_rl_torch.obs.top` helpers), injectable
clock, and a fetch function injection point so tests drive it with
canned documents instead of sockets.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable

from tpu_rl_torch.obs.top import fetch, fetch_json, parse_prometheus


class SignalStore:
    """Windowed per-signal sample ring: ``{key: deque[(t, value)]}``."""

    def __init__(
        self,
        window_s: float = 120.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.window_s = float(window_s)
        self._clock = clock
        self._series: dict[str, deque] = {}

    def put(self, key: str, value: float, t: float | None = None) -> None:
        t = self._clock() if t is None else t
        ring = self._series.setdefault(key, deque())
        if ring and t <= ring[-1][0]:
            return  # replayed history (e.g. /slo burn_history): keep monotonic
        ring.append((t, float(value)))
        while ring and t - ring[0][0] > self.window_s:
            ring.popleft()

    def latest(self, key: str) -> float | None:
        ring = self._series.get(key)
        return ring[-1][1] if ring else None

    def series(self, key: str) -> list:
        return list(self._series.get(key, ()))

    def snapshot(self) -> dict:
        """Latest value per signal — the status-doc view."""
        return {k: ring[-1][1] for k, ring in self._series.items() if ring}


class SignalScraper:
    """One poll = three GETs -> (signals dict, meta dict).

    Partial availability is normal (a 404 ``/goodput`` on a fleet without
    the ledger, a brief connection refusal while the server binds): each
    endpoint contributes what it has and silence never fabricates a
    value — the engine holds streaks on missing signals.
    """

    def __init__(
        self,
        base_url: str,
        store: SignalStore | None = None,
        timeout_s: float = 2.0,
        fetch_fn: Callable = fetch,
        fetch_json_fn: Callable = fetch_json,
    ):
        self.base_url = base_url.rstrip("/")
        self.store = store if store is not None else SignalStore()
        self.timeout_s = float(timeout_s)
        self._fetch = fetch_fn
        self._fetch_json = fetch_json_fn
        self.n_polls = 0
        self.n_errors = 0

    def poll(self, now: float | None = None) -> tuple[dict, dict]:
        now = self.store._clock() if now is None else now
        self.n_polls += 1
        signals: dict = {}
        meta: dict = {}
        self._poll_slo(signals, now)
        self._poll_goodput(signals, meta, now)
        self._poll_metrics(signals, now)
        for key, value in signals.items():
            self.store.put(key, value, t=now)
        return signals, meta

    # ------------------------------------------------------------ endpoints
    def _poll_slo(self, signals: dict, now: float) -> None:
        doc = self._fetch_json(self.base_url + "/slo", self.timeout_s)
        if not isinstance(doc, dict) or "rules" not in doc:
            self.n_errors += 1
            return
        for row in doc.get("rules", ()):
            if not isinstance(row, dict):
                continue
            metric, burn = row.get("metric"), row.get("burn_rate")
            if metric is None or burn is None:
                continue
            key = f"burn:{metric}"
            # Several rules may watch one metric: the worst burn governs.
            signals[key] = max(float(burn), signals.get(key, 0.0))
            # Replay the server-side history so the store's series matches
            # what the engine's sustain window actually saw — same data,
            # one source of truth (the satellite-3 /slo payload).
            for point in row.get("burn_history", ()) or ():
                try:
                    t_hist, b_hist = float(point[0]), float(point[1])
                except (TypeError, ValueError, IndexError):
                    continue
                self.store.put(key, b_hist, t=t_hist)

    def _poll_goodput(self, signals: dict, meta: dict, now: float) -> None:
        doc = self._fetch_json(self.base_url + "/goodput", self.timeout_s)
        if not isinstance(doc, dict):
            return  # 404 (no ledger) is a normal fleet shape, not an error
        by_role: dict[str, list] = {}
        for key, row in (doc.get("roles") or {}).items():
            goodput = (row or {}).get("goodput")
            if goodput is None:
                continue
            role = str(key).partition("/")[0]
            by_role.setdefault(role, []).append(float(goodput))
        for role, values in by_role.items():
            signals[f"goodput:{role}"] = sum(values) / len(values)
        stragglers = doc.get("stragglers") or []
        if stragglers and isinstance(stragglers[0], dict):
            top = stragglers[0]
            score = top.get("score")
            if score is not None:
                signals["straggler:score"] = float(score)
                if top.get("wid") is not None:
                    meta["straggler_wid"] = top["wid"]

    def _poll_metrics(self, signals: dict, now: float) -> None:
        status, body = self._fetch(self.base_url + "/metrics", self.timeout_s)
        if status != 200:
            self.n_errors += 1
            return
        gauges: dict[str, float] = {}
        counters: dict[str, float] = {}
        for name, _labels, value in parse_prometheus(body):
            # Histogram series (_bucket/_sum/_count/_p99) keep their
            # suffixes and never collide with gauge/counter family names.
            key = name.replace("_", "-")
            gauges[key] = max(gauges.get(key, float("-inf")), value)
            counters[key] = counters.get(key, 0.0) + value
        kinds = _family_kinds(body)
        for key in gauges:
            fam = kinds.get(key)
            if fam == "gauge":
                signals[f"gauge:{key}"] = gauges[key]
            elif fam == "counter":
                signals[f"counter:{key}"] = counters[key]


# Channel-name prefix under which the controller persists every scraped
# signal sample into its run-history store (one ``signals/<key>`` channel
# per SignalStore key, all kinds: burn/goodput/straggler/gauge/counter).
SIGNAL_CHANNEL_PREFIX = "signals/"


def signal_channels(store: SignalStore) -> dict[str, float]:
    """The store's latest values as history channels — what the controller
    hands to ``TimeSeriesStore.record(extra=...)`` each exporter tick."""
    return {
        SIGNAL_CHANNEL_PREFIX + key: value
        for key, value in store.snapshot().items()
    }


def rehydrate_signals(
    store: SignalStore,
    reader,
    now_wall: float | None = None,
    now_mono: float | None = None,
) -> int:
    """Refill a :class:`SignalStore`'s windows from a history store after
    a controller restart, so sustain streaks resume where the dead
    controller left off instead of restarting from empty — for EVERY
    signal kind (goodput/straggler/gauge/counter/burn), not just the
    ``/slo`` ``burn_history`` replay.

    ``reader`` is a :class:`tpu_rl_torch.obs.history.HistoryReader` (duck-typed:
    ``series()`` + ``points()``). History timestamps are wall-clock; the
    store's rings are monotonic — samples are converted through the
    current wall-to-monotonic offset, and anything that would land in the
    monotonic future (cross-boot history, clock steps) is dropped so the
    ring's monotonic guard never rejects future LIVE samples. Returns the
    number of samples restored."""
    now_wall = time.time() if now_wall is None else now_wall
    now_mono = store._clock() if now_mono is None else now_mono
    offset = now_wall - now_mono  # t_wall = t_mono + offset
    horizon = now_wall - store.window_s
    n = 0
    for ch in sorted(reader.series()):
        if not ch.startswith(SIGNAL_CHANNEL_PREFIX):
            continue
        key = ch[len(SIGNAL_CHANNEL_PREFIX):]
        for t_wall, value in reader.points(ch, start=horizon):
            t_mono = t_wall - offset
            if t_mono > now_mono:
                continue
            store.put(key, value, t=t_mono)
            n += 1
    return n


def _family_kinds(body: str) -> dict:
    """``# TYPE`` lines -> {dash-name: kind} (histogram families skipped)."""
    kinds: dict[str, str] = {}
    for line in body.splitlines():
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) >= 4 and parts[3] in ("gauge", "counter"):
                kinds[parts[2].replace("_", "-")] = parts[3]
    return kinds
