"""Run-history plane: an embedded, crash-atomic, chunked time-series store.

The port's own copy of ``tpu_rl.obs.history``, unchanged in behaviour.

Every observability surface before this one shows *now* — ``/metrics``,
``telemetry.json``, ``/slo``, ``/goodput`` and the dashboard are all
point-in-time snapshots. The history store is the read-side they were
writing toward: on the exporter cadence the owning role flattens its
:class:`~tpu_rl_torch.obs.aggregator.TelemetryAggregator` into one row of
``{channel: value}`` samples (every gauge, every counter, p50/p99 of
every histogram) and appends it to a chunked jsonl log under
``result_dir/history/``. Zero new ports, zero new member-side protocol:
the fleet's snapshots already ride the stat channel to storage, and the
self-served roles (colocated/sebulba/autopilot) record their own
aggregator the same way.

Durability model (the repo-wide torn-write discipline, applied to an
append log):

- one JSON line per record tick — O_APPEND-style whole-line writes, so a
  crash mid-write tears at most the LAST line of the active chunk, and
  the reader skips unparseable lines: a torn chunk is invisible on
  reload, never a poisoned one;
- chunks rotate every ``Config.history_chunk_s`` seconds (start time in
  the filename), and rotation garbage-collects chunks that fell out of
  ``Config.history_retention_s`` — disk is bounded by construction;
- the ``series.json`` channel index (name -> kind) is rewritten
  tmp+``os.replace`` atomically, like every other sidecar in the repo.

Channel names are ``role/metric`` (plus ``{label=value,...}`` for
labeled series, e.g. a worker's ``wid``); histogram-derived quantiles
append ``-p50``/``-p99``. Timestamps are wall-clock (``time.time()``)
because the readers — :mod:`tpu_rl_torch.obs.report`,
:mod:`tpu_rl_torch.obs.compare` — run post-hoc and across runs.

When the plane is off (:func:`maybe_history` returns None) nothing is
constructed and every hot-path hook reduces to one ``is None`` check —
the same cost contract as the telemetry plane itself.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Iterable

from tpu_rl_torch.obs.registry import hist_quantile

CHUNK_PREFIX = "chunk-"
CHUNK_SUFFIX = ".jsonl"
SERIES_FILE = "series.json"

# Source-identity labels already encoded in the channel's role prefix —
# folding them into the label tail would split one logical series per
# process restart (pid churn).
_IDENTITY_LABELS = ("role", "host", "pid")

# Histogram-derived quantile channels recorded per hist family. p50 is
# the level, p99 the tail — the pair every SLO rule in the repo reads.
_HIST_QUANTILES = ((0.5, "-p50"), (0.99, "-p99"))


def channel_name(role: str, name: str, labels: dict | None = None) -> str:
    """``role/metric`` (+ ``{k=v,...}`` for non-identity labels)."""
    extra = {
        k: v for k, v in (labels or {}).items() if k not in _IDENTITY_LABELS
    }
    if not extra:
        return f"{role}/{name}"
    tail = ",".join(f"{k}={v}" for k, v in sorted(extra.items()))
    return f"{role}/{name}{{{tail}}}"


def flatten_snapshots(
    snaps: Iterable[tuple[dict, float]],
) -> tuple[dict[str, float], dict[str, str]]:
    """Aggregator ``all_snapshots()`` -> (``{channel: value}``,
    ``{channel: kind}``). Gauges last-write-wins, counters sum across
    sources sharing a channel (same role+name+labels from two pids is the
    restart case — the totals are what monitoring wants), histograms
    contribute interpolated p50/p99 (``hist_quantile``; empty hists
    contribute nothing — no-data stays explicit)."""
    samples: dict[str, float] = {}
    kinds: dict[str, str] = {}
    for snap, _age in snaps:
        role = str(snap.get("role", "?"))
        for name, labels, value in snap.get("gauges", ()):
            ch = channel_name(role, name, labels)
            samples[ch] = float(value)
            kinds[ch] = "gauge"
        for name, labels, value in snap.get("counters", ()):
            ch = channel_name(role, name, labels)
            if kinds.get(ch) == "counter":
                samples[ch] += float(value)
            else:
                samples[ch] = float(value)
                kinds[ch] = "counter"
        for name, labels, counts, _total, _count in snap.get("hists", ()):
            for q, suffix in _HIST_QUANTILES:
                v = hist_quantile(counts, q)
                if v is None:
                    continue
                ch = channel_name(role, name + suffix, labels)
                samples[ch] = float(v)
                kinds[ch] = "quantile"
    return samples, kinds


def downsample(
    points: list[tuple[float, float]], step: float, start: float | None = None
) -> list[dict]:
    """Fixed-width buckets over a sorted point list -> one row per
    non-empty bucket: ``{"t": bucket start, "n", "min", "max", "mean",
    "last"}``. Buckets align to ``start`` (default: the first point), so
    identical (start, step) queries over overlapping ranges agree."""
    if not points:
        return []
    step = float(step)
    assert step > 0, step
    t0 = float(points[0][0] if start is None else start)
    out: list[dict] = []
    cur_idx: int | None = None
    cur: dict | None = None
    for t, v in points:
        idx = int((t - t0) // step)
        if idx != cur_idx:
            if cur is not None:
                cur["mean"] = cur["_sum"] / cur["n"]
                del cur["_sum"]
                out.append(cur)
            cur_idx = idx
            cur = {
                "t": t0 + idx * step, "n": 0, "min": v, "max": v,
                "last": v, "_sum": 0.0,
            }
        cur["n"] += 1
        cur["min"] = min(cur["min"], v)
        cur["max"] = max(cur["max"], v)
        cur["last"] = v
        cur["_sum"] += v
    if cur is not None:
        cur["mean"] = cur["_sum"] / cur["n"]
        del cur["_sum"]
        out.append(cur)
    return out


def _chunk_start_ms(fname: str) -> int | None:
    if not (fname.startswith(CHUNK_PREFIX) and fname.endswith(CHUNK_SUFFIX)):
        return None
    try:
        return int(fname[len(CHUNK_PREFIX):-len(CHUNK_SUFFIX)])
    except ValueError:
        return None


class HistoryReader:
    """Read side over a history directory — shared by the live ``/query``
    endpoint, the offline report/compare CLIs, and autopilot rehydration.
    Stateless per call: every read re-lists chunks, so a reader opened on
    a LIVE directory (the HTTP endpoint) always sees the newest flushed
    rows, and torn tail lines are skipped, never raised."""

    def __init__(self, path: str):
        self.path = path

    def exists(self) -> bool:
        return os.path.isdir(self.path) and bool(self._chunks())

    def _chunks(self) -> list[tuple[int, str]]:
        try:
            names = os.listdir(self.path)
        except OSError:
            return []
        out = []
        for fname in names:
            start_ms = _chunk_start_ms(fname)
            if start_ms is not None:
                out.append((start_ms, os.path.join(self.path, fname)))
        out.sort()
        return out

    def series(self) -> dict[str, str]:
        """Channel -> kind. From the ``series.json`` index when present;
        a scan of the chunks otherwise (an index torn away by a crash
        degrades to a slower listing, never to silence)."""
        try:
            with open(os.path.join(self.path, SERIES_FILE)) as f:
                doc = json.load(f)
            if isinstance(doc, dict) and isinstance(doc.get("series"), dict):
                return dict(doc["series"])
        except (OSError, ValueError):
            pass
        names: dict[str, str] = {}
        for row in self._rows():
            for ch in row["s"]:
                names.setdefault(ch, "unknown")
        return names

    def _chunk_s_hint(self) -> float | None:
        """The writer's rotation period, from the series index. Lets the
        reader bound every chunk's coverage window without assuming a
        single writer (two stores sharing a dir interleave chunks)."""
        try:
            with open(os.path.join(self.path, SERIES_FILE)) as f:
                doc = json.load(f)
            v = float(doc["chunk_s"])
            return v if v > 0 else None
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _rows(
        self, start: float | None = None, end: float | None = None
    ) -> Iterable[dict]:
        chunks = self._chunks()
        chunk_s = self._chunk_s_hint() if start is not None else None
        for start_ms, path in chunks:
            # Rows in a chunk are never earlier than its filename start,
            # and (when the rotation period is known) never later than
            # start + chunk_s — chunks outside the query range are skipped
            # without opening them.
            if end is not None and start_ms / 1000.0 > end:
                continue
            if (
                start is not None
                and chunk_s is not None
                and start_ms / 1000.0 + chunk_s < start
            ):
                continue
            try:
                with open(path) as f:
                    lines = f.readlines()
            except OSError:
                continue
            for line in lines:
                try:
                    row = json.loads(line)
                except ValueError:
                    continue  # torn tail line: invisible by design
                if not isinstance(row, dict) or "t" not in row:
                    continue
                t = float(row["t"])
                if start is not None and t < start:
                    continue
                if end is not None and t > end:
                    continue
                if isinstance(row.get("s"), dict):
                    yield row

    def points(
        self,
        metric: str,
        start: float | None = None,
        end: float | None = None,
    ) -> list[tuple[float, float]]:
        out = []
        for row in self._rows(start, end):
            v = row["s"].get(metric)
            if v is not None:
                out.append((float(row["t"]), float(v)))
        out.sort(key=lambda p: p[0])
        return out

    def span(self) -> tuple[float, float] | None:
        """(first t, last t) across all rows; None on an empty store."""
        t0 = t1 = None
        for row in self._rows():
            t = float(row["t"])
            t0 = t if t0 is None else min(t0, t)
            t1 = t if t1 is None else max(t1, t)
        return None if t0 is None else (t0, t1)

    # ------------------------------------------------------------ HTTP query
    def http_query(self, params: dict) -> tuple[int, dict]:
        """The ``GET /query`` contract: without ``metric``, the series
        listing; with it, raw ``[t, v]`` points (``step`` absent/0) or
        min/max/mean/last downsampled rows. Returns (status, payload)."""
        metric = params.get("metric")
        if not metric:
            series = self.series()
            return 200, {
                "series": [
                    {"name": name, "kind": kind}
                    for name, kind in sorted(series.items())
                ],
            }
        try:
            start = float(params["start"]) if params.get("start") else None
            end = float(params["end"]) if params.get("end") else None
            step = float(params.get("step") or 0.0)
        except ValueError:
            return 400, {"error": "start/end/step must be numbers"}
        if step < 0:
            return 400, {"error": "step must be >= 0"}
        pts = self.points(metric, start, end)
        payload: dict = {
            "metric": metric, "start": start, "end": end, "n": len(pts),
        }
        if step > 0:
            payload["step"] = step
            payload["buckets"] = downsample(pts, step, start=start)
        else:
            payload["points"] = [[t, v] for t, v in pts]
        return 200, payload


class TimeSeriesStore(HistoryReader):
    """The write side: an open append handle on the active chunk plus the
    rotation/retention/series-index machinery. Inherits every read path
    from :class:`HistoryReader` (the live ``/query`` endpoint is the
    same code the offline CLIs run)."""

    def __init__(
        self,
        path: str,
        chunk_s: float = 60.0,
        retention_s: float = 3600.0,
        anomaly=None,
        clock: Callable[[], float] = time.time,
    ):
        super().__init__(path)
        assert chunk_s > 0 and retention_s > 0, (chunk_s, retention_s)
        self.chunk_s = float(chunk_s)
        self.retention_s = float(retention_s)
        self.anomaly = anomaly
        self._clock = clock
        self._f = None
        self._chunk_start: float | None = None
        self._kinds: dict[str, str] = {}
        self.n_rows = 0
        self.n_rotated = 0
        self.n_gc = 0
        os.makedirs(path, exist_ok=True)
        # Resume: inherit the prior run's channel index so /query's series
        # listing covers pre-restart chunks still inside retention.
        self._kinds.update(HistoryReader.series(self))

    # ------------------------------------------------------------------ write
    def record(
        self,
        agg,
        now: float | None = None,
        extra: dict[str, float] | None = None,
    ) -> dict[str, float]:
        """One exporter-cadence tick: flatten the aggregator, append the
        row, feed the anomaly detector, publish the store's own counters
        into the aggregator's registry. ``extra`` merges caller-supplied
        channels into the same row (kind ``signal`` — the autopilot
        persists its scraped signal windows this way). Returns the
        flattened samples."""
        samples, kinds = flatten_snapshots(agg.all_snapshots())
        if extra:
            for ch, v in extra.items():
                samples[ch] = float(v)
                kinds.setdefault(ch, "signal")
        self.append(samples, kinds=kinds, t=now)
        if self.anomaly is not None:
            self.anomaly.observe(samples, kinds, registry=agg.registry)
        reg = agg.registry
        reg.counter("history-rows").set_total(self.n_rows)
        reg.counter("history-chunks-rotated").set_total(self.n_rotated)
        reg.counter("history-chunks-gc").set_total(self.n_gc)
        return samples

    def append(
        self,
        samples: dict[str, float],
        kinds: dict[str, str] | None = None,
        t: float | None = None,
    ) -> None:
        t = self._clock() if t is None else float(t)
        self._rotate_if_due(t)
        line = json.dumps({"t": t, "s": samples}, separators=(",", ":"))
        self._f.write(line + "\n")
        self._f.flush()
        self.n_rows += 1
        if kinds and not (kinds.keys() <= self._kinds.keys()):
            self._kinds.update(kinds)
            self._write_series_index()

    def _rotate_if_due(self, t: float) -> None:
        if self._f is not None and t - self._chunk_start < self.chunk_s:
            return
        if self._f is not None:
            self._f.close()
            self.n_rotated += 1
        self._chunk_start = t
        fname = f"{CHUNK_PREFIX}{int(t * 1000):015d}{CHUNK_SUFFIX}"
        self._f = open(os.path.join(self.path, fname), "a")
        self._gc(t)

    def _gc(self, now: float) -> None:
        """Drop chunks wholly older than the retention horizon. A chunk's
        coverage ends ``chunk_s`` past its filename start; the active
        chunk is never eligible (its start is ``now``)."""
        horizon = now - self.retention_s
        for start_ms, path in self._chunks():
            if start_ms / 1000.0 + self.chunk_s < horizon:
                try:
                    os.remove(path)
                    self.n_gc += 1
                except OSError:
                    pass  # already gone (a sibling store GC'd it)

    def series(self) -> dict[str, str]:
        return dict(self._kinds)  # the live index; no disk walk

    def _write_series_index(self) -> None:
        path = os.path.join(self.path, SERIES_FILE)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump({"series": self._kinds, "chunk_s": self.chunk_s}, f)
            os.replace(tmp, path)
        except OSError:
            pass  # index is a cache; chunks remain the source of truth

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


# ------------------------------------------------------------------ gating
def history_path(cfg) -> str | None:
    """Where this config's history lives: ``Config.history_dir`` when
    set, else ``result_dir/history``, else nowhere (None)."""
    if getattr(cfg, "history_dir", None):
        return cfg.history_dir
    if cfg.result_dir is not None:
        return os.path.join(cfg.result_dir, "history")
    return None


def maybe_history(cfg) -> TimeSeriesStore | None:
    """The plane's single gate (the ``maybe_aggregator`` discipline): a
    store exists iff telemetry is on AND the history has a disk home.
    Off = None everywhere = one ``is None`` check on the hot path."""
    path = history_path(cfg) if cfg.telemetry_enabled else None
    if path is None:
        return None
    from tpu_rl_torch.obs.anomaly import AnomalyDetector

    return TimeSeriesStore(
        path,
        chunk_s=cfg.history_chunk_s,
        retention_s=cfg.history_retention_s,
        anomaly=AnomalyDetector(),
    )
