"""Exporters off the :class:`~tpu_rl_torch.obs.aggregator.TelemetryAggregator`.

The port's own copy of ``tpu_rl.obs.exporters``, unchanged in behaviour.

Three sinks, all stdlib-only (the container has no prometheus_client):

- :func:`render_prometheus` — Prometheus text exposition (format 0.0.4) over
  every source's snapshot, each sample labeled ``role``/``host``/``pid`` plus
  the metric's own labels. Served by :class:`TelemetryHTTPServer` at
  ``/metrics`` together with a staleness-aware ``/healthz``, on
  ``Config.telemetry_port`` (0 = no server, no socket);
- :class:`JsonExporter` — rolling atomic snapshot of the whole plane at
  ``result_dir/telemetry.json`` (tmp + rename, so a scraper never reads a
  torn file);
- :class:`TensorboardExporter` — folds fleet counters/gauges into the same
  event-file machinery the learner already uses (``utils.metrics.make_writer``),
  so fleet health lands next to the loss curves without a new viewer.

Everything here reads aggregator state; nothing writes it — exporters can be
added or dropped without touching the collection path.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl

from tpu_rl_torch.obs.aggregator import TelemetryAggregator
from tpu_rl_torch.obs.registry import HIST_BUCKETS, hist_quantile

_NAME_OK = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def sanitize_name(name: str) -> str:
    """Repo metric names (dash convention) -> Prometheus identifiers."""
    out = "".join(ch if ch in _NAME_OK else "_" for ch in name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(value: float) -> str:
    f = float(value)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_str(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{sanitize_name(str(k))}="{_escape_label(str(v))}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def render_prometheus(agg: TelemetryAggregator, now: float | None = None) -> str:
    """Deterministic exposition: samples sorted by (name, labels) within
    each metric family, one ``# TYPE`` line per family. Counters keep their
    registered names (no ``_total`` rewrite) so dashboards match the
    tensorboard scalar names one-to-one."""
    counters: dict[str, list] = {}
    gauges: dict[str, list] = {}
    hists: dict[str, list] = {}
    for snap, _age in agg.all_snapshots(now):
        base = {
            "role": str(snap.get("role", "?")),
            "host": str(snap.get("host", "?")),
            "pid": str(snap.get("pid", "?")),
        }
        for name, labels, value in snap.get("counters", ()):
            counters.setdefault(name, []).append(({**base, **labels}, value))
        for name, labels, value in snap.get("gauges", ()):
            gauges.setdefault(name, []).append(({**base, **labels}, value))
        for name, labels, counts, total, count in snap.get("hists", ()):
            hists.setdefault(name, []).append(({**base, **labels}, counts, total, count))

    lines: list[str] = []
    for kind, table in (("counter", counters), ("gauge", gauges)):
        for name in sorted(table):
            pname = sanitize_name(name)
            lines.append(f"# TYPE {pname} {kind}")
            for labels, value in sorted(table[name], key=lambda s: _labels_str(s[0])):
                lines.append(f"{pname}{_labels_str(labels)} {_fmt(value)}")
    for name in sorted(hists):
        pname = sanitize_name(name)
        lines.append(f"# TYPE {pname} histogram")
        for labels, counts, total, count in sorted(
            hists[name], key=lambda s: _labels_str(s[0])
        ):
            cum = 0
            # counts carries one extra overflow slot past the last bound; the
            # +Inf line below renders it, so the truncating zip is deliberate.
            for bound, c in zip(HIST_BUCKETS, counts, strict=False):
                cum += c
                le = {**labels, "le": repr(bound)}
                lines.append(f"{pname}_bucket{_labels_str(le)} {cum}")
            le = {**labels, "le": "+Inf"}
            lines.append(f"{pname}_bucket{_labels_str(le)} {count}")
            lines.append(f"{pname}_sum{_labels_str(labels)} {_fmt(total)}")
            lines.append(f"{pname}_count{_labels_str(labels)} {count}")
            # Pre-interpolated tail quantile (registry.hist_quantile) so
            # dashboards without PromQL histogram_quantile() — and the bare
            # curl in the README — still read a p99 directly.
            p99 = hist_quantile(counts, 0.99)
            if p99 is not None:
                lines.append(f"{pname}_p99{_labels_str(labels)} {_fmt(p99)}")
    return "\n".join(lines) + "\n"


def render_healthz(
    agg: TelemetryAggregator, now: float | None = None
) -> tuple[int, dict]:
    """(HTTP status, body): 200 while every known role has a fresh source,
    503 once any goes silent past the aggregator's staleness window. Roles
    never seen simply aren't listed — liveness is about sources that exist."""
    roles = agg.role_health(now)
    ok = all(r["alive"] for r in roles.values())
    body = {
        "status": "ok" if ok else "stale",
        "stale_after_s": agg.stale_after_s,
        "roles": {
            role: {
                "alive": bool(r["alive"]),
                "sources": int(r["sources"]),
                "age_s": round(float(r["age_s"]), 3),
            }
            for role, r in sorted(roles.items())
        },
    }
    return (200 if ok else 503), body


class TelemetryHTTPServer:
    """stdlib HTTP thread serving ``/metrics`` (Prometheus text),
    ``/healthz`` (JSON liveness) and — when the owner wires the matching
    callable — ``/tracez`` (the role's live span ring + clock estimates),
    ``/slo`` (last SLO verdict: 200 while every rule holds, 503 on any hard
    failure, so probes can alert off the status line alone), ``/goodput``
    (wall-clock attribution breakdown + straggler top-k), ``/autopilot``
    (the autopilot controller's live status: counts, recent actions with
    reasons, per-rule cooldowns), ``/query?metric=&start=&end=&step=``
    (range queries over the run-history store when the owner wires a
    ``query`` callable — raw points, or min/max/mean/last buckets when
    ``step`` is set; without ``metric``, the series listing) and
    ``/prof?ms=N``
    (bounded on-demand ``torch.profiler`` capture; an overlapping request is
    refused with 409). Daemonized: it must never hold the storage process
    open at shutdown, and :meth:`close` is idempotent and bounded so cluster
    e2e tests can tear servers down back-to-back without leaking the
    socket."""

    def __init__(
        self,
        agg: TelemetryAggregator,
        port: int,
        host: str = "",
        tracez=None,
        slo=None,
        prof=None,
        goodput=None,
        autopilot=None,
        query=None,
    ):
        self.agg = agg
        self.tracez = tracez  # callable -> JSON-able dict, or None
        self.slo = slo  # callable -> SLO report dict, or None
        self.prof = prof  # callable (ms|None) -> (started, path|reason)
        self.goodput = goodput  # callable -> goodput/straggler doc, or None
        self.autopilot = autopilot  # callable -> autopilot status doc, or None
        self.query = query  # callable (params dict) -> (status, doc), or None

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    body = render_prometheus(outer.agg).encode()
                    ctype, status = "text/plain; version=0.0.4", 200
                elif path == "/healthz":
                    status, payload = render_healthz(outer.agg)
                    body = (json.dumps(payload, indent=1) + "\n").encode()
                    ctype = "application/json"
                elif path == "/tracez":
                    payload = (
                        outer.tracez() if outer.tracez is not None
                        else {"trace": None}
                    )
                    body = (json.dumps(payload) + "\n").encode()
                    ctype, status = "application/json", 200
                elif path == "/slo":
                    if outer.slo is None:
                        payload, status = {"error": "no slo rules configured"}, 404
                    else:
                        payload = outer.slo()
                        status = 200 if payload.get("ok", True) else 503
                    body = (json.dumps(payload, indent=1) + "\n").encode()
                    ctype = "application/json"
                elif path == "/goodput":
                    if outer.goodput is None:
                        payload, status = {"error": "goodput ledger not wired"}, 404
                    else:
                        payload, status = outer.goodput(), 200
                    body = (json.dumps(payload, indent=1) + "\n").encode()
                    ctype = "application/json"
                elif path == "/autopilot":
                    if outer.autopilot is None:
                        payload, status = {"error": "no autopilot wired"}, 404
                    else:
                        payload, status = outer.autopilot(), 200
                    body = (json.dumps(payload, indent=1) + "\n").encode()
                    ctype = "application/json"
                elif path == "/query":
                    if outer.query is None:
                        payload = {"error": "history store not wired"}
                        status = 404
                    else:
                        status, payload = outer.query(
                            dict(parse_qsl(query))
                        )
                    body = (json.dumps(payload) + "\n").encode()
                    ctype = "application/json"
                elif path == "/prof":
                    status, payload = outer._handle_prof(query)
                    body = (json.dumps(payload) + "\n").encode()
                    ctype = "application/json"
                else:
                    body, ctype, status = b"not found\n", "text/plain", 404
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                # One request per connection: a keep-alive scraper must not
                # pin a handler thread across the server's close().
                self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes must not spam role stdout
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        # Don't let server_close() block on a wedged in-flight handler —
        # handlers are daemon threads, shutdown already stopped the accept
        # loop, and close() promises to return promptly.
        self._httpd.block_on_close = False
        self.port = self._httpd.server_address[1]  # resolved when port=0
        self._closed = False
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="telemetry-http",
            daemon=True,
        )
        self._thread.start()

    def _handle_prof(self, query: str) -> tuple[int, dict]:
        if self.prof is None:
            return 404, {"error": "profiler capture not wired"}
        ms = None
        for part in query.split("&"):
            key, sep, value = part.partition("=")
            if key == "ms" and sep:
                try:
                    ms = int(value)
                except ValueError:
                    return 400, {"error": f"bad ms value {value!r}"}
                if ms <= 0:
                    return 400, {"error": "ms must be positive"}
        started, detail = self.prof(ms)
        if not started:
            return 409, {"error": detail}
        return 200, {"started": True, "trace_dir": detail, "ms": ms}

    def close(self) -> None:
        """Stop accepting, release the listening socket, reap the serve
        thread. Safe to call more than once (role finallys may overlap)."""
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


class JsonExporter:
    """Rolling ``telemetry.json``: the whole plane as one JSON document,
    rewritten atomically every ``interval_s``. Cheap enough to leave on —
    a few KB per write at fleet scale."""

    def __init__(self, agg: TelemetryAggregator, path: str, interval_s: float = 2.0):
        self.agg = agg
        self.path = path
        self.interval_s = float(interval_s)
        self._last = float("-inf")
        self.n_written = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def maybe_export(self, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        if now - self._last < self.interval_s:
            return False
        self._last = now
        status, health = render_healthz(self.agg)
        doc = {
            "ts": time.time(),
            "healthz": health,
            "sources": [
                {**snap, "age_s": round(age, 3)}
                for snap, age in self.agg.all_snapshots()
            ],
        }
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)  # readers never see a torn file
        self.n_written += 1
        return True


class TensorboardExporter:
    """Fleet counters/gauges -> tensorboard scalars under ``telemetry/``,
    via the same writer factory the learner logger uses. Histograms export
    their running mean (sum/count) — the full distribution lives in
    Prometheus. Steps are the per-source snapshot ``seq`` so each series
    advances monotonically regardless of wall clock."""

    def __init__(self, writer):
        self.w = writer

    def export(self, agg: TelemetryAggregator) -> None:
        for snap, _age in agg.all_snapshots():
            role = snap.get("role", "?")
            step = int(snap.get("seq", 0))
            for name, labels, value in snap.get("counters", ()):
                self.w.add_scalar(self._tag(role, name, labels), float(value), step)
            for name, labels, value in snap.get("gauges", ()):
                self.w.add_scalar(self._tag(role, name, labels), float(value), step)
            for name, labels, _counts, total, count in snap.get("hists", ()):
                if count:
                    self.w.add_scalar(
                        self._tag(role, name + "-mean", labels), total / count, step
                    )
        self.w.flush()

    @staticmethod
    def _tag(role: str, name: str, labels: dict[str, str]) -> str:
        wid = labels.get("wid")
        suffix = f"/w{wid}" if wid not in (None, "") else ""
        return f"telemetry/{role}/{name}{suffix}"

    def close(self) -> None:
        self.w.close()
