"""Zero-dependency live fleet dashboard: ``python -m tpu_rl_torch.obs.top``
— the port's own copy of ``tpu_rl.obs.top``, unchanged in behaviour (its
frames are the same text from the same documents).

Polls the storage (or colocated) telemetry HTTP server — ``/metrics``
(Prometheus text), ``/goodput`` (ledger breakdown + straggler top-k) and
``/slo`` (verdicts), plus ``/autopilot`` when a pilot is wired — and
renders a terminal view on stdlib curses: per-role goodput bars, bucket
breakdowns, throughput/MFU, the LEARN panel (entropy/KL/ESS update-math
diagnostics with the ESS-vs-staleness curve from the
``learner-diag-by-stale-*`` families), the straggler list, autopilot
replica/worker counts with recent actions and per-rule cooldown status,
and SLO verdicts. When the run-history plane is on, each panel gains a
unicode-block sparkline fed from ``GET /query`` (blank when the plane
is off). Nothing beyond the standard library; point it at
any fleet with the plane on::

    python -m tpu_rl_torch.obs.top --url http://learner-host:9090/metrics

``--once`` renders a single frame to stdout without curses (no tty
needed) — the shape a script or a CI job drives. ``q`` quits the
live view. The frame builder is a pure function over the fetched
documents (``build_frame``), so the render is golden-testable with a
mocked terminal.
"""

from __future__ import annotations

import argparse
import json
import re
import urllib.error
import urllib.request
from urllib.parse import quote

from tpu_rl_torch.obs.goodput import BUCKETS

DEFAULT_URL = "http://127.0.0.1:9090/metrics"
_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


# ------------------------------------------------------------------ fetch
def fetch(url: str, timeout: float = 2.0):
    """GET → (status, body str). An HTTPError with a body (the 503 /slo
    failing-verdict case) is a real answer, not a transport failure."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    except OSError as e:
        return None, str(e)


def fetch_json(url: str, timeout: float = 2.0):
    status, body = fetch(url, timeout)
    if status is None:
        return None
    try:
        return json.loads(body)
    except ValueError:
        return None


# ------------------------------------------------------------------ parse
def parse_prometheus(text: str) -> list:
    """Exposition text → [(name, labels dict, value)] (comments skipped)."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        m = _SAMPLE.match(head)
        if m is None:
            continue
        try:
            value = float(val)
        except ValueError:
            continue
        labels = dict(_LABEL.findall(m.group(3) or ""))
        out.append((m.group(1), labels, value))
    return out


def _source_key(role: str, labels: dict) -> str:
    wid = labels.get("wid")
    return f"{role} wid={wid}" if wid is not None else role


def goodput_rows(samples: list) -> dict:
    """Per-source goodput view from the ``*_goodput_ratio`` /
    ``*_time_*_ratio`` gauge families → {display key: {goodput, buckets}}."""
    rows: dict = {}
    bucket_names = {b.replace("-", "_"): b for b in BUCKETS}
    for name, labels, value in samples:
        if name.endswith("_goodput_ratio"):
            role = name[: -len("_goodput_ratio")]
            key = _source_key(role, labels)
            rows.setdefault(key, {"goodput": 0.0, "buckets": {}})
            rows[key]["goodput"] = value
        elif name.endswith("_ratio") and "_time_" in name:
            role, _, rest = name.partition("_time_")
            bucket = bucket_names.get(rest[: -len("_ratio")])
            if bucket is None:
                continue
            key = _source_key(role, labels)
            rows.setdefault(key, {"goodput": 0.0, "buckets": {}})
            rows[key]["buckets"][bucket] = value
    return rows


def _scalar(samples: list, name: str):
    vals = [v for n, _l, v in samples if n == name]
    return max(vals) if vals else None


_DIAG_GLOBAL_PREFIX = "learner_diag_"
_DIAG_BUCKET_PREFIX = "learner_diag_by_stale_"


def learn_rows(samples: list) -> tuple[dict, dict]:
    """Learning-dynamics view from the ``learner_diag_*`` gauge families →
    (global {metric: value}, per-staleness {bucket label: {metric: value}}).
    Histogram families (``*_hist_*``) are skipped — the panel shows the
    current gauge values, not the distribution."""
    glob: dict = {}
    buckets: dict = {}
    for name, labels, value in samples:
        if "_hist" in name:
            continue
        if name.startswith(_DIAG_BUCKET_PREFIX):
            label = labels.get("stale_bucket")
            if label is None:
                continue
            metric = name[len(_DIAG_BUCKET_PREFIX):]
            buckets.setdefault(label, {})[metric] = value
        elif name.startswith(_DIAG_GLOBAL_PREFIX):
            glob[name[len(_DIAG_GLOBAL_PREFIX):]] = value
    return glob, buckets


def _stale_sort_key(label: str) -> float:
    head = label.split("-")[0].rstrip("+")
    try:
        return float(head)
    except ValueError:
        return float("inf")


def bar(frac: float, width: int = 20) -> str:
    frac = min(1.0, max(0.0, frac))
    filled = round(frac * width)
    return "#" * filled + "-" * (width - filled)


# --------------------------------------------------------------- sparklines
SPARK_BLOCKS = "▁▂▃▄▅▆▇█"

# History-channel tails worth a sparkline (suffix match against the
# ``/query`` series listing; labeled per-wid channels are skipped — the
# panel shows role-level trends, the straggler list covers outliers).
SPARK_SUFFIXES = (
    "-env-steps-per-s",
    "-throughput",
    "-updates-per-s",
    "-mfu",
    "-goodput-ratio",
    "-mean-episode-return",
    "-diag-ess",
)
_SPARK_FETCH_CAP = 12  # bound the per-frame /query fan-out
_SPARK_WIDTH = 24


def sparkline(values: list, width: int = _SPARK_WIDTH) -> str:
    """Values -> a fixed-width unicode-block trend line (empty string on
    no data). Longer series are bucket-mean compressed to ``width``; a
    flat series renders mid-height, not empty."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:
        per = len(vals) / width
        vals = [
            sum(chunk) / len(chunk)
            for chunk in (
                vals[int(i * per): max(int(i * per) + 1, int((i + 1) * per))]
                for i in range(width)
            )
        ]
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return SPARK_BLOCKS[3] * len(vals)
    scale = (len(SPARK_BLOCKS) - 1) / (hi - lo)
    return "".join(SPARK_BLOCKS[int((v - lo) * scale)] for v in vals)


def collect_history(
    base: str, timeout: float = 2.0, fetch_json_fn=fetch_json
) -> dict | None:
    """Poll the run-history plane once: the ``/query`` series listing,
    then raw points for every spark-worthy channel -> ``{channel tail:
    [values]}``. Returns None when the plane is off (the endpoint 404s
    with an error body, or the server predates it) — every panel then
    renders without its trend line, never an error."""
    listing = fetch_json_fn(base + "/query", timeout)
    if not isinstance(listing, dict) or "series" not in listing:
        return None
    out: dict = {}
    for row in listing.get("series", ()):
        name = (row or {}).get("name")
        if not isinstance(name, str) or "{" in name:
            continue
        tail = name.rpartition("/")[2]
        if tail in out or not tail.endswith(SPARK_SUFFIXES):
            continue
        if len(out) >= _SPARK_FETCH_CAP:
            break
        doc = fetch_json_fn(
            base + "/query?metric=" + quote(name, safe=""), timeout
        )
        points = (doc or {}).get("points") if isinstance(doc, dict) else None
        if points:
            out[tail] = [p[1] for p in points if isinstance(p, list)]
    return out


# ------------------------------------------------------------------ frame
_HOT_METRICS = (
    ("learner tps", "learner_throughput", "{:,.0f}"),
    ("colocated tps", "colocated_env_steps_per_s", "{:,.0f}"),
    ("mfu", "learner_mfu", "{:.2%}"),
    ("colocated mfu", "colocated_mfu", "{:.2%}"),
    ("recompiles", "learner_xla_recompiles", "{:.0f}"),
)


def _spark(history: dict | None, tail: str) -> str:
    vals = (history or {}).get(tail)
    return sparkline(vals) if vals else ""


def build_frame(
    samples: list,
    goodput_doc: dict | None,
    slo_doc: dict | None,
    url: str = DEFAULT_URL,
    width: int = 100,
    autopilot_doc: dict | None = None,
    history: dict | None = None,
) -> list:
    """The whole dashboard as a list of text lines (pure; golden-tested).
    ``history`` is the :func:`collect_history` channel-tail dict; None
    (plane off) renders every panel without its trend line."""
    lines = [f"tpu_rl top — {url}  (q quits)", ""]
    rows = goodput_rows(samples)
    lines.append("GOODPUT (compute share of wall time, per role)")
    if not rows:
        lines.append("  no goodput gauges yet (ledger warming up?)")
    for key in sorted(rows):
        row = rows[key]
        g = row["goodput"]
        spark = _spark(history, f"{key}-goodput-ratio")
        tail = f"  {spark}" if spark else ""
        lines.append(f"  {key:<16} [{bar(g)}] {g * 100:5.1f}%{tail}")
        top = sorted(
            row["buckets"].items(), key=lambda kv: -kv[1]
        )[:4]
        detail = "  ".join(f"{b} {v * 100:.0f}%" for b, v in top if v > 0)
        if detail:
            lines.append(f"  {'':<16} {detail}")
    lines.append("")

    hot = []
    for label, metric, fmt in _HOT_METRICS:
        v = _scalar(samples, metric)
        if v is not None:
            hot.append(f"{label} {fmt.format(v)}")
    if hot:
        lines.append("THROUGHPUT  " + "   ".join(hot))
        for label, metric, _fmt in _HOT_METRICS:
            spark = _spark(history, metric.replace("_", "-"))
            if spark:
                lines.append(f"  {label:<14} {spark}")
        lines.append("")

    diag, diag_buckets = learn_rows(samples)
    if diag or diag_buckets:
        lines.append("LEARN (update-math diagnostics; learner-diag-* gauges)")
        head = []
        for label, metric, fmt in (
            ("entropy", "entropy", "{:.3f}"),
            ("kl", "approx_kl", "{:.4f}"),
            ("ess", "ess", "{:.2f}"),
            ("clip", "clip_frac", "{:.2f}"),
            ("ev", "explained_variance", "{:.2f}"),
            ("upd-ratio", "update_ratio", "{:.2e}"),
        ):
            v = diag.get(metric)
            if v is not None:
                head.append(f"{label} {fmt.format(v)}")
        if head:
            lines.append("  " + "   ".join(head))
        grads = [
            f"{g} {diag[f'grad_norm_{g}']:.2e}"
            for g in ("torso", "cell", "heads")
            if f"grad_norm_{g}" in diag
        ]
        if grads:
            lines.append("  grad-norm  " + "   ".join(grads))
        # ESS vs staleness: THE off-policy health curve (collapse at high
        # lag is the signal the update:data controller will regulate on).
        for label in sorted(diag_buckets, key=_stale_sort_key):
            b = diag_buckets[label]
            ess = b.get("ess")
            if ess is None:
                continue
            rows = b.get("rows")
            tail = f"  ({rows:.0f} rows)" if rows is not None else ""
            lines.append(
                f"  stale {label:>5}  [{bar(ess)}] ess {ess:.2f}{tail}"
            )
        lines.append("")

    lines.append("STRAGGLERS (robust z vs fleet median; report-only)")
    stragglers = (goodput_doc or {}).get("stragglers") or []
    if not stragglers:
        lines.append("  none")
    for e in stragglers:
        sig = e.get("signals", {})
        rate = sig.get("frame-rate")
        stale = sig.get("staleness")
        rtt = sig.get("rtt")
        lines.append(
            f"  wid {e.get('wid')}: score {e.get('score', 0):.1f}"
            f"  rate {rate if rate is not None else '—'}/s"
            f"  staleness {stale if stale is not None else '—'}"
            f"  rtt {rtt if rtt is not None else '—'}"
        )
    lines.append("")

    if autopilot_doc is not None:
        lines.append(
            f"AUTOPILOT  replicas {autopilot_doc.get('replicas', '—')}"
            f"/{autopilot_doc.get('replica_capacity', '—')}"
            f"  workers {autopilot_doc.get('workers', '—')}"
            f"  actions {(autopilot_doc.get('counts') or {}).get('actions', 0)}"
        )
        actions = autopilot_doc.get("actions") or []
        if not actions:
            lines.append("  no actions yet")
        for a in actions[-5:]:
            lines.append(
                f"  {a.get('action', '?'):<10} {a.get('target', '?'):<9}"
                f" {a.get('from', '?')}->{a.get('to', '?')}"
                f"  {a.get('reason', '')}"
            )
        cooldowns = autopilot_doc.get("cooldowns") or {}
        for rule, remaining in sorted(cooldowns.items()):
            state = "armed" if remaining <= 0 else f"cooldown {remaining:.1f}s"
            lines.append(f"  [{state:>14}] {rule}")
        lines.append("")

    if slo_doc is not None:
        ok = slo_doc.get("ok")
        verdict = "PASS" if ok else ("no data" if ok is None else "FAIL")
        lines.append(f"SLO  {verdict}")
        for rule in slo_doc.get("rules", []):
            if not isinstance(rule, dict):
                lines.append(f"  {rule}")
                continue
            spec = rule.get("rule") or rule.get("spec") or "?"
            r_ok = rule.get("ok")
            mark = "ok " if r_ok else ("?? " if r_ok is None else "FAIL")
            val = rule.get("value")
            tail = f"  (value {val})" if val is not None else ""
            lines.append(f"  [{mark}] {spec}{tail}")
    else:
        lines.append("SLO  (no /slo endpoint — no slo_spec configured)")
    return [ln[:width] for ln in lines]


def collect(url: str, timeout: float = 2.0):
    """Fetch all five endpoints once → (samples, goodput, slo, autopilot,
    history, ok). ``/autopilot`` is None on fleets without the pilot
    wired (the endpoint 404s with a JSON error body — filtered here);
    ``history`` is None on fleets without the run-history plane."""
    base = url.rsplit("/", 1)[0] if url.endswith("/metrics") else url
    status, body = fetch(url, timeout)
    ok = status == 200
    samples = parse_prometheus(body) if ok else []
    goodput_doc = fetch_json(base + "/goodput", timeout)
    slo_doc = fetch_json(base + "/slo", timeout)
    autopilot_doc = fetch_json(base + "/autopilot", timeout)
    if isinstance(autopilot_doc, dict) and "error" in autopilot_doc:
        autopilot_doc = None
    history = collect_history(base, timeout)
    return samples, goodput_doc, slo_doc, autopilot_doc, history, ok


# ----------------------------------------------------------------- curses
def draw(stdscr, lines: list) -> None:
    import curses

    stdscr.erase()
    h, w = stdscr.getmaxyx()
    for y, line in enumerate(lines[: max(0, h - 1)]):
        try:
            stdscr.addnstr(y, 0, line, max(1, w - 1))
        except curses.error:
            pass  # terminal shrank mid-draw: clip, don't crash
    stdscr.refresh()


def _loop(stdscr, args) -> int:
    import curses

    try:
        curses.curs_set(0)
    except curses.error:
        pass
    stdscr.timeout(int(args.interval * 1000))
    while True:
        samples, goodput_doc, slo_doc, ap_doc, history, ok = collect(
            args.url, args.timeout
        )
        lines = build_frame(
            samples, goodput_doc, slo_doc, url=args.url,
            autopilot_doc=ap_doc, history=history,
        )
        if not ok:
            lines.insert(1, f"  !! /metrics unreachable at {args.url}")
        draw(stdscr, lines)
        ch = stdscr.getch()
        if ch in (ord("q"), ord("Q")):
            return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_rl_torch.obs.top",
        description="live fleet dashboard over /metrics + /goodput + /slo",
    )
    ap.add_argument("--url", default=DEFAULT_URL, help="metrics endpoint")
    ap.add_argument("--interval", type=float, default=2.0, help="poll seconds")
    ap.add_argument("--timeout", type=float, default=2.0, help="fetch timeout")
    ap.add_argument(
        "--once", action="store_true",
        help="render one frame to stdout (no curses, no tty) and exit",
    )
    args = ap.parse_args(argv)

    if args.once:
        samples, goodput_doc, slo_doc, ap_doc, history, ok = collect(
            args.url, args.timeout
        )
        frame = build_frame(
            samples, goodput_doc, slo_doc, url=args.url,
            autopilot_doc=ap_doc, history=history,
        )
        print("\n".join(frame))
        return 0 if ok else 1

    import curses

    return curses.wrapper(_loop, args)


if __name__ == "__main__":
    raise SystemExit(main())
