"""Post-hoc run reports off the history store + audit jsonl streams.

The port's own copy of ``tpu_rl.obs.report``, unchanged in behaviour.

``python -m tpu_rl_torch.obs.report <result_dir>`` renders three artifacts next
to the run's history directory:

- ``report.json`` — the machine-readable summary (channel stats + event
  timeline) the report tests schema-pin and other tooling can consume;
- ``report.md`` — the human summary: one stats row per charted channel,
  one timeline row per fleet event;
- ``report.html`` — self-contained (inline SVG, no JS, no external
  assets): one sparkline chart per channel with chaos / rollback /
  resume / population / autopilot events overlaid as vertical rules.

Events come from the unified :mod:`tpu_rl_torch.obs.audit` jsonl streams; a
stream that does not exist contributes nothing (a run without chaos has
no chaos events — that is data, not an error). Channels default to the
fleet-health set every prior plane publishes (throughput, MFU, goodput
ratios, staleness quantiles, learn-diag ESS, episode return) and can be
overridden with ``--channels`` fnmatch patterns.
"""

from __future__ import annotations

import argparse
import fnmatch
import html
import json
import os
import sys
import time

from tpu_rl_torch.obs.history import HistoryReader, downsample

# The audit streams overlaid as report events: filename -> event kind.
EVENT_STREAMS = (
    ("chaos.jsonl", "chaos"),
    ("learner_rollback.jsonl", "rollback"),
    ("learner_resume.jsonl", "resume"),
    ("population.jsonl", "population"),
    ("autopilot.jsonl", "autopilot"),
)

# Default charted channels — the cross-plane health set (fnmatch, matched
# against ``role/metric`` channel names).
DEFAULT_CHANNELS = (
    "*-env-steps-per-s",
    "*-updates-per-s",
    "*-mean-episode-return",
    "*-mfu",
    "*-goodput-ratio",
    "*/policy-staleness-updates-p99",
    "*/learner-diag-ess*",
    "*/learner-update-index",
)

_EVENT_COLORS = {
    "chaos": "#d62728",
    "rollback": "#ff7f0e",
    "resume": "#2ca02c",
    "population": "#9467bd",
    "autopilot": "#1f77b4",
}
_SVG_W, _SVG_H, _SVG_PAD = 640, 120, 4
_MAX_POINTS = 240  # downsample target per chart


def _event_label(kind: str, rec: dict) -> str:
    """Best-effort one-liner from whatever keys the stream's schema has."""
    for key in ("action", "kind", "event", "rule", "reason"):
        v = rec.get(key)
        if isinstance(v, str) and v:
            detail = rec.get("target") or rec.get("name") or rec.get("member")
            return f"{v}:{detail}" if detail else v
    if "idx" in rec:
        tail = f"@e{rec['epoch']}" if "epoch" in rec else ""
        return f"idx={rec['idx']}{tail}"
    return kind


def load_events(result_dir: str) -> list[dict]:
    """All audit-stream events as ``{"t", "kind", "label"}``, time-sorted.
    Torn tail lines and unstamped records are skipped, mirroring the
    history reader's crash discipline."""
    events: list[dict] = []
    for fname, kind in EVENT_STREAMS:
        path = os.path.join(result_dir, fname)
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict) or "t" not in rec:
                continue
            events.append({
                "t": float(rec["t"]),
                "kind": kind,
                "label": _event_label(kind, rec),
            })
    events.sort(key=lambda e: e["t"])
    return events


def select_channels(
    series: dict[str, str], patterns=DEFAULT_CHANNELS
) -> list[str]:
    return sorted(
        ch for ch in series
        if any(fnmatch.fnmatch(ch, p) for p in patterns)
    )


def build_report(
    result_dir: str,
    history_dir: str | None = None,
    patterns=DEFAULT_CHANNELS,
) -> dict:
    """The ``report.json`` document: per-channel stats over the full run
    span + the event timeline. Raises FileNotFoundError when the run has
    no history store (nothing to report on is an error, not an empty
    report — a silent blank would read as a healthy-but-idle run)."""
    hdir = history_dir or os.path.join(result_dir, "history")
    reader = HistoryReader(hdir)
    if not reader.exists():
        raise FileNotFoundError(f"no history store under {hdir}")
    series = reader.series()
    channels = []
    for ch in select_channels(series, patterns):
        pts = reader.points(ch)
        if not pts:
            continue
        values = [v for _, v in pts]
        channels.append({
            "name": ch,
            "kind": series.get(ch, "unknown"),
            "n": len(pts),
            "t0": pts[0][0],
            "t1": pts[-1][0],
            "mean": sum(values) / len(values),
            "min": min(values),
            "max": max(values),
            "last": values[-1],
        })
    return {
        "result_dir": os.path.abspath(result_dir),
        "history_dir": os.path.abspath(hdir),
        "generated_at": time.time(),
        "n_series": len(series),
        "channels": channels,
        "events": load_events(result_dir),
    }


# ------------------------------------------------------------------ markdown
def render_markdown(doc: dict) -> str:
    lines = [
        f"# Run report — `{doc['result_dir']}`",
        "",
        f"{len(doc['channels'])} charted channels of {doc['n_series']} "
        f"recorded series; {len(doc['events'])} fleet events.",
        "",
        "## Channels",
        "",
        "| Channel | Kind | Samples | Mean | Min | Max | Last |",
        "| --- | --- | ---: | ---: | ---: | ---: | ---: |",
    ]
    for ch in doc["channels"]:
        lines.append(
            f"| `{ch['name']}` | {ch['kind']} | {ch['n']} "
            f"| {ch['mean']:.4g} | {ch['min']:.4g} | {ch['max']:.4g} "
            f"| {ch['last']:.4g} |"
        )
    lines += ["", "## Events", ""]
    if doc["events"]:
        lines += ["| t | Kind | Event |", "| --- | --- | --- |"]
        t_base = doc["events"][0]["t"]
        for ev in doc["events"]:
            lines.append(
                f"| +{ev['t'] - t_base:.1f}s | {ev['kind']} "
                f"| {ev['label']} |"
            )
    else:
        lines.append("(none recorded)")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------- html
def _svg_chart(
    pts: list[tuple[float, float]],
    t0: float,
    t1: float,
    events: list[dict],
) -> str:
    """One inline SVG: the channel polyline over [t0, t1] plus a vertical
    rule per event inside the span."""
    span = max(t1 - t0, 1e-9)
    if len(pts) > _MAX_POINTS:
        pts = [
            (b["t"], b["mean"])
            for b in downsample(pts, span / _MAX_POINTS, start=t0)
        ]
    lo = min(v for _, v in pts)
    hi = max(v for _, v in pts)
    vspan = max(hi - lo, 1e-9)
    inner_w = _SVG_W - 2 * _SVG_PAD
    inner_h = _SVG_H - 2 * _SVG_PAD

    def xy(t, v):
        x = _SVG_PAD + (t - t0) / span * inner_w
        y = _SVG_PAD + (1.0 - (v - lo) / vspan) * inner_h
        return f"{x:.1f},{y:.1f}"

    parts = [
        f'<svg viewBox="0 0 {_SVG_W} {_SVG_H}" width="{_SVG_W}" '
        f'height="{_SVG_H}" role="img">',
        f'<rect width="{_SVG_W}" height="{_SVG_H}" fill="#fafafa" '
        'stroke="#ddd"/>',
    ]
    for ev in events:
        if not (t0 <= ev["t"] <= t1):
            continue
        x = _SVG_PAD + (ev["t"] - t0) / span * inner_w
        color = _EVENT_COLORS.get(ev["kind"], "#666")
        title = html.escape(f"{ev['kind']}: {ev['label']}")
        parts.append(
            f'<line x1="{x:.1f}" y1="0" x2="{x:.1f}" y2="{_SVG_H}" '
            f'stroke="{color}" stroke-dasharray="3,3">'
            f"<title>{title}</title></line>"
        )
    points = " ".join(xy(t, v) for t, v in pts)
    parts.append(
        f'<polyline points="{points}" fill="none" stroke="#1f77b4" '
        'stroke-width="1.5"/>'
    )
    parts.append(
        f'<text x="{_SVG_PAD + 2}" y="12" font-size="10" fill="#888">'
        f"max {hi:.4g}</text>"
        f'<text x="{_SVG_PAD + 2}" y="{_SVG_H - 6}" font-size="10" '
        f'fill="#888">min {lo:.4g}</text>'
    )
    parts.append("</svg>")
    return "".join(parts)


def render_html(doc: dict, reader: HistoryReader) -> str:
    rows = []
    for ch in doc["channels"]:
        pts = reader.points(ch["name"])
        if not pts:
            continue
        rows.append(
            f"<h3><code>{html.escape(ch['name'])}</code> "
            f"<small>({ch['kind']}, n={ch['n']}, mean={ch['mean']:.4g}, "
            f"last={ch['last']:.4g})</small></h3>"
            + _svg_chart(pts, ch["t0"], ch["t1"], doc["events"])
        )
    legend = " ".join(
        f'<span style="color:{color}">&#9475; {kind}</span>'
        for kind, color in _EVENT_COLORS.items()
    )
    ev_rows = "".join(
        f"<tr><td>{ev['t']:.3f}</td><td>{ev['kind']}</td>"
        f"<td>{html.escape(ev['label'])}</td></tr>"
        for ev in doc["events"]
    )
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>run report — {html.escape(doc['result_dir'])}</title>"
        "<style>body{font-family:sans-serif;max-width:700px;margin:2em auto}"
        "table{border-collapse:collapse}td,th{border:1px solid #ddd;"
        "padding:2px 8px;font-size:12px}</style></head><body>"
        f"<h1>Run report</h1><p><code>{html.escape(doc['result_dir'])}"
        f"</code></p><p>{legend}</p>"
        + "".join(rows)
        + "<h2>Events</h2><table><tr><th>t</th><th>kind</th><th>event</th>"
        f"</tr>{ev_rows}</table>"
        "</body></html>"
    )


# ---------------------------------------------------------------------- CLI
def write_report(
    result_dir: str,
    out_dir: str | None = None,
    history_dir: str | None = None,
    patterns=DEFAULT_CHANNELS,
) -> dict[str, str]:
    """Build + write all three artifacts; returns {format: path}."""
    doc = build_report(result_dir, history_dir=history_dir, patterns=patterns)
    reader = HistoryReader(doc["history_dir"])
    out_dir = out_dir or result_dir
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, content in (
        ("report.json", json.dumps(doc, indent=1) + "\n"),
        ("report.md", render_markdown(doc)),
        ("report.html", render_html(doc, reader)),
    ):
        path = os.path.join(out_dir, name)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(content)
        os.replace(tmp, path)
        paths[name] = path
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_rl_torch.obs.report",
        description="Render a post-hoc run report from the history store.",
    )
    ap.add_argument("result_dir", help="run result_dir (history/ inside)")
    ap.add_argument(
        "--history-dir", default=None,
        help="history store location when not result_dir/history",
    )
    ap.add_argument(
        "--out", default=None, help="output directory (default: result_dir)"
    )
    ap.add_argument(
        "--channels", nargs="*", default=None,
        help="fnmatch patterns over role/metric channel names "
        "(default: the fleet-health set)",
    )
    args = ap.parse_args(argv)
    patterns = tuple(args.channels) if args.channels else DEFAULT_CHANNELS
    try:
        paths = write_report(
            args.result_dir, out_dir=args.out,
            history_dir=args.history_dir, patterns=patterns,
        )
    except FileNotFoundError as e:
        print(f"report: {e}", file=sys.stderr)
        return 2
    for name in sorted(paths):
        print(f"report: wrote {paths[name]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
