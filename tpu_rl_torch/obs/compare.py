"""Cross-run regression verdicts over two history stores.

The port's own copy of ``tpu_rl.obs.compare``, unchanged in behaviour.

``python -m tpu_rl_torch.obs.compare <baseline_dir> <candidate_dir>`` compares
every channel the two runs share (plus every channel either side is
missing) and exits nonzero on regression — the CI gate the bench
trajectory never had.

Verdict semantics, per channel:

- **warmup trim**: the first ``warmup_frac`` (default 20%) of each run's
  span is dropped before statistics — cold caches, compile time and
  ramp-up are not the steady state under comparison.
- **tolerance band**: candidate median vs baseline median, with the band
  ``max(mad_k * MAD_baseline * 1.4826, rel_tol * |median_baseline|)`` —
  robust to outliers (MAD, not stddev) and never degenerate on quiet
  channels (the relative floor).
- **direction**: throughput-like channels (``*-per-s``, goodput ratios,
  MFU, ESS, returns) regress downward; latency-like channels
  (staleness, rtt, queue-wait) regress upward; everything else is
  direction-neutral — an out-of-band move is reported as ``shifted``
  but gates nothing (a changed config knob is not a regression).
- **no-data is explicit**: a channel present in the baseline but absent
  (or empty after trim) in the candidate is verdict ``no-data`` and
  FAILS the gate. A silently dropped metric is exactly the regression
  class a comparison layer exists to catch. Channels new in the
  candidate are reported (``new``) but do not gate, and a channel too
  sparse on BOTH sides is ``skipped`` (nothing stopped recording —
  self-compare is green by construction).
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import sys

from tpu_rl_torch.obs.history import HistoryReader

# Channel-name patterns fixing regression direction. First match wins;
# matched against the bare ``role/metric`` channel name.
HIGHER_BETTER = (
    "*-per-s",
    "*-per-secs",
    "*-goodput-ratio",
    "*-mfu",
    "*-ess*",
    "*-mean-episode-return",
    "*-achieved-flops",
    "*-best-fitness",
)
LOWER_BETTER = (
    "*staleness*",
    "*-rtt*",
    "*-latency*",
    "*queue-wait*",
    "*-queue-depth",
    "*anomaly-*",
)

MAD_K = 5.0  # band half-width in (scaled) MADs
REL_TOL = 0.10  # relative floor on the band
WARMUP_FRAC = 0.2
MIN_SAMPLES = 3  # fewer post-trim samples than this = no-data

GATING = ("regressed", "no-data")


def direction(channel: str) -> str:
    """'up' (higher is better), 'down' (lower is better) or 'neutral'."""
    for pat in HIGHER_BETTER:
        if fnmatch.fnmatch(channel, pat):
            return "up"
    for pat in LOWER_BETTER:
        if fnmatch.fnmatch(channel, pat):
            return "down"
    return "neutral"


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def robust_stats(values: list[float]) -> tuple[float, float]:
    """(median, scaled MAD): MAD * 1.4826 estimates sigma under
    normality, so the band math reads in sigma units."""
    med = _median(values)
    mad = _median([abs(v - med) for v in values])
    return med, mad * 1.4826


def trim_warmup(
    points: list[tuple[float, float]], frac: float = WARMUP_FRAC
) -> list[float]:
    """Drop the first ``frac`` of the run's SPAN (time-based, not
    count-based — a slow-sampling channel still loses its ramp-up)."""
    if not points:
        return []
    t0, t1 = points[0][0], points[-1][0]
    cut = t0 + frac * (t1 - t0)
    return [v for t, v in points if t >= cut]


def compare_channel(
    base: list[float] | None,
    cand: list[float] | None,
    channel: str,
    mad_k: float = MAD_K,
    rel_tol: float = REL_TOL,
) -> dict:
    """One channel's verdict row. ``base``/``cand`` are post-trim value
    lists (None = channel absent from that run entirely)."""
    row: dict = {"channel": channel, "direction": direction(channel)}
    if base is None or len(base) < MIN_SAMPLES:
        if cand is None or len(cand) < MIN_SAMPLES:
            # Empty on BOTH sides (e.g. a channel indexed but too sparse
            # to survive the warmup trim in either run): nothing stopped
            # recording, so this never gates — self-compare stays green.
            row.update(verdict="skipped", detail="absent from both runs")
        else:
            # New in candidate: informational, never gates — a freshly
            # added metric is not a regression of the baseline.
            row.update(
                verdict="new", candidate_median=_median(cand),
                detail="channel absent from baseline",
            )
        return row
    if cand is None or len(cand) < MIN_SAMPLES:
        row.update(
            verdict="no-data", baseline_median=_median(base),
            detail="channel present in baseline but missing/empty in "
            "candidate",
        )
        return row
    med_b, sigma_b = robust_stats(base)
    med_c, _ = robust_stats(cand)
    band = max(mad_k * sigma_b, rel_tol * abs(med_b))
    delta = med_c - med_b
    row.update(
        baseline_median=med_b, candidate_median=med_c,
        delta=delta, band=band,
        n_baseline=len(base), n_candidate=len(cand),
    )
    if abs(delta) <= band:
        row["verdict"] = "ok"
        return row
    d = row["direction"]
    if d == "neutral":
        row["verdict"] = "shifted"
    elif (d == "up") == (delta > 0):
        row["verdict"] = "improved"
    else:
        row["verdict"] = "regressed"
    return row


def compare_runs(
    baseline_dir: str,
    candidate_dir: str,
    patterns: tuple[str, ...] = ("*",),
    warmup_frac: float = WARMUP_FRAC,
    mad_k: float = MAD_K,
    rel_tol: float = REL_TOL,
) -> dict:
    """Full comparison document. ``ok`` is False iff any channel's
    verdict is gating (regressed / no-data)."""
    b = HistoryReader(baseline_dir)
    c = HistoryReader(candidate_dir)
    if not b.exists():
        raise FileNotFoundError(f"no history store under {baseline_dir}")
    if not c.exists():
        raise FileNotFoundError(f"no history store under {candidate_dir}")
    b_series, c_series = b.series(), c.series()
    channels = sorted(
        ch for ch in set(b_series) | set(c_series)
        if any(fnmatch.fnmatch(ch, p) for p in patterns)
    )
    rows = []
    for ch in channels:
        base = (
            trim_warmup(b.points(ch), warmup_frac)
            if ch in b_series else None
        )
        cand = (
            trim_warmup(c.points(ch), warmup_frac)
            if ch in c_series else None
        )
        rows.append(
            compare_channel(base, cand, ch, mad_k=mad_k, rel_tol=rel_tol)
        )
    counts: dict[str, int] = {}
    for row in rows:
        counts[row["verdict"]] = counts.get(row["verdict"], 0) + 1
    return {
        "baseline_dir": baseline_dir,
        "candidate_dir": candidate_dir,
        "warmup_frac": warmup_frac,
        "mad_k": mad_k,
        "rel_tol": rel_tol,
        "counts": counts,
        "ok": not any(row["verdict"] in GATING for row in rows),
        "rows": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_rl_torch.obs.compare",
        description="Per-channel regression verdicts between two runs' "
        "history stores; exits nonzero on regression or missing data.",
    )
    ap.add_argument("baseline_dir", help="baseline history dir "
                    "(or result_dir containing history/)")
    ap.add_argument("candidate_dir", help="candidate history dir "
                    "(or result_dir containing history/)")
    ap.add_argument("--channels", nargs="*", default=["*"],
                    help="fnmatch patterns to compare (default: all)")
    ap.add_argument("--warmup-frac", type=float, default=WARMUP_FRAC)
    ap.add_argument("--mad-k", type=float, default=MAD_K)
    ap.add_argument("--rel-tol", type=float, default=REL_TOL)
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also write the full document to this path")
    args = ap.parse_args(argv)

    def resolve(d):
        sub = os.path.join(d, "history")
        return sub if os.path.isdir(sub) else d

    try:
        doc = compare_runs(
            resolve(args.baseline_dir), resolve(args.candidate_dir),
            patterns=tuple(args.channels), warmup_frac=args.warmup_frac,
            mad_k=args.mad_k, rel_tol=args.rel_tol,
        )
    except FileNotFoundError as e:
        print(f"compare: {e}", file=sys.stderr)
        return 2
    for row in doc["rows"]:
        if row["verdict"] == "ok":
            continue
        med_b = row.get("baseline_median")
        med_c = row.get("candidate_median")
        detail = row.get(
            "detail",
            f"baseline {med_b:.4g} -> candidate {med_c:.4g} "
            f"(band {row.get('band', 0.0):.4g})"
            if med_b is not None and med_c is not None else "",
        )
        print(f"compare: {row['verdict']:>9} {row['channel']}  {detail}")
    summary = ", ".join(f"{k}={v}" for k, v in sorted(doc["counts"].items()))
    print(f"compare: {summary} -> {'OK' if doc['ok'] else 'FAIL'}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=1)
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
