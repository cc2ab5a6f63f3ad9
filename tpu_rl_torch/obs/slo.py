"""Declarative SLO rules over the telemetry plane.

The port's own copy of ``tpu_rl.obs.slo``, unchanged in behaviour.

One spec string (``Config.slo_spec``, chaos-grammar style: parsed once at
config validation, consumed only in resolved form) turns the aggregator's
snapshots into pass/fail/burn-rate verdicts — the always-on form of the
questions today answered by eyeballing ``/metrics``: is inference p99 under
budget, is the learner's MFU above floor, are frames being rejected.

Grammar (comma-separated clauses)::

    spec      := clause ("," clause)*
    clause    := kind ":" metric op value ("@" qualifier)*
    kind      := p50 | p90 | p99 | p999   (histogram quantile)
               | gauge                     (instantaneous gauge value)
               | counter                   (cumulative counter total)
               | rate                      (counter delta per second)
    op        := "<" | "<=" | ">" | ">=" | "=="
    value     := float [unit]   unit := "us" | "ms" | "s" | "/s"
    qualifier := "window=<seconds>s"       (default 60s)

Examples::

    p99:inference-rtt<5ms@window=30s   # worker-observed RTT quantile
    gauge:learner-mfu>0.002            # utilization floor
    rate:transport-rejected-frames<1/s # fleet-wide corruption budget

Semantics — all worst-case/fleet-wide, so a rule passes only when every
source satisfies it:

- quantile kinds merge same-named histograms across all sources
  (elementwise slot add — the shared :data:`~tpu_rl_torch.obs.registry
  .HIST_BUCKETS` layout is what makes that legal) and interpolate with
  :func:`~tpu_rl_torch.obs.registry.hist_quantile`. Duration units (``ms``/
  ``us``) convert to seconds, the unit timers record in.
- ``gauge`` takes the worst value across sources for the comparison
  direction (max for ``<``-style rules, min for ``>``).
- ``counter`` and ``rate`` sum across sources (a rejected frame anywhere
  burns the fleet budget); ``rate`` differentiates that sum over the
  rule's window.
- a rule with no matching data is ``ok=None`` (no-data): it neither
  passes nor burns — silence is surfaced, not scored.

``burn_rate`` is the fraction of evaluations inside the rule's window that
violated (0.0 healthy, 1.0 hard-down) — the error-budget-burn view that
distinguishes a blip from a sustained breach. Each rule also carries
``burn_history``, the last :data:`BURN_HISTORY_LEN` ``[t, burn]`` points
(one per evaluate pass), so sustain/hysteresis consumers — the autopilot's
decision engine, the dashboard — read the exact series the verdicts were
scored on instead of re-deriving it from scrapes.

Pure stdlib + registry math, so ``Config.validate()`` can parse-check specs
without importing torch, and golden-fixture tests are exactly reproducible.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

from tpu_rl_torch.obs.registry import hist_quantile

KINDS = frozenset({"p50", "p90", "p99", "p999", "gauge", "counter", "rate"})
_QUANTILES = {"p50": 0.50, "p90": 0.90, "p99": 0.99, "p999": 0.999}
# Longest-first so "<=" wins over "<". "==" is for exact invariants over
# counters (e.g. counter:learner-nonfinite-updates==0 — any nonfinite
# update anywhere in the fleet is a violation, not a budget).
_OPS: tuple[tuple[str, Callable[[float, float], bool]], ...] = (
    ("<=", lambda v, t: v <= t),
    (">=", lambda v, t: v >= t),
    ("==", lambda v, t: v == t),
    ("<", lambda v, t: v < t),
    (">", lambda v, t: v > t),
)
_UNITS = {"us": 1e-6, "ms": 1e-3, "s": 1.0, "/s": 1.0}
DEFAULT_WINDOW_S = 60.0
# Burn-rate points kept per rule for the /slo payload's burn_history —
# the same series the autopilot's sustain/hysteresis windows and the
# dashboard read (one point per evaluate tick, so 120 covers two minutes
# at the storage 1 Hz cadence).
BURN_HISTORY_LEN = 120


@dataclass(frozen=True)
class SloRule:
    """One resolved rule clause."""

    raw: str
    kind: str
    metric: str
    op: str
    threshold: float
    window_s: float = DEFAULT_WINDOW_S

    def check(self, value: float) -> bool:
        for sym, fn in _OPS:
            if sym == self.op:
                return fn(value, self.threshold)
        raise ValueError(f"slo rule {self.raw!r}: unknown op {self.op!r}")

    @property
    def upper_bound(self) -> bool:
        """True for ``<``-style rules (threshold is a ceiling). ``==``
        counts as a ceiling: exact invariants are worst-cased by the
        largest source value."""
        return self.op.startswith("<") or self.op == "=="


def _parse_value(clause: str, text: str) -> float:
    text = text.strip()
    for unit, scale in sorted(_UNITS.items(), key=lambda kv: -len(kv[0])):
        if text.endswith(unit):
            num = text[: -len(unit)]
            try:
                return float(num) * scale
            except ValueError:
                break
    try:
        return float(text)
    except ValueError:
        raise ValueError(
            f"slo clause {clause!r}: bad threshold {text!r} "
            "(expected float with optional us/ms/s//s unit)"
        ) from None


def _parse_clause(clause: str) -> SloRule:
    head, sep, tail = clause.partition(":")
    kind = head.strip()
    if not sep or kind not in KINDS:
        raise ValueError(
            f"slo clause {clause!r}: unknown kind {kind!r} "
            f"(expected one of {sorted(KINDS)})"
        )
    body, *quals = tail.split("@")
    for sym, _fn in _OPS:
        metric, sep, value = body.partition(sym)
        if sep:
            op = sym
            break
    else:
        raise ValueError(
            f"slo clause {clause!r}: no comparison (expected < <= > >= ==)"
        )
    metric = metric.strip()
    if not metric:
        raise ValueError(f"slo clause {clause!r}: empty metric name")
    threshold = _parse_value(clause, value)
    window_s = DEFAULT_WINDOW_S
    for qual in quals:
        qual = qual.strip()
        if qual.startswith("window=") and qual.endswith("s"):
            try:
                window_s = float(qual[len("window="):-1])
            except ValueError:
                window_s = -1.0
            if window_s > 0:
                continue
        raise ValueError(
            f"slo clause {clause!r}: unknown qualifier {qual!r} "
            "(expected 'window=<seconds>s')"
        )
    return SloRule(
        raw=clause.strip(), kind=kind, metric=metric, op=op,
        threshold=threshold, window_s=window_s,
    )


def parse_slo_spec(spec: str) -> list[SloRule]:
    """Parse a full spec; raises ``ValueError`` with the offending clause.
    Empty/whitespace spec -> no rules."""
    rules = []
    for clause in spec.split(","):
        clause = clause.strip()
        if clause:
            rules.append(_parse_clause(clause))
    return rules


# ---------------------------------------------------------------- evaluation
def _iter_snaps(source, now):
    if hasattr(source, "all_snapshots"):
        return [snap for snap, _age in source.all_snapshots(now)]
    return list(source)  # golden fixtures: a plain list of snapshot dicts


def _rule_value(rule: SloRule, snaps: list[dict]) -> float | None:
    """Extract the rule's observable from a set of snapshots (worst-case /
    fleet-wide per the module semantics); None = no data."""
    if rule.kind in _QUANTILES:
        merged: list[float] | None = None
        for snap in snaps:
            for name, _labels, counts, _total, _count in snap.get("hists", ()):
                if name != rule.metric:
                    continue
                if merged is None:
                    merged = [float(c) for c in counts]
                else:
                    merged = [a + b for a, b in zip(merged, counts)]
        if merged is None:
            return None
        return hist_quantile(merged, _QUANTILES[rule.kind])
    if rule.kind == "gauge":
        values = [
            float(value)
            for snap in snaps
            for name, _labels, value in snap.get("gauges", ())
            if name == rule.metric
        ]
        if not values:
            return None
        return max(values) if rule.upper_bound else min(values)
    # counter / rate: fleet-wide sum of cumulative totals
    values = [
        float(value)
        for snap in snaps
        for name, _labels, value in snap.get("counters", ())
        if name == rule.metric
    ]
    return sum(values) if values else None


class SloEngine:
    """Stateful evaluator: call :meth:`evaluate` on a fixed cadence (the
    storage/colocated telemetry tick); serve :meth:`report` from the
    ``/slo`` endpoint so scrapes read the last verdict instead of injecting
    extra samples into the burn-rate history."""

    def __init__(
        self,
        spec_or_rules: str | list[SloRule],
        clock: Callable[[], float] = time.monotonic,
    ):
        if isinstance(spec_or_rules, str):
            self.rules = parse_slo_spec(spec_or_rules)
        else:
            self.rules = list(spec_or_rules)
        self._clock = clock
        # Per rule: (t, violated) verdict samples inside the window.
        self._verdicts: list[deque] = [deque() for _ in self.rules]
        # Per rate-rule: (t, cumulative total) for differentiation.
        self._totals: list[deque] = [deque() for _ in self.rules]
        # Per rule: (t, burn_rate) — one point per evaluate pass, served
        # in the /slo payload so sustain/hysteresis consumers (autopilot,
        # dashboard) read the exact series the engine decided on.
        self._burn_hist: list[deque] = [
            deque(maxlen=BURN_HISTORY_LEN) for _ in self.rules
        ]
        self._last: dict | None = None

    def evaluate(self, source, now: float | None = None) -> dict:
        """One evaluation pass over an aggregator (or a plain snapshot
        list, for fixtures). Deterministic given (snapshots, now)."""
        now = self._clock() if now is None else now
        snaps = _iter_snaps(source, now)
        results = []
        for i, rule in enumerate(self.rules):
            value = _rule_value(rule, snaps)
            if rule.kind == "rate" and value is not None:
                totals = self._totals[i]
                totals.append((now, value))
                while totals and now - totals[0][0] > rule.window_s:
                    totals.popleft()
                if len(totals) >= 2 and totals[-1][0] > totals[0][0]:
                    value = (totals[-1][1] - totals[0][1]) / (
                        totals[-1][0] - totals[0][0]
                    )
                else:
                    value = None  # one sample: no rate yet
            ok = None if value is None else rule.check(value)
            verdicts = self._verdicts[i]
            if ok is not None:
                verdicts.append((now, not ok))
            while verdicts and now - verdicts[0][0] > rule.window_s:
                verdicts.popleft()
            burn = (
                sum(1 for _t, bad in verdicts if bad) / len(verdicts)
                if verdicts
                else 0.0
            )
            self._burn_hist[i].append((now, round(burn, 6)))
            results.append(
                {
                    "rule": rule.raw,
                    "kind": rule.kind,
                    "metric": rule.metric,
                    "op": rule.op,
                    "threshold": rule.threshold,
                    "window_s": rule.window_s,
                    "value": value,
                    "ok": ok,
                    "burn_rate": round(burn, 6),
                    "samples": len(verdicts),
                    "burn_history": [
                        [round(t, 3), b] for t, b in self._burn_hist[i]
                    ],
                }
            )
        self._last = {
            "ok": all(r["ok"] is not False for r in results),
            "failing": sum(1 for r in results if r["ok"] is False),
            "no_data": sum(1 for r in results if r["ok"] is None),
            "rules": results,
        }
        return self._last

    def report(self) -> dict:
        """Last verdict (evaluating nothing); skeleton before first pass."""
        if self._last is not None:
            return self._last
        return {
            "ok": True,
            "failing": 0,
            "no_data": len(self.rules),
            "rules": [
                {
                    "rule": r.raw,
                    "ok": None,
                    "value": None,
                    "burn_rate": 0.0,
                    "burn_history": [],
                }
                for r in self.rules
            ],
        }

    @property
    def failed(self) -> bool:
        """True when the latest verdict has any hard-failing rule — the
        fail-the-run exit gate for smokes (``Config.slo_fail_run``)."""
        return self._last is not None and not self._last["ok"]


def maybe_slo_engine(cfg) -> SloEngine | None:
    """Role-side constructor: an engine iff ``Config.slo_spec`` is set."""
    spec = getattr(cfg, "slo_spec", None)
    if not spec:
        return None
    return SloEngine(spec)
