"""Autopilot decision plane: declarative scaling rules + the engine — the
port's own copy of ``tpu_rl.autopilot.policy``, unchanged in behaviour.

One spec string (``Config.autopilot_spec``, chaos-grammar style: parsed
once at config validation, consumed only in resolved form) maps the
fleet's read-only health signals — SLO burn rates, goodput ratios,
straggler scores, raw gauges/counters — to the three actions the
actuator knows how to take: scale inference replicas, scale workers,
evict-and-respawn a pegged straggler.

Grammar (comma-separated clauses)::

    spec      := clause ("," clause)*
    clause    := rule | limit
    rule      := action ":" target "?" signal op value ("@" qualifier)*
    action    := scale_out | scale_in      (targets: replicas | workers)
               | respawn                   (target: worker)
    signal    := "burn:" metric            (per-rule /slo burn rate, 0..1)
               | "gauge:" name             (fleet-max gauge off /metrics)
               | "counter:" name           (fleet-sum counter off /metrics)
               | "goodput:" role           (role goodput ratio off /goodput)
               | "straggler:score"         (top straggler score off /goodput)
    op        := "<" | "<=" | ">" | ">=" | "=="
    qualifier := "sustain=<polls>"         (consecutive satisfied polls, default 3)
               | "cooldown=<seconds>s"     (per-rule refractory, default 30s)
               | "step=<n>"                (members moved per firing, default 1)
               | "min=<n>" | "max=<n>"     (hard bounds on the target count)
    limit     := "limit=" n "/" seconds "s"  (global action rate cap,
                                              default 6/60s)

Example — the closed loop the smoke drives::

    scale_out:replicas?burn:inference-rtt>0.5@sustain=3@cooldown=6s@max=3,
    scale_in:replicas?burn:inference-rtt<0.05@sustain=8@cooldown=8s@min=1,
    respawn:worker?straggler:score>8@sustain=10@cooldown=60s,
    limit=6/60s

Anti-flap semantics (all enforced by :class:`DecisionEngine`, all
covered by synthetic-trace tests):

- **sustain**: a rule arms only after its predicate held for N
  *consecutive* polls — one blip resets the streak, so slow drift and
  flapping signals never fire;
- **cooldown**: a fired rule is refractory for its cooldown — a
  sustained burn produces exactly one action per cooldown window;
- **hysteresis**: a firing resets the streak of *every* rule aimed at
  the same target, so an opposing rule must re-earn its full sustain
  from scratch after any movement — out/in oscillation is structurally
  impossible within one sustain window;
- **bounds**: ``min``/``max`` clamp the target count; a firing that
  cannot move the count is dropped (counted, no cooldown burned);
- **rate limit**: one global token bucket across all rules — a
  misconfigured spec can never churn the fleet faster than
  ``limit_n`` actions per ``limit_window_s``.

Pure stdlib with an injectable clock, so ``Config.validate()`` can
parse-check specs without importing torch and the engine is exactly
reproducible under synthetic traces.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

ACTIONS = frozenset({"scale_out", "scale_in", "respawn"})
SCALE_TARGETS = frozenset({"replicas", "workers"})
SIGNAL_KINDS = frozenset({"burn", "gauge", "counter", "goodput", "straggler"})
DEFAULT_SUSTAIN = 3
DEFAULT_COOLDOWN_S = 30.0
DEFAULT_LIMIT_N = 6
DEFAULT_LIMIT_WINDOW_S = 60.0
# Longest-first so "<=" wins over "<" (same table discipline as slo.py).
_OPS: tuple[tuple[str, Callable[[float, float], bool]], ...] = (
    ("<=", lambda v, t: v <= t),
    (">=", lambda v, t: v >= t),
    ("==", lambda v, t: v == t),
    ("<", lambda v, t: v < t),
    (">", lambda v, t: v > t),
)


@dataclass(frozen=True)
class Rule:
    """One resolved rule clause."""

    raw: str
    action: str
    target: str
    signal: str  # full "kind:name" key into the signal dict
    op: str
    threshold: float
    sustain: int = DEFAULT_SUSTAIN
    cooldown_s: float = DEFAULT_COOLDOWN_S
    step: int = 1
    lo: int | None = None
    hi: int | None = None

    def check(self, value: float) -> bool:
        for sym, fn in _OPS:
            if sym == self.op:
                return fn(value, self.threshold)
        raise ValueError(f"autopilot rule {self.raw!r}: unknown op {self.op!r}")


@dataclass(frozen=True)
class AutopilotSpec:
    """Parsed spec: the rule list plus the global action rate limit."""

    rules: tuple[Rule, ...]
    limit_n: int = DEFAULT_LIMIT_N
    limit_window_s: float = DEFAULT_LIMIT_WINDOW_S

    @staticmethod
    def parse(spec: str) -> "AutopilotSpec":
        """Parse a full spec; every ``ValueError`` names the offending
        clause. Empty/whitespace spec -> no rules (a do-nothing pilot)."""
        rules: list[Rule] = []
        limit_n, limit_window_s = DEFAULT_LIMIT_N, DEFAULT_LIMIT_WINDOW_S
        for clause in spec.split(","):
            clause = clause.strip()
            if not clause:
                continue
            if clause.startswith("limit="):
                limit_n, limit_window_s = _parse_limit(clause)
            else:
                rules.append(_parse_rule(clause))
        return AutopilotSpec(
            rules=tuple(rules), limit_n=limit_n, limit_window_s=limit_window_s
        )


def _int_field(clause: str, name: str, text: str, lo: int = 0) -> int:
    try:
        value = int(text)
    except ValueError:
        raise ValueError(
            f"autopilot clause {clause!r}: bad {name} {text!r} "
            "(expected an integer)"
        ) from None
    if value < lo:
        raise ValueError(
            f"autopilot clause {clause!r}: {name} must be >= {lo}, got {value}"
        )
    return value


def _parse_limit(clause: str) -> tuple[int, float]:
    body = clause[len("limit="):]
    n_text, sep, win_text = body.partition("/")
    if not sep or not win_text.endswith("s"):
        raise ValueError(
            f"autopilot clause {clause!r}: expected 'limit=<n>/<seconds>s'"
        )
    n = _int_field(clause, "limit count", n_text, lo=1)
    try:
        window_s = float(win_text[:-1])
    except ValueError:
        window_s = -1.0
    if window_s <= 0:
        raise ValueError(
            f"autopilot clause {clause!r}: bad limit window {win_text!r} "
            "(expected '<seconds>s', positive)"
        )
    return n, window_s


def _parse_rule(clause: str) -> Rule:
    head, sep, tail = clause.partition("?")
    if not sep:
        raise ValueError(
            f"autopilot clause {clause!r}: no '?' predicate separator "
            "(expected 'action:target?signal op value')"
        )
    action, sep, target = head.partition(":")
    action, target = action.strip(), target.strip()
    if not sep or action not in ACTIONS:
        raise ValueError(
            f"autopilot clause {clause!r}: unknown action {action!r} "
            f"(expected one of {sorted(ACTIONS)})"
        )
    if action == "respawn":
        if target != "worker":
            raise ValueError(
                f"autopilot clause {clause!r}: respawn targets 'worker', "
                f"got {target!r}"
            )
    elif target not in SCALE_TARGETS:
        raise ValueError(
            f"autopilot clause {clause!r}: unknown target {target!r} "
            f"(expected one of {sorted(SCALE_TARGETS)})"
        )

    body, *quals = tail.split("@")
    for sym, _fn in _OPS:
        signal, sep, value_text = body.partition(sym)
        if sep:
            op = sym
            break
    else:
        raise ValueError(
            f"autopilot clause {clause!r}: no comparison "
            "(expected < <= > >= ==)"
        )
    signal = signal.strip()
    kind, sep, name = signal.partition(":")
    if not sep or kind not in SIGNAL_KINDS or not name:
        raise ValueError(
            f"autopilot clause {clause!r}: bad signal {signal!r} "
            f"(expected '<kind>:<name>' with kind one of "
            f"{sorted(SIGNAL_KINDS)})"
        )
    try:
        threshold = float(value_text.strip())
    except ValueError:
        raise ValueError(
            f"autopilot clause {clause!r}: bad threshold "
            f"{value_text.strip()!r} (expected a float)"
        ) from None

    sustain, cooldown_s, step = DEFAULT_SUSTAIN, DEFAULT_COOLDOWN_S, 1
    lo: int | None = None
    hi: int | None = None
    for qual in quals:
        qual = qual.strip()
        key, sep, val = qual.partition("=")
        if not sep:
            raise ValueError(
                f"autopilot clause {clause!r}: unknown qualifier {qual!r} "
                "(expected sustain=/cooldown=/step=/min=/max=)"
            )
        if key == "sustain":
            sustain = _int_field(clause, "sustain", val, lo=1)
        elif key == "cooldown":
            if not val.endswith("s"):
                raise ValueError(
                    f"autopilot clause {clause!r}: bad cooldown {val!r} "
                    "(expected '<seconds>s')"
                )
            try:
                cooldown_s = float(val[:-1])
            except ValueError:
                cooldown_s = -1.0
            if cooldown_s < 0:
                raise ValueError(
                    f"autopilot clause {clause!r}: bad cooldown {val!r} "
                    "(expected '<seconds>s', non-negative)"
                )
        elif key == "step":
            step = _int_field(clause, "step", val, lo=1)
        elif key == "min":
            lo = _int_field(clause, "min", val)
        elif key == "max":
            hi = _int_field(clause, "max", val)
        else:
            raise ValueError(
                f"autopilot clause {clause!r}: unknown qualifier {qual!r} "
                "(expected sustain=/cooldown=/step=/min=/max=)"
            )
    if lo is not None and hi is not None and lo > hi:
        raise ValueError(
            f"autopilot clause {clause!r}: min={lo} > max={hi}"
        )
    return Rule(
        raw=clause, action=action, target=target, signal=signal, op=op,
        threshold=threshold, sustain=sustain, cooldown_s=cooldown_s,
        step=step, lo=lo, hi=hi,
    )


# ------------------------------------------------------------------ engine
class DecisionEngine:
    """Deterministic rule evaluator: :meth:`decide` once per poll tick.

    Stateless about the fleet (current counts come in as an argument) and
    pure given (signals, counts, now) — the controller owns actuation;
    this class only says *what* to do and enforces every anti-flap
    guarantee documented in the module docstring.
    """

    def __init__(
        self,
        spec: AutopilotSpec,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.spec = spec
        self._clock = clock
        self._streak = [0] * len(spec.rules)
        self._cooldown_until = [0.0] * len(spec.rules)
        self._fires: deque = deque()  # global rate-limit window
        self.n_decisions = 0
        self.n_rate_limited = 0
        self.n_clamped = 0

    def decide(
        self,
        signals: dict,
        counts: dict,
        now: float | None = None,
        meta: dict | None = None,
    ) -> list[dict]:
        """One pass over all rules -> the (possibly empty) decision list.

        ``signals`` maps full signal keys (``"burn:inference-rtt"``) to the
        latest value; a missing signal HOLDS the rule's streak (silence is
        not evidence either way). ``counts`` maps targets (``"replicas"``,
        ``"workers"``) to current member counts. ``meta`` carries action
        context — ``straggler_wid`` for respawn decisions.
        """
        now = self._clock() if now is None else now
        meta = meta or {}
        decisions: list[dict] = []
        fired_targets: set[str] = set()
        for i, rule in enumerate(self.spec.rules):
            value = signals.get(rule.signal)
            if value is None:
                continue  # no data: hold the streak, never fire on silence
            if not rule.check(float(value)):
                self._streak[i] = 0
                continue
            self._streak[i] += 1
            if self._streak[i] < rule.sustain:
                continue
            if now < self._cooldown_until[i]:
                continue
            if rule.target in fired_targets:
                continue  # one movement per target per pass
            while self._fires and now - self._fires[0] > self.spec.limit_window_s:
                self._fires.popleft()
            if len(self._fires) >= self.spec.limit_n:
                self.n_rate_limited += 1
                continue
            decision = self._build(rule, float(value), counts, meta)
            if decision is None:
                # Bounds already satisfied (or no wid to respawn): no
                # action, no cooldown burned — the rule stays armed and
                # acts the moment movement becomes possible again.
                self.n_clamped += 1
                continue
            self._cooldown_until[i] = now + rule.cooldown_s
            self._fires.append(now)
            fired_targets.add(rule.target)
            self.n_decisions += 1
            decisions.append(decision)
        # Hysteresis: any movement of a target resets every rule aimed at
        # it — applied AFTER the pass so same-pass streak increments are
        # wiped too and an opposing rule re-earns its FULL sustain.
        if fired_targets:
            for j, other in enumerate(self.spec.rules):
                if other.target in fired_targets:
                    self._streak[j] = 0
        return decisions

    def _build(
        self, rule: Rule, value: float, counts: dict, meta: dict
    ) -> dict | None:
        reason = (
            f"{rule.signal} {rule.op} {rule.threshold} sustained "
            f"{rule.sustain} polls (value={value:.6g})"
        )
        base = {
            "action": rule.action,
            "target": rule.target,
            "rule": rule.raw,
            "signal": rule.signal,
            "value": value,
            "reason": reason,
        }
        if rule.action == "respawn":
            wid = meta.get("straggler_wid")
            if wid is None:
                return None
            cur = int(counts.get("workers", 0))
            return {**base, "wid": wid, "step": 0, "from": cur, "to": cur}
        cur = int(counts.get(rule.target, 0))
        desired = cur + rule.step if rule.action == "scale_out" else cur - rule.step
        if rule.lo is not None:
            desired = max(desired, rule.lo)
        if rule.hi is not None:
            desired = min(desired, rule.hi)
        desired = max(desired, 0)
        if desired == cur:
            return None
        return {**base, "step": abs(desired - cur), "from": cur, "to": desired}

    def cooldowns(self, now: float | None = None) -> dict:
        """Remaining refractory seconds per rule (0.0 = armed) — the
        dashboard's cooldown-status column."""
        now = self._clock() if now is None else now
        return {
            rule.raw: round(max(0.0, self._cooldown_until[i] - now), 3)
            for i, rule in enumerate(self.spec.rules)
        }
