"""Fault-plan grammar: one string drives every injector in the fleet — the
port's own copy of ``tpu_rl.chaos.plan``, unchanged in behaviour.

A plan is parsed once from ``Config.chaos_spec`` and resolved into
per-layer fault lists; everything downstream (supervisor hook, transport
shims, inference-service hooks) consumes the resolved faults, never the
string. Determinism is the whole point — a chaos run is reproducible from
``(chaos_spec, chaos_seed)`` alone, so a recovery bug found in CI replays
locally byte-for-byte.

Grammar (comma-separated clauses)::

    spec      := clause ("," clause)*
    clause    := action ":" target ("@" qualifier)*
    action    := kill | stop | hang | corrupt | drop | delay | stall | refuse
               | nan | spike
    qualifier := "t+<seconds>s"     (window start / one-shot fire time)
               | "p=<probability>"  (per-frame / per-event probability)
               | "<millis>ms"       (injected latency)
               | "for=<seconds>s"   (data faults: window length; none = forever)
               | "wid=<int>"        (data faults: only this worker instance)

Actions by layer:

- **process** (supervisor hook, one-shot at ``t+..s``): ``kill`` SIGKILLs
  the first child whose name matches the target prefix (``worker`` matches
  ``worker-0-0``; ``worker-0-1`` matches exactly); ``stop``/``hang``
  SIGSTOPs it — alive to the OS, silent to the heartbeat plane.
- **transport** (shim on ``Pub``/``Sub``, probabilistic): ``corrupt`` and
  ``drop`` target a *channel* (``rollout``/``model``/``stat``/
  ``telemetry``) and are injected at the RECEIVE side of the channel's
  consuming edge — a corrupted frame is by construction one that arrived,
  so every injection produces exactly one ``n_rejected`` at the decode in
  the same process, and injected == rejected holds regardless of HWM
  drops, slow joiners, or kills upstream. ``delay`` targets a *role*
  (``worker``/``manager``/``learner`` delay their sends; ``storage``
  delays its receives).
- **service** (inference service): ``stall`` sleeps before a batch flush;
  ``refuse`` swallows a reply — the client sees a timeout, exercising the
  worker's fallback + re-probe path.
- **data** (payload values, at the PRODUCING worker, pre-send): ``nan``
  and ``spike`` corrupt rollout payload VALUES — not wire bytes, so the
  frame decodes fine and must be caught by the self-healing plane
  (ingress validation / in-jit guards), not by the codec. Targets:
  ``rollout`` poisons obs+rew (the columns ingress validates — contained
  at the storage edge), ``logp`` poisons log_prob (deliberately NOT
  validated at ingress: it rides into training and must be contained by
  the in-jit guards + watchdog — defense in depth). ``spike`` writes a
  finite but absurd magnitude (1e9, over the default
  ``Config.ingress_abs_max``). Optional ``t+..s``/``for=..s`` bound the
  active window; ``wid=<n>`` restricts injection to one worker instance
  so the rest of the fleet keeps learning.

Pure stdlib so ``Config.validate()`` can parse-check specs cheaply.
"""

from __future__ import annotations

from dataclasses import dataclass

ACTIONS = frozenset(
    {
        "kill", "stop", "hang", "corrupt", "drop", "delay", "stall",
        "refuse", "nan", "spike",
    }
)
PROCESS_ACTIONS = frozenset({"kill", "stop", "hang"})
DATA_ACTIONS = frozenset({"nan", "spike"})
# Data-fault targets: which payload columns get poisoned at the worker.
DATA_TARGETS = frozenset({"rollout", "logp"})

# Channel name -> (site, proto bytes consumed there). The proto values match
# tpu_rl_torch.runtime.protocol.Protocol but are spelled as ints so this module
# stays numpy/zmq-free and importable from Config.validate().
CHANNELS: dict[str, tuple[str, frozenset[int]]] = {
    "rollout": ("storage", frozenset({1, 3})),  # Rollout, RolloutBatch
    "stat": ("storage", frozenset({2})),
    "telemetry": ("storage", frozenset({6})),
    "model": ("worker", frozenset({0})),
}
# Role -> which side of its transport a `delay` applies to. Producers delay
# their sends (latency the fleet sees downstream); storage, a pure consumer,
# delays its receives.
DELAY_ROLES: dict[str, str] = {
    "worker": "send",
    "manager": "send",
    "learner": "send",
    "storage": "recv",
}
SERVICES = frozenset({"inference"})


@dataclass(frozen=True)
class Fault:
    """One resolved fault clause."""

    action: str
    target: str
    at_s: float | None = None  # process faults: seconds after fleet launch
    p: float | None = None  # probabilistic faults: per-event probability
    delay_ms: float | None = None  # delay/stall: injected latency
    # Transport faults only: which wire proto bytes this fault applies to
    # (None = every frame through the shimmed socket) and which direction
    # of the site's transport it shims.
    protos: frozenset[int] | None = None
    direction: str | None = None  # "send" | "recv"
    site: str | None = None  # role owning the shimmed socket
    # Data faults only: active-window length after at_s (None = forever)
    # and the single worker instance injected (None = every worker).
    dur_s: float | None = None
    wid: int | None = None


def _parse_qualifier(clause: str, qual: str) -> dict:
    if qual.startswith("t+") and qual.endswith("s"):
        try:
            return {"at_s": float(qual[2:-1])}
        except ValueError:
            pass
    elif qual.startswith("p="):
        try:
            p = float(qual[2:])
        except ValueError:
            p = -1.0
        if 0.0 < p <= 1.0:
            return {"p": p}
        raise ValueError(
            f"chaos clause {clause!r}: probability must be in (0, 1], "
            f"got {qual!r}"
        )
    elif qual.startswith("for=") and qual.endswith("s"):
        try:
            dur = float(qual[4:-1])
        except ValueError:
            dur = -1.0
        if dur > 0.0:
            return {"dur_s": dur}
    elif qual.startswith("wid="):
        try:
            return {"wid": int(qual[4:])}
        except ValueError:
            pass
    elif qual.endswith("ms"):
        try:
            ms = float(qual[:-2])
        except ValueError:
            ms = -1.0
        if ms >= 0.0:
            return {"delay_ms": ms}
    raise ValueError(
        f"chaos clause {clause!r}: unknown qualifier {qual!r} "
        "(expected 't+<sec>s', 'p=<prob>', 'for=<sec>s', 'wid=<int>', "
        "or '<ms>ms')"
    )


def _parse_clause(clause: str) -> Fault:
    head, _, tail = clause.partition(":")
    action = head.strip()
    if not tail:
        raise ValueError(
            f"chaos clause {clause!r}: expected 'action:target[@qual...]'"
        )
    if action not in ACTIONS:
        raise ValueError(
            f"chaos clause {clause!r}: unknown action {action!r} "
            f"(one of {sorted(ACTIONS)})"
        )
    parts = [s.strip() for s in tail.split("@")]
    target = parts[0]
    if not target:
        raise ValueError(f"chaos clause {clause!r}: empty target")
    quals: dict = {}
    for qual in parts[1:]:
        quals.update(_parse_qualifier(clause, qual))

    if action in PROCESS_ACTIONS:
        if quals.get("at_s") is None:
            raise ValueError(
                f"chaos clause {clause!r}: {action} needs a 't+<sec>s' "
                "fire time"
            )
        return Fault(action, target, at_s=quals["at_s"])
    if action in DATA_ACTIONS:
        if target not in DATA_TARGETS:
            raise ValueError(
                f"chaos clause {clause!r}: {action} targets payload data "
                f"(one of {sorted(DATA_TARGETS)}), got {target!r}"
            )
        if quals.get("p") is None:
            raise ValueError(
                f"chaos clause {clause!r}: {action} needs 'p=<prob>'"
            )
        return Fault(
            action, target, p=quals["p"], at_s=quals.get("at_s"),
            dur_s=quals.get("dur_s"), wid=quals.get("wid"), site="worker",
        )
    if action in ("corrupt", "drop"):
        if target not in CHANNELS:
            raise ValueError(
                f"chaos clause {clause!r}: {action} targets a channel "
                f"(one of {sorted(CHANNELS)}), got {target!r}"
            )
        if quals.get("p") is None:
            raise ValueError(
                f"chaos clause {clause!r}: {action} needs 'p=<prob>'"
            )
        site, protos = CHANNELS[target]
        return Fault(
            action, target, p=quals["p"], protos=protos,
            direction="recv", site=site,
        )
    if action == "delay":
        if target not in DELAY_ROLES:
            raise ValueError(
                f"chaos clause {clause!r}: delay targets a role "
                f"(one of {sorted(DELAY_ROLES)}), got {target!r}"
            )
        if quals.get("delay_ms") is None:
            raise ValueError(
                f"chaos clause {clause!r}: delay needs a '<ms>ms' latency"
            )
        return Fault(
            action, target, p=quals.get("p", 1.0),
            delay_ms=quals["delay_ms"],
            direction=DELAY_ROLES[target], site=target,
        )
    # stall / refuse: service faults
    if target not in SERVICES:
        raise ValueError(
            f"chaos clause {clause!r}: {action} targets a service "
            f"(one of {sorted(SERVICES)}), got {target!r}"
        )
    if action == "stall":
        if quals.get("delay_ms") is None:
            raise ValueError(
                f"chaos clause {clause!r}: stall needs a '<ms>ms' latency"
            )
        return Fault(
            action, target, p=quals.get("p", 1.0),
            delay_ms=quals["delay_ms"],
        )
    if quals.get("p") is None:
        raise ValueError(f"chaos clause {clause!r}: refuse needs 'p=<prob>'")
    return Fault(action, target, p=quals["p"])


@dataclass(frozen=True)
class FaultPlan:
    """Parsed ``Config.chaos_spec``: the fleet's fault schedule."""

    faults: tuple[Fault, ...]

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        clauses = [c.strip() for c in spec.split(",") if c.strip()]
        if not clauses:
            raise ValueError(f"empty chaos spec {spec!r}")
        return cls(tuple(_parse_clause(c) for c in clauses))

    def process_faults(self) -> list[Fault]:
        """kill/stop/hang clauses, for the supervisor hook."""
        return [f for f in self.faults if f.action in PROCESS_ACTIONS]

    def transport_faults(self, site: str) -> tuple[list[Fault], list[Fault]]:
        """``(send_faults, recv_faults)`` for one role's transport shim."""
        mine = [f for f in self.faults if f.site == site]
        return (
            [f for f in mine if f.direction == "send"],
            [f for f in mine if f.direction == "recv"],
        )

    def service_faults(self, service: str = "inference") -> list[Fault]:
        """stall/refuse clauses for one service."""
        return [
            f
            for f in self.faults
            if f.action in ("stall", "refuse") and f.target == service
        ]

    def data_faults(self, instance: int | None = None) -> list[Fault]:
        """nan/spike clauses, optionally filtered to one worker instance
        (a fault with ``wid=None`` applies to every worker)."""
        return [
            f
            for f in self.faults
            if f.action in DATA_ACTIONS
            and (instance is None or f.wid is None or f.wid == instance)
        ]
