"""AutopilotController: the closed-loop elastic-capacity orchestrator — the
port of ``tpu_rl.autopilot.controller``.

The controller is the orchestrator process itself (the ``autopilot`` CLI
role runs it in the main process, exactly as ``population`` runs the PBT
controller): it owns one :class:`~tpu_rl_torch.runtime.runner.Supervisor`
whose children are the elastic fleet members it manages —
``inference-<i>`` replicas on the portplan's pre-planned port range, and
(optionally) extra workers — plus the autopilot's own telemetry
registry, audit log and status document.

Control flow per poll tick (single-threaded — no new threads beyond the
telemetry HTTP server; the members are processes and the signal scrape
is HTTP against endpoints that already exist):

1. chaos poll + supervision pass (crash/silence respawns — a chaos
   ``kill:inference-*`` mid-scale is absorbed by the same machinery),
2. scrape ``/slo`` + ``/goodput`` + ``/metrics`` into the windowed
   signal store (:mod:`tpu_rl_torch.autopilot.signals`),
3. run the decision engine (:mod:`tpu_rl_torch.autopilot.policy`) over the
   latest signals and current member counts,
4. actuate each decision: spawn the next planned replica index, drain +
   retire the highest, or evict-and-respawn a pegged straggler worker
   (the deliberate-restart pattern — no restart budget burned),
5. publish ``autopilot-*`` gauges/counters and refresh the status doc.

Scaling stays inside the pre-planned port range, so ``FleetClient``
discovery (lane re-probe) and the version floor work
unchanged: a scaled-out replica self-announces on the stat channel,
leases into the ReplicaTable, and receives the learner's join-push of
current weights — the floor never decreases across any action.

A replica serves on the card (B3 on every flush) unless the config says
``learner_device="cpu"``: it is spawned with the card visible, and the
controller itself never opens a CUDA context. A retired replica is
SIGTERMed after the drain and leaves the supervisor, releasing its
context as its process exits.

Every decision appends one line to ``result_dir/autopilot.jsonl``
(:mod:`tpu_rl_torch.obs.audit`); the final summary is written
crash-atomically to ``result_dir/autopilot.json``.
"""

from __future__ import annotations

import functools
import json
import os
import time
from collections import deque
from typing import Any, Callable

from tpu_rl_torch.autopilot.policy import AutopilotSpec, DecisionEngine
from tpu_rl_torch.autopilot.signals import SignalScraper, SignalStore
from tpu_rl_torch.config import Config, MachinesConfig

# Status doc keeps the last N actions for the dashboard panel.
RECENT_ACTIONS = 20


class ReplicaSet:
    """The inference-replica actuator arm: spawn/retire ``inference-<i>``
    children through the controller's supervisor, always inside the
    pre-planned port range.

    ``static`` replicas (indices ``0..static-1``) are owned elsewhere —
    the learner's in-process replica 0 and ``learner_role``'s children —
    and are never touched; the autopilot manages ``static..capacity-1``.
    A standalone deployment (the smoke) sets ``static=0`` and the
    autopilot owns the whole range.
    """

    def __init__(
        self,
        sup,
        cfg: Config,
        machines: MachinesConfig,
        capacity: int,
        static: int = 0,
        seed: int = 0,
    ):
        assert 0 <= static <= capacity, (static, capacity)
        self.sup = sup
        self.cfg = cfg
        self.machines = machines
        self.capacity = capacity
        self.static = static
        self.seed = seed
        # Plan the FULL range once: scale-outs reuse pre-checked ports, so
        # a scaled-out replica lands exactly where FleetClient's planned
        # lane list (and its re-probe backoff) already points.
        self.ports = machines.inference_ports(
            cfg.replace(inference_replicas=capacity)
        )
        self._children: dict[int, Any] = {}  # managed index -> runner.Child

    @property
    def count(self) -> int:
        """Total fleet replica count (static members + managed children,
        retired ones excluded)."""
        return self.static + len(self._children)

    def spawn_index(self, i: int):
        from tpu_rl_torch.fleet import replica_main

        # cpu_only=False leaves the card visible: the port's "auto" learner
        # device is the card, so a replica serves there unless the config
        # says "cpu".
        child = self.sup.spawn(
            f"inference-{i}",
            functools.partial(replica_main, seed=self.seed),
            self.cfg,
            i,
            self.ports[i],
            self.machines.learner_ip,
            self.machines.model_port,
            self.machines.learner_port,
            cpu_only=(self.cfg.learner_device == "cpu"),
        )
        self._children[i] = child
        return child

    def retire_index(self, i: int, drain_s: float) -> None:
        """Drain then kill: in-flight requests are ms-scale, so a bounded
        grace before the SIGTERM lets them complete; clients absorb the
        tail through hedging and re-probe the lane when (if) the index
        returns. The retired Child must leave ``sup.children`` — the
        supervisor would otherwise read the nonzero exit as a crash and
        respawn what the autopilot just scaled in."""
        child = self._children.pop(i)
        if drain_s > 0:
            time.sleep(drain_s)
        self.sup._ensure_dead(child)
        self.sup.children.remove(child)

    def scale_to(self, target: int) -> list[dict]:
        """Move the TOTAL count to ``target`` (clamped to
        [static, capacity]); returns one audit record per member moved."""
        target = max(self.static, min(target, self.capacity))
        events = []
        while self.count < target:
            i = next(
                j for j in range(self.static, self.capacity)
                if j not in self._children
            )
            self.spawn_index(i)
            events.append(
                {"ev": "spawn", "kind": "replica", "index": i,
                 "port": self.ports[i]}
            )
        while self.count > target:
            i = max(self._children)
            port = self.ports[i]
            self.retire_index(i, drain_s=self.cfg.autopilot_drain_s)
            events.append(
                {"ev": "retire", "kind": "replica", "index": i, "port": port,
                 "drain_s": self.cfg.autopilot_drain_s}
            )
        return events


class AutopilotController:
    """Close the loop from fleet health signals to fleet shape. See the
    module docstring for the tick structure."""

    def __init__(
        self,
        cfg: Config,
        machines: MachinesConfig | None = None,
        manage_all: bool = False,
        scrape_url: str | None = None,
        http_port: int | None = None,
        worker_spawn: Callable[[Any, int], Any] | None = None,
        seed: int = 0,
        log: bool = True,
        on_event: Callable[[dict], None] | None = None,
    ):
        assert cfg.autopilot_spec, "autopilot role needs Config.autopilot_spec"
        assert cfg.result_dir, (
            "autopilot role needs result_dir: decisions audit to "
            "result_dir/autopilot.jsonl"
        )
        self.spec = AutopilotSpec.parse(cfg.autopilot_spec)
        self.base = cfg
        self.machines = machines or MachinesConfig()
        self.log = log
        self.on_event = on_event
        self.worker_spawn = worker_spawn

        from tpu_rl_torch.runtime.runner import Supervisor

        self.sup = Supervisor.from_config(cfg)
        self.engine = DecisionEngine(self.spec)
        self.store = SignalStore()
        url = scrape_url or (
            f"http://{self.machines.learner_ip}:{cfg.telemetry_port}"
        )
        self.scraper = SignalScraper(url, store=self.store)

        hi_bounds = [
            r.hi for r in self.spec.rules
            if r.target == "replicas" and r.hi is not None
        ]
        capacity = max([cfg.inference_replicas, *hi_bounds])
        # manage_all: standalone fleets (the smoke) where the autopilot IS
        # the replica owner from index 0; otherwise the statically
        # provisioned members (learner-owned 0..N-1) are off-limits and
        # the autopilot manages only the elastic tail.
        static = 0 if manage_all else cfg.inference_replicas
        self.replicas = ReplicaSet(
            self.sup, cfg, self.machines, capacity=capacity, static=static,
            seed=seed,
        )
        self._initial = cfg.inference_replicas if manage_all else 0

        self._next_worker_idx = 1000  # autopilot-spawned worker name suffix
        self.counts = {
            "actions": 0, "scale_out": 0, "scale_in": 0, "respawns": 0,
            "straggler_respawns": 0, "chaos": 0, "skipped": 0,
        }
        self._recent: deque = deque(maxlen=RECENT_ACTIONS)

        self.aggregator = None
        self.registry = None
        self._http = None
        self._json_exp = None
        self._telem_pub = None
        self._emitter = None
        self._history = None
        self._http_port = (
            http_port if http_port is not None
            else (cfg.telemetry_port + 1 if cfg.telemetry_port > 0 else 0)
        )
        self._setup_telemetry()
        # Restart rehydration (run-history plane): a respawned controller
        # inherits the dead one's signal windows — ALL kinds, so sustain
        # streaks resume instead of restarting from empty.
        self.n_rehydrated = 0
        if self._history is not None:
            from tpu_rl_torch.autopilot.signals import rehydrate_signals

            self.n_rehydrated = rehydrate_signals(self.store, self._history)

    # ------------------------------------------------------------- telemetry
    def _setup_telemetry(self) -> None:
        cfg = self.base
        if not cfg.telemetry_enabled:
            return
        from tpu_rl_torch.obs import (
            JsonExporter,
            MetricsRegistry,
            PeriodicSnapshot,
            TelemetryAggregator,
            TelemetryHTTPServer,
            maybe_history,
        )
        from tpu_rl_torch.runtime.protocol import Protocol
        from tpu_rl_torch.runtime.transport import make_data_pub

        self.registry = MetricsRegistry(role="autopilot")
        self.aggregator = TelemetryAggregator(
            registry=self.registry, stale_after_s=cfg.telemetry_stale_s
        )
        # The autopilot-* registry rides the fleet's stat channel (the
        # storage SUB on the learner host) so the gauges land on the SAME
        # /metrics page every other role reports to.
        self._telem_pub = make_data_pub(
            cfg, self.machines.learner_ip, self.machines.learner_port,
            bind=False,
        )
        pub = self._telem_pub
        self._emitter = PeriodicSnapshot(
            self.registry,
            lambda snap: pub.send(Protocol.Telemetry, snap),
            interval_s=cfg.telemetry_interval_s,
        )
        # Self-served history store (the controller is its own storage
        # side): autopilot-* metrics plus every scraped signal window, fed
        # on the exporter cadence, queryable live and rehydrated on restart.
        self._history = maybe_history(cfg)
        if self._http_port > 0:
            self._http = TelemetryHTTPServer(
                self.aggregator, self._http_port, autopilot=self.status_doc,
                query=(
                    self._history.http_query
                    if self._history is not None else None
                ),
            )
        self._json_exp = JsonExporter(
            self.aggregator,
            os.path.join(cfg.result_dir, "telemetry.json"),
            interval_s=cfg.telemetry_interval_s,
        )

    def _tick_metrics(self) -> None:
        if self.registry is None:
            return
        reg = self.registry
        reg.gauge("autopilot-replicas").set(float(self.replicas.count))
        reg.gauge("autopilot-workers").set(float(self._worker_count()))
        reg.counter("autopilot-actions").set_total(self.counts["actions"])
        reg.counter("autopilot-scale-out").set_total(self.counts["scale_out"])
        reg.counter("autopilot-scale-in").set_total(self.counts["scale_in"])
        reg.counter("autopilot-respawns").set_total(
            self.counts["straggler_respawns"]
        )
        reg.counter("autopilot-rate-limited").set_total(
            self.engine.n_rate_limited
        )
        reg.counter("autopilot-clamped").set_total(self.engine.n_clamped)
        reg.counter("autopilot-scrape-errors").set_total(self.scraper.n_errors)
        if self._emitter is not None:
            self._emitter.maybe_emit()
        if self._json_exp is not None and self._json_exp.maybe_export():
            if self._history is not None:
                from tpu_rl_torch.autopilot.signals import signal_channels

                # One history row per export: own metrics + the latest
                # value of every scraped signal (the rehydration source).
                self._history.record(
                    self.aggregator, extra=signal_channels(self.store)
                )

    # ----------------------------------------------------------------- audit
    def _event(self, ev: dict) -> None:
        from tpu_rl_torch.obs.audit import append_jsonl

        ev = {**ev, "t": time.time()}
        append_jsonl(self.base.result_dir, "autopilot.jsonl", ev)
        if self.log:
            print(f"[autopilot] {json.dumps(ev)}", flush=True)
        if self.on_event is not None:
            self.on_event(ev)

    # ------------------------------------------------------------ status doc
    def status_doc(self) -> dict:
        """The live ``GET /autopilot`` payload (and the dashboard panel's
        input): counts, recent actions with reasons, cooldown status."""
        return {
            "replicas": self.replicas.count,
            "replica_capacity": self.replicas.capacity,
            "workers": self._worker_count(),
            "actions": list(self._recent),
            "cooldowns": self.engine.cooldowns(),
            "counts": dict(self.counts),
            "rate_limited": self.engine.n_rate_limited,
            "clamped": self.engine.n_clamped,
            "rehydrated": self.n_rehydrated,
            "signals": self.store.snapshot(),
        }

    def _worker_count(self) -> int:
        return sum(
            1 for c in self.sup.children
            if c.name.startswith("worker-") and c.proc.is_alive()
        )

    # -------------------------------------------------------------- actuation
    def _apply(self, decision: dict) -> None:
        action, target = decision["action"], decision["target"]
        if action == "respawn":
            self._respawn_worker(decision)
            return
        if target == "replicas":
            events = self.replicas.scale_to(decision["to"])
            if not events:
                self.counts["skipped"] += 1
                self._event(
                    {**decision, "ev": "action-skip",
                     "skip_reason": "replica count already at bound"}
                )
                return
            self._record_action(decision)
            for sub in events:
                self._event(sub)
            return
        # target == "workers"
        if action == "scale_out":
            if self.worker_spawn is None:
                self.counts["skipped"] += 1
                self._event(
                    {**decision, "ev": "action-skip",
                     "skip_reason": "no worker spawn factory wired"}
                )
                return
            for _ in range(decision["step"]):
                idx = self._next_worker_idx
                self._next_worker_idx += 1
                self.worker_spawn(self.sup, idx)
                self._event({"ev": "spawn", "kind": "worker", "index": idx})
            self._record_action(decision)
        else:  # scale_in: retire the newest autopilot-spawned workers first
            managed = [
                c for c in self.sup.children
                if c.name.startswith("worker-a-") and c.proc.is_alive()
            ]
            if not managed:
                self.counts["skipped"] += 1
                self._event(
                    {**decision, "ev": "action-skip",
                     "skip_reason": "no autopilot-managed workers to retire"}
                )
                return
            for child in sorted(managed, key=lambda c: c.name)[
                -decision["step"]:
            ]:
                self.sup._ensure_dead(child)
                self.sup.children.remove(child)
                self._event(
                    {"ev": "retire", "kind": "worker", "child": child.name}
                )
            self._record_action(decision)

    def _respawn_worker(self, decision: dict) -> None:
        wid = decision.get("wid")
        suffix = f"-{wid}"
        child = next(
            (
                c for c in self.sup.children
                if c.name.startswith("worker-") and c.name.endswith(suffix)
                and not c.exhausted
            ),
            None,
        )
        if child is None:
            self.counts["skipped"] += 1
            self._event(
                {**decision, "ev": "action-skip",
                 "skip_reason": f"no supervised child for wid {wid}"}
            )
            return
        # Deliberate evict-and-respawn (the population exploit pattern):
        # straight back through _start, no restart budget burned — the
        # straggler is presumed wedged, not buggy. Quarantine at
        # the storage edge remains the data-plane enforcement arm; this is
        # the process-plane one.
        self.sup._ensure_dead(child)
        self.sup._start(child)
        self.counts["straggler_respawns"] += 1
        self._record_action({**decision, "child": child.name})

    def _record_action(self, decision: dict) -> None:
        self.counts["actions"] += 1
        if decision["action"] == "scale_out":
            self.counts["scale_out"] += 1
        elif decision["action"] == "scale_in":
            self.counts["scale_in"] += 1
        record = {**decision, "ev": "action", "replicas": self.replicas.count,
                  "workers": self._worker_count()}
        self._recent.append({**record, "t": time.time()})
        self._event(record)

    # ------------------------------------------------------------------- run
    def install_signal_handlers(self) -> None:
        self.sup.install_signal_handlers()

    def run(self) -> dict:
        """Drive the loop until external stop (the normal end for a pilot
        daemon) or a child exhausting its restart budget (failure).
        Returns the final summary (also at ``result_dir/autopilot.json``)."""
        os.makedirs(self.base.result_dir, exist_ok=True)
        self._event(
            {
                "ev": "start",
                "spec": self.base.autopilot_spec,
                "capacity": self.replicas.capacity,
                "static": self.replicas.static,
                "initial": self._initial,
                "rules": len(self.spec.rules),
                "scrape_url": self.scraper.base_url,
            }
        )
        if self._initial:
            for sub in self.replicas.scale_to(
                self.replicas.static + self._initial
            ):
                self._event(sub)
        poll = self.base.autopilot_poll_s
        ok = True
        while not self.sup.stop_event.is_set():
            if self.sup.chaos is not None:
                for action, name in self.sup.chaos.poll(self.sup.children):
                    self.counts["chaos"] += 1
                    self._event(
                        {"ev": "chaos", "action": action, "target": name}
                    )
            for name in self.sup.check():
                self.counts["respawns"] += 1
                self._event({"ev": "respawn", "child": name})
            signals, meta = self.scraper.poll()
            counts = {
                "replicas": self.replicas.count,
                "workers": self._worker_count(),
            }
            for decision in self.engine.decide(signals, counts, meta=meta):
                self._apply(decision)
            self._tick_metrics()
            if any(c.exhausted for c in self.sup.children):
                self._event({"ev": "exhausted"})
                ok = False
                break
            time.sleep(poll)
        self.sup.stop()
        self._tick_metrics()
        doc = {
            "ok": ok,
            "replicas": self.replicas.count,
            "workers": self._worker_count(),
            "counts": dict(self.counts),
            "rate_limited": self.engine.n_rate_limited,
            "clamped": self.engine.n_clamped,
            "decisions": self.engine.n_decisions,
            "polls": self.scraper.n_polls,
        }
        self._write_doc(doc)
        if self._emitter is not None:
            self._emitter.maybe_emit(now=float("inf"))
        if self._json_exp is not None:
            self._json_exp.maybe_export(now=float("inf"))
        if self._history is not None:
            from tpu_rl_torch.autopilot.signals import signal_channels

            # Final row + release the active chunk handle.
            self._history.record(
                self.aggregator, extra=signal_channels(self.store)
            )
            self._history.close()
        if self._http is not None:
            self._http.close()
        if self._telem_pub is not None:
            self._telem_pub.close()
        self._event({"ev": "done", "ok": ok, "counts": dict(self.counts)})
        return doc

    def _write_doc(self, doc: dict) -> None:
        path = os.path.join(self.base.result_dir, "autopilot.json")
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
