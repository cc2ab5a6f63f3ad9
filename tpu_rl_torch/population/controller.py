"""PopulationController: seeded truncation-selection PBT over K members —
the port of ``tpu_rl.population.controller``.

The controller is the orchestrator process itself (the ``population`` CLI
role runs it in the main process, exactly as the other roles run their
supervisor): it owns one :class:`~tpu_rl_torch.runtime.runner.Supervisor` whose
children are the K members (``member-<k>``, heartbeated, respawned on a
crash), plus the population's own telemetry registry, audit log and
leaderboard. The controller opens no CUDA context (it imports torch but
never touches a card); each member process opens its own.

Control flow per poll tick (single-threaded — no new threads; the members
are processes and the telemetry scrape is file-based):

1. supervision pass (crash/silence respawns; ``tpu_rl`` polls its chaos
   plane first, which the port does not have yet: ``chaos_spec`` is
   refused at config load),
2. scrape every member's ``telemetry.json`` (the PR 4 JSON exporter —
   zero new member-side protocol) for the fitness gauge and the progress
   counter,
3. publish the leaderboard onto the controller's own registry (served at
   ``/metrics`` when ``telemetry_port`` is set, snapshotted to
   ``result_dir/telemetry.json``),
4. when a generation boundary is reached (every ``interval`` member
   updates or wall seconds), run truncation selection: each bottom-
   quantile member is stopped, adopts a top-quantile winner's newest
   COMMITTED checkpoint (``checkpoint.copy_committed`` — two-phase commit
   preserved, so a kill mid-copy leaves the loser resumable from its own
   previous checkpoint) and the winner's hyperparameters, mutates them
   (``spec.mutate``), and restarts at a bumped run epoch.

Every decision appends one line to ``result_dir/population.jsonl``; the
final leaderboard + lineage tree is written crash-atomically to
``result_dir/population.json``.
"""

from __future__ import annotations

import json
import os
import random
import time
from dataclasses import dataclass, field as dc_field
from typing import Any, Callable

from tpu_rl_torch.config import Config, MachinesConfig
from tpu_rl_torch.population.spec import (
    DEFAULT_FITNESS,
    DEFAULT_PROGRESS,
    PopSpec,
    fold_in,
    member_seed,
    mutate,
    sample_member,
    truncation_select,
)

# Distributed members report progress via the learner's authoritative
# policy-version gauge (obs/aggregator.py).
DISTRIBUTED_PROGRESS = "learner-update-index"


@dataclass
class MemberState:
    """Controller-side view of one population member."""

    idx: int
    dir: str
    seed: int
    values: dict  # current searchable hyperparameter values
    child: Any = None  # runner.Child once spawned
    fitness: float | None = None  # newest scraped fitness reading
    best_fitness: float = float("-inf")
    progress: float = 0.0  # scraped update counter (absolute)
    generation: int = 0  # generations this member has survived/absorbed
    exploits: int = 0  # times this member was truncation-replaced
    lineage: list = dc_field(default_factory=list)


def flatten_telemetry(doc: dict) -> dict[str, float]:
    """Last-wins ``{metric-name: value}`` over every source's counters and
    gauges in one telemetry.json document (labels dropped — the member's
    fitness/progress metrics are unlabeled)."""
    flat: dict[str, float] = {}
    for src in doc.get("sources", []):
        for kind in ("counters", "gauges"):
            for row in src.get(kind, []):
                name, _labels, value = row[0], row[1], row[2]
                flat[name] = float(value)
    return flat


def population_doc(
    members: list[MemberState],
    generation: int,
    counts: dict[str, int],
    ok: bool,
) -> dict:
    """The final ``population.json`` document: leaderboard (best fitness
    first) + per-member lineage tree. Pure so tests can pin the schema."""
    ranked = sorted(
        members, key=lambda m: (-m.best_fitness, m.idx)
    )
    return {
        "ok": bool(ok),
        "generation": int(generation),
        "counts": dict(counts),
        "leaderboard": [
            {
                "member": m.idx,
                "fitness": m.fitness,
                "best_fitness": (
                    None if m.best_fitness == float("-inf")
                    else m.best_fitness
                ),
                "values": m.values,
                "seed": m.seed,
                "generation": m.generation,
                "exploits": m.exploits,
            }
            for m in ranked
        ],
        "lineage": {str(m.idx): m.lineage for m in members},
    }


class PopulationController:
    """Launch, score and evolve K hyperparameter variants. See module doc."""

    def __init__(
        self,
        cfg: Config,
        machines: MachinesConfig | None = None,
        max_updates: int | None = None,
        log: bool = True,
        initial_values: dict[int, dict] | None = None,
        on_event: Callable[[dict], None] | None = None,
    ):
        assert cfg.pop_spec, "population role needs Config.pop_spec"
        assert cfg.result_dir, (
            "population role needs result_dir: members live in "
            "result_dir/member-<k>/"
        )
        self.spec = PopSpec.parse(cfg.pop_spec)
        self.spec.check_searchable()
        self.base = cfg
        self.machines = machines or MachinesConfig()
        self.max_updates = max_updates
        self.log = log
        self.on_event = on_event
        if cfg.env_mode == "colocated":
            self._fitness_metric = self.spec.fitness or DEFAULT_FITNESS
            self._progress_metric = DEFAULT_PROGRESS
        else:
            assert self.spec.fitness, (
                "distributed members have no default fitness gauge: name "
                "one in the pop spec, e.g. 'fitness=learner-mean-reward'"
            )
            self._fitness_metric = self.spec.fitness
            self._progress_metric = DISTRIBUTED_PROGRESS

        from tpu_rl_torch.runtime.portplan import (
            plan_member_port_blocks,
            plan_member_telemetry_ports,
        )

        self._tele_ports = plan_member_telemetry_ports(
            self.machines, cfg, self.spec.k
        )
        self._port_blocks = (
            plan_member_port_blocks(self.machines, cfg, self.spec.k)
            if cfg.env_mode == "distributed"
            else None
        )

        from tpu_rl_torch.runtime.runner import Supervisor

        self.sup = Supervisor.from_config(cfg)
        self.generation = 0
        self.counts = {"evals": 0, "exploits": 0, "respawns": 0, "chaos": 0}
        # Seeded initial sampling; `initial_values` overlays explicit values
        # per member idx (the smoke's deliberately-poisoned variant).
        self.members = []
        for i in range(self.spec.k):
            values = sample_member(self.spec, cfg.pop_seed, i)
            values.update((initial_values or {}).get(i, {}))
            m = MemberState(
                idx=i,
                dir=os.path.join(cfg.result_dir, f"member-{i}"),
                seed=member_seed(cfg.pop_seed, i),
                values=values,
            )
            m.lineage.append({"ev": "init", "values": dict(values)})
            self.members.append(m)

        self.aggregator = None
        self._http = None
        self._json_exp = None
        self._setup_telemetry()

    # ------------------------------------------------------------- telemetry
    def _setup_telemetry(self) -> None:
        cfg = self.base
        if not cfg.telemetry_enabled:
            return
        from tpu_rl_torch.obs import (
            JsonExporter,
            MetricsRegistry,
            TelemetryAggregator,
            TelemetryHTTPServer,
        )

        self.aggregator = TelemetryAggregator(
            registry=MetricsRegistry(role="population"),
            stale_after_s=cfg.telemetry_stale_s,
        )
        if cfg.telemetry_port > 0:
            self._http = TelemetryHTTPServer(
                self.aggregator, cfg.telemetry_port
            )
        self._json_exp = JsonExporter(
            self.aggregator,
            os.path.join(cfg.result_dir, "telemetry.json"),
            interval_s=cfg.telemetry_interval_s,
        )

    def _tick_metrics(self) -> None:
        if self.aggregator is None:
            return
        reg = self.aggregator.registry
        alive = sum(
            1 for m in self.members
            if m.child is not None and m.child.proc.is_alive()
        )
        best = max(
            (m.best_fitness for m in self.members), default=float("-inf")
        )
        reg.gauge("population-members-alive").set(float(alive))
        reg.gauge("population-generation").set(float(self.generation))
        if best != float("-inf"):
            reg.gauge("population-best-fitness").set(best)
        for m in self.members:
            if m.fitness is not None:
                reg.gauge(
                    "population-member-fitness",
                    labels={"member": str(m.idx)},
                ).set(m.fitness)
        reg.counter("population-evals").set_total(self.counts["evals"])
        reg.counter("population-exploits").set_total(self.counts["exploits"])
        reg.counter("population-member-respawns").set_total(
            self.counts["respawns"]
        )
        if self._json_exp is not None:
            self._json_exp.maybe_export()

    # ----------------------------------------------------------------- audit
    def _event(self, ev: dict) -> None:
        from tpu_rl_torch.obs.audit import append_jsonl

        # Stamp before appending so the printed/forwarded event carries the
        # same `t` the audit line does (append_jsonl keeps an existing `t`).
        ev = {**ev, "t": time.time()}
        append_jsonl(self.base.result_dir, "population.jsonl", ev)
        if self.log:
            print(f"[population] {json.dumps(ev)}", flush=True)
        if self.on_event is not None:
            self.on_event(ev)

    # ----------------------------------------------------------------- spawn
    def _member_cfg(self, m: MemberState) -> Config:
        over: dict[str, Any] = dict(m.values)
        over.update(
            result_dir=m.dir,
            model_dir=os.path.join(m.dir, "models"),
            telemetry_port=self._tele_ports[m.idx],
            # Members are plain runs: no nested populations.
            pop_spec=None,
        )
        return self.base.replace(**over)

    def _member_machines(self, idx: int) -> dict | None:
        """Per-member nested-fleet topology (distributed members only):
        the member's fleet ports live in its private collision-checked
        block — learner at +0 (model broadcast at +1, inference at +2 by
        the derived conventions), managers from +4."""
        if self._port_blocks is None:
            return None
        base = self._port_blocks[idx]
        return {
            "learner": {"ip": "127.0.0.1", "port": base},
            "workers": [
                {
                    "num_p": w.num_p,
                    "manager_ip": "127.0.0.1",
                    "ip": "127.0.0.1",
                    "port": base + 4 + j,
                }
                for j, w in enumerate(self.machines.workers)
            ],
        }

    def _spawn_member(self, m: MemberState) -> None:
        from tpu_rl_torch.population.member import member_main, write_member_meta

        os.makedirs(m.dir, exist_ok=True)
        cfg = self._member_cfg(m)
        cfg.to_json(os.path.join(m.dir, "config.json"))
        write_member_meta(
            m.dir,
            {
                "idx": m.idx,
                "seed": m.seed,
                "max_updates": self.max_updates,
                "machines": self._member_machines(m.idx),
            },
        )
        m.child = self.sup.spawn(
            f"member-{m.idx}",
            member_main,
            m.dir,
            cpu_only=(cfg.learner_device == "cpu"),
            # A distributed member runs a nested fleet and therefore cannot
            # be a daemonic process (no grandchildren allowed).
            daemon=(cfg.env_mode == "colocated"),
        )
        self._event(
            {"ev": "spawn", "member": m.idx, "values": dict(m.values)}
        )

    # ---------------------------------------------------------------- scrape
    def _scrape(self, m: MemberState) -> None:
        try:
            with open(os.path.join(m.dir, "telemetry.json")) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return  # not written yet / replaced mid-read: next tick
        flat = flatten_telemetry(doc)
        fit = flat.get(self._fitness_metric)
        if fit is not None:
            # A diverged member (NaN loss -> NaN return gauge) must rank as
            # the worst loser, not poison the sort order or the JSON docs.
            if fit != fit or fit in (float("inf"), float("-inf")):
                fit = -1e30
            m.fitness = fit
            m.best_fitness = max(m.best_fitness, fit)
        prog = flat.get(self._progress_metric)
        if prog is not None:
            m.progress = prog

    # ------------------------------------------------------------- selection
    def _finished(self, m: MemberState) -> bool:
        c = m.child
        return (
            c is not None
            and not c.proc.is_alive()
            and c.proc.exitcode == 0
            and not c.respawn_at
        )

    def _eval_due(self, now: float, last_eval: float) -> bool:
        if self.spec.interval_unit == "s":
            return now - last_eval >= self.spec.interval
        threshold = (self.generation + 1) * self.spec.interval
        running = [m for m in self.members if not self._finished(m)]
        if not running:
            return False
        return all(m.progress >= threshold for m in running)

    def _evaluate(self) -> None:
        gen = self.generation
        self.counts["evals"] += 1
        # Losers must be replaceable (still running); winners only need a
        # committed checkpoint, so members that already finished their
        # budget can still be copied from.
        fitness = {
            m.idx: m.fitness
            for m in self.members
            if m.fitness is not None
        }
        losers, winners = truncation_select(fitness, self.spec.quantile)
        self._event(
            {
                "ev": "eval",
                "gen": gen,
                "fitness": {str(k): v for k, v in fitness.items()},
                "losers": losers,
                "winners": winners,
            }
        )
        by_idx = {m.idx: m for m in self.members}
        rng = random.Random(fold_in(self.base.pop_seed, gen, 0x5E1))
        for loser_idx in losers:
            winner_idx = winners[0] if len(winners) == 1 else rng.choice(
                winners
            )
            loser, winner = by_idx[loser_idx], by_idx[winner_idx]
            if (
                self._finished(loser)
                or loser.child is None
                or loser.child.exhausted
                or loser.child.respawn_at
            ):
                self._event(
                    {
                        "ev": "exploit-skip",
                        "gen": gen,
                        "loser": loser_idx,
                        "reason": "loser not running",
                    }
                )
                continue
            if fitness[winner_idx] <= fitness[loser_idx]:
                self._event(
                    {
                        "ev": "exploit-skip",
                        "gen": gen,
                        "loser": loser_idx,
                        "reason": "no strictly better winner",
                    }
                )
                continue
            self._exploit(loser, winner, gen)
        self.generation = gen + 1

    def _exploit(
        self, loser: MemberState, winner: MemberState, gen: int
    ) -> None:
        """Stop the loser, copy the winner's newest COMMITTED checkpoint
        into its model_dir (two-phase — see checkpoint.copy_committed),
        adopt + mutate the winner's hyperparameters, restart at a bumped
        run epoch. The stop -> copy -> rewrite -> start sequence runs
        entirely inside this (single-threaded) poll tick, so the
        supervisor's own check() never races a half-exploited member."""
        from tpu_rl_torch import checkpoint as ck

        algo = self.base.algo
        win = ck.latest_committed(
            os.path.join(winner.dir, "models"), algo
        )
        if win is None:
            self._event(
                {
                    "ev": "exploit-skip",
                    "gen": gen,
                    "loser": loser.idx,
                    "winner": winner.idx,
                    "reason": "winner has no committed checkpoint",
                }
            )
            return
        win_idx, win_path = win
        self.sup._ensure_dead(loser.child)
        loser_models = os.path.join(loser.dir, "models")
        lose = ck.latest_committed(loser_models, algo)
        lose_idx = lose[0] if lose else -1
        lose_epoch = int(ck.read_meta(lose[1]).get("epoch", -1)) if lose else -1
        # The copied index must become the loser's newest (newest-committed
        # wins on resume), and the marker epoch must exceed the loser's own
        # chain so the resumed run's epoch (meta + 1) fences everything the
        # pre-exploit incarnation produced.
        new_idx = max(win_idx, lose_idx + 1)
        new_epoch = lose_epoch + 1
        old_values = dict(loser.values)
        new_values = mutate(
            self.spec, winner.values, self.base.pop_seed, loser.idx, gen
        )
        ck.copy_committed(
            win_path,
            loser_models,
            algo,
            new_idx,
            {
                "epoch": new_epoch,
                "pop": {
                    "winner": winner.idx,
                    "loser": loser.idx,
                    "src_idx": win_idx,
                    "gen": gen,
                },
            },
        )
        loser.values = new_values
        loser.generation = gen + 1
        loser.exploits += 1
        # Adopting the winner's trained policy resets the loser's fitness
        # story: the pre-copy best must not shadow post-copy readings on
        # the leaderboard (the next scrape refreshes `fitness` itself).
        loser.best_fitness = float("-inf")
        cfg = self._member_cfg(loser)
        cfg.to_json(os.path.join(loser.dir, "config.json"))
        loser.lineage.append(
            {
                "ev": "exploit",
                "gen": gen,
                "winner": winner.idx,
                "src_idx": win_idx,
                "dst_idx": new_idx,
                "epoch": new_epoch,
                "values": dict(new_values),
            }
        )
        self.counts["exploits"] += 1
        # Deliberate stop/restart, not a crash: hand the child straight
        # back to the supervisor's bookkeeping without burning its restart
        # budget or entering backoff.
        self.sup._start(loser.child)
        self._event(
            {
                "ev": "exploit",
                "gen": gen,
                "loser": loser.idx,
                "winner": winner.idx,
                "src_idx": win_idx,
                "dst_idx": new_idx,
                "epoch": new_epoch,
                "old_values": old_values,
                "values": dict(new_values),
                "pid": loser.child.proc.pid,
            }
        )

    # ------------------------------------------------------------------- run
    def install_signal_handlers(self) -> None:
        self.sup.install_signal_handlers()

    def run(self) -> dict:
        """Drive the population to completion (every member finishes its
        budget) or failure (a member exhausts its restart budget / external
        stop). Returns the final population summary (also written to
        ``result_dir/population.json``)."""
        os.makedirs(self.base.result_dir, exist_ok=True)
        for m in self.members:
            self._spawn_member(m)
        poll = self.base.supervise_poll_s
        last_eval = time.time()
        ok = True
        while not self.sup.stop_event.is_set():
            for name in self.sup.check():
                self.counts["respawns"] += 1
                self._event({"ev": "respawn", "member": name})
            for m in self.members:
                self._scrape(m)
            self._tick_metrics()
            if any(
                m.child is not None and m.child.exhausted
                for m in self.members
            ):
                self._event({"ev": "exhausted"})
                ok = False
                break
            if all(self._finished(m) for m in self.members):
                break
            now = time.time()
            if self._eval_due(now, last_eval):
                last_eval = now
                self._evaluate()
            time.sleep(poll)
        else:
            ok = False  # external stop (signal): an incomplete run
        self.sup.stop()
        for m in self.members:
            self._scrape(m)  # members flushed a final snapshot on exit
        self._tick_metrics()
        doc = population_doc(self.members, self.generation, self.counts, ok)
        self._write_doc(doc)
        if self._json_exp is not None:
            self._json_exp.maybe_export(now=float("inf"))
        if self._http is not None:
            self._http.close()
        self._event({"ev": "done", "ok": ok, "counts": dict(self.counts)})
        return doc

    def _write_doc(self, doc: dict) -> None:
        path = os.path.join(self.base.result_dir, "population.json")
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
