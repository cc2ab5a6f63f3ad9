"""Learner-storage process: bridge from the DCN transport into device-feedable
shared memory — the port of ``tpu_rl.runtime.storage``. Storage also keeps
the inference fleet's replica table (:class:`~tpu_rl_torch.fleet.membership.
ReplicaTable`, leased from the replicas' telemetry). The chaos hooks come
with the operations slice; the port's Config refuses chaos until then.

Capability parity with the reference ``LearnerStorage``
(``agents/learner_storage.py:25-159``): SUB-bind on the
learner port, push Rollout steps through the assembler, write completed
windows into the shm store, relay episode-reward stats into the 3-float stat
mailbox ``[global_game_count, mean_rew, activate]``
(``learner_storage.py:104-121``, created at ``main.py:324-326``).

This is the storage edge of the zero-copy fan-in: the one hop that
runs the full frame validation (CRC + decompress + schema unpack, inside
``Sub.recv``/``drain``) — relays upstream only ``peek`` the header. Whole
worker ticks then enter the assembler columnar-wise via
``RolloutAssembler.push_tick`` (row views per env, no per-step dicts) and
completed windows leave in bursts via the stores' ``put_many`` (one slice
write per field). ``Config.relay_mode="decode"`` keeps the per-step
``split_rollout_batch`` + ``push`` reference path as the A/B baseline.
"""

from __future__ import annotations

import os
import time

from tpu_rl_torch.config import Config
from tpu_rl_torch.data.assembler import RolloutAssembler, split_rollout_batch
from tpu_rl_torch.data.layout import BatchLayout
from tpu_rl_torch.data.shm_ring import ShmHandles, make_store
from tpu_rl_torch.runtime.mailbox import (
    SLOT_ACTIVATE,
    SLOT_FORWARD_BYTES,
    SLOT_GAME_COUNT,
    SLOT_JOIN_REQ,
    SLOT_MEAN_REW,
    SLOT_MODEL_LOADS,
    SLOT_REJECTED,
    SLOT_RELAY_DROPPED,
    SLOT_RUN_EPOCH,
    STAT_SLOTS,
)
from tpu_rl_torch.runtime.protocol import Protocol, unpack_trace
from tpu_rl_torch.runtime.transport import Sub, make_data_sub

# Slot layout lives in tpu_rl_torch.runtime.mailbox (shared with the learner's
# reader); STAT_SLOTS is re-exported here for existing importers.
__all__ = ["LearnerStorage", "MembershipTable", "STAT_SLOTS", "storage_main"]


class MembershipTable:
    """Lease-based live membership of acting workers, keyed by wid.

    Any frame carrying a wid (RolloutBatch or Telemetry) renews the lease;
    silence past ``lease_s`` evicts. The table is always on (one dict write
    per frame) because the JOIN signal is functional, not observational: a
    new wid raises the learner's immediate weight-push flag so a joining or
    supervisor-respawned worker converges onto the live policy at once
    instead of waiting out ``rebroadcast_idle_s``. Join/evict totals and the
    active-count gauge surface through the telemetry plane when it's on.
    """

    def __init__(self, lease_s: float, clock=time.monotonic):
        self.lease_s = float(lease_s)
        self._clock = clock
        self.active: dict[int, float] = {}  # wid -> last-seen monotonic
        self.n_joined = 0
        self.n_evicted = 0
        # Quarantine plane (tpu_rl_torch.heal): per-wid poisoned-frame strikes and
        # the quarantined set (wid -> last-strike monotonic). A quarantined
        # wid keeps its LEASE (it is alive, just untrusted) — its rollout
        # frames are dropped at the ingress edge until a clean re-probe.
        self.strikes: dict[int, int] = {}
        self.quarantined: dict[int, float] = {}
        self.n_quarantines = 0
        self.n_unquarantines = 0

    def touch(self, wid: int, now: float | None = None) -> bool:
        """Renew wid's lease; True iff this is a (re)join."""
        now = self._clock() if now is None else now
        joined = wid not in self.active
        if joined:
            self.n_joined += 1
        self.active[wid] = now
        return joined

    def evict_expired(self, now: float | None = None) -> list[int]:
        now = self._clock() if now is None else now
        dead = [w for w, t in self.active.items() if now - t > self.lease_s]
        for w in dead:
            del self.active[w]
            self.n_evicted += 1
        return dead

    # ------------------------------------------------- quarantine (hot path)
    def strike(self, wid: int, limit: int, now: float | None = None) -> bool:
        """One poisoned frame from wid; True iff this strike quarantines it.
        An already-quarantined wid refreshes its last-strike time (the
        clean-re-probe cooldown restarts)."""
        now = self._clock() if now is None else now
        self.strikes[wid] = self.strikes.get(wid, 0) + 1
        if wid in self.quarantined:
            self.quarantined[wid] = now
            return False
        if self.strikes[wid] >= limit:
            self.quarantined[wid] = now
            self.n_quarantines += 1
            return True
        return False

    def is_quarantined(self, wid: int) -> bool:
        return wid in self.quarantined

    def probe_clear(
        self, wid: int, cooldown: float, now: float | None = None
    ) -> bool:
        """A CLEAN frame arrived from a quarantined wid: clear the
        quarantine (and its strikes) iff the last poisoned frame is at
        least ``cooldown`` seconds old. True = cleared, frame admissible."""
        now = self._clock() if now is None else now
        if now - self.quarantined[wid] >= cooldown:
            del self.quarantined[wid]
            self.strikes[wid] = 0
            self.n_unquarantines += 1
            return True
        return False


class LearnerStorage:
    def __init__(
        self,
        cfg: Config,
        handles: ShmHandles,
        learner_port: int,
        stat_array=None,
        stop_event=None,
        heartbeat=None,
    ):
        self.cfg = cfg
        self.handles = handles
        self.learner_port = learner_port
        self.stat_array = stat_array
        self.stop_event = stop_event
        self.heartbeat = heartbeat
        self.game_count = 0
        self.n_windows = 0
        self.n_requeue_full = 0  # windows requeued because the store was full
        self._sub: Sub | None = None
        # Run-epoch fence (durable-fleet plane): the highest epoch learned
        # from the mailbox slot (primary — the mp.Array outlives child
        # respawns, so a respawned storage re-arms instantly) or from frame
        # echoes. Frames stamped with a KNOWN older epoch were acted under a
        # pre-crash learner incarnation: dropped and counted here, never
        # mixed into training and never conflated with corrupt-frame
        # n_rejected (chaos parity). epoch < 0 = unknown, always accepted.
        self.run_epoch = -1
        self.n_stale_epoch = 0
        # Worker join/leave registry (heartbeat lease over frame arrivals).
        self.members = MembershipTable(cfg.membership_lease_s)
        # Inference-replica registry: the same leases keyed by the `rid` on
        # replica telemetry snapshots, with each replica's served version
        # and the fleet's version floor. Imported here: fleet.membership
        # subclasses MembershipTable from this module.
        from tpu_rl_torch.fleet.membership import ReplicaTable

        self.replicas = ReplicaTable(cfg.membership_lease_s)
        self._next_evict = 0.0
        # Telemetry plane (tpu_rl_torch.obs): the aggregator lives HERE — storage
        # is the learner-side edge of the stat channel, the one hop every
        # role's snapshots already reach. None when disabled; every call
        # site guards on that, so the off state costs one check per frame.
        self.aggregator = None
        self._http = None
        self._json_exp = None
        self._tb_exp = None
        # Run-history plane (tpu_rl_torch.obs.history): the embedded time-series
        # store fed on the JSON exporter's cadence; /query serves it live.
        # None when the plane is off — one `is None` check per export tick.
        self._history = None
        # Goodput plane (tpu_rl_torch.obs.goodput): this loop's own wall-clock
        # ledger plus the per-wid straggler signals the fleet report is
        # built from. `_wid_frames` doubles as the plane gate on the ingest
        # hot path (None when telemetry is off — one `is None` check per
        # frame, same discipline as the aggregator above).
        self.ledger = None
        self._wid_frames = None  # wid -> cumulative admitted frames
        self._wid_ver = {}  # wid -> last echoed policy version
        self._wid_rtt = {}  # wid -> rtt EWMA, seconds
        self._wid_rate = {}  # wid -> frames/s over the last straggler tick
        self._frames_prev = {}  # wid -> (count, t_mono) at the last tick
        self._straggler_top = []  # last top-k report (GET /goodput)
        # SLO engine (tpu_rl_torch.obs.slo): storage owns fleet-wide evaluation —
        # it already aggregates every role's snapshots. Evaluated on a 1s
        # cadence (not per frame); /slo serves the last verdict. None unless
        # Config.slo_spec is set.
        self._slo = None
        self._next_slo = 0.0
        # On-demand profiler captures (/prof?ms=N) for THIS process; the
        # flight-recorder crash hook guarantees stop_trace on fatal exits.
        self._prof = None
        # Rollout-lineage tracing (tpu_rl_torch.obs): the storage edge records the
        # ingest + window-close hops for sampled frames, estimates every
        # remote source's clock offset from telemetry echoes, and auto-
        # merges all roles' dumps into result_dir/fleet_trace.json at
        # shutdown. Everything None when there is no result_dir; untraced
        # frames cost one `is None` check.
        self._tracer = None
        self._trace_path = None
        self.clocksync = None
        # Ingress validation (tpu_rl_torch.heal): finite/range checks over each
        # RolloutBatch's obs/rew columns BEFORE the epoch fence, feeding the
        # membership table's per-wid quarantine strikes. None when off — the
        # ingest path then pays one `is None` check per frame.
        self._ingress = None
        if cfg.ingress_validate:
            from tpu_rl_torch.heal.ingress import IngressGuard

            self._ingress = IngressGuard(abs_max=cfg.ingress_abs_max)

    def run(self) -> None:
        cfg = self.cfg
        layout = BatchLayout.from_config(cfg)
        assembler = RolloutAssembler(layout, lag_sec=cfg.rollout_lag_sec)
        store = make_store(cfg, layout, handles=self.handles)
        # Fan-in edge: a FanInSub (shm rings + the TCP SUB) when
        # Config.transport enables the shm channel, else the plain TCP SUB.
        # Either way the ingest loop below sees the same recv_traced/
        # drain_traced surface and the same n_rejected accounting.
        sub = self._sub = make_data_sub(cfg, "*", self.learner_port, bind=True)
        self._setup_trace(assembler)
        self._setup_telemetry()
        led = self.ledger
        if led is not None:
            from tpu_rl_torch.obs.goodput import COMPUTE, IDLE, WIRE
        try:
            while not self._stopped():
                self._poll_epoch()
                t_recv = time.perf_counter()
                msg = sub.recv_traced(timeout_ms=50)
                t_work = time.perf_counter()
                if led is not None:
                    # The bounded recv is the loop's only wait: wire time
                    # when a frame landed, idle when the fleet was quiet.
                    led.add(WIRE if msg is not None else IDLE, t_work - t_recv)
                if msg is not None:
                    self._ingest(msg[0], msg[1], assembler, msg[2])
                for proto, payload, trailer in sub.drain_traced():
                    self._ingest(proto, payload, assembler, trailer)
                self._flush(assembler, store)
                if led is not None:
                    # Ingest + assembly + window flush: the work this role
                    # exists for — its compute bucket.
                    led.add(COMPUTE, time.perf_counter() - t_work)
                now_m = time.monotonic()
                if now_m >= self._next_evict:
                    self._next_evict = now_m + 1.0
                    self.members.evict_expired(now_m)
                    self.replicas.evict_expired(now_m)
                if self.aggregator is not None:
                    self._telemetry_tick()
                if self.heartbeat is not None:
                    self.heartbeat.value = time.time()
        finally:
            sub.close()
            self._close_trace()
            self._close_telemetry()

    # ----------------------------------------------------------------- trace
    def _setup_trace(self, assembler) -> None:
        cfg = self.cfg
        if cfg.result_dir is None:
            return
        from tpu_rl_torch.obs import ClockSync, TraceRecorder, flightrec

        self._tracer = TraceRecorder(
            capacity=cfg.trace_capacity, pid=os.getpid(), role="storage"
        )
        self._trace_path = os.path.join(
            cfg.result_dir, f"trace-storage-{os.getpid()}.json"
        )
        # Offsets of every remote process against THIS host's clock (learner
        # and storage are shm-colocated, so this is the fleet's reference).
        self.clocksync = ClockSync()
        flightrec.install(
            "storage",
            cfg.result_dir,
            tracer=self._tracer,
            cfg=cfg,
            extra=lambda: {
                "assembler": assembler.stats,
                "windows": self.n_windows,
                "requeue_full": self.n_requeue_full,
            },
        )

    def _tracez(self) -> dict:
        """Live snapshot for the HTTP /tracez endpoint."""
        return {
            "role": "storage",
            "pid": os.getpid(),
            "trace": (
                self._tracer.to_chrome() if self._tracer is not None else None
            ),
            "clock": (
                self.clocksync.snapshot() if self.clocksync is not None else {}
            ),
        }

    def _close_trace(self) -> None:
        if self._tracer is None:
            return
        extra = (
            {"clock": self.clocksync.snapshot()}
            if self.clocksync is not None
            else None
        )
        self._tracer.dump(self._trace_path, extra_meta=extra)
        # Auto-merge at shutdown: storage is the last data-plane process to
        # exit and every role dumps on the telemetry cadence, so what's on
        # disk now is the fleet's final (or near-final) state. Best-effort —
        # the per-role dumps stay either way and the CLI merger can rerun.
        try:
            from tpu_rl_torch.obs.merge import merge_result_dir

            merge_result_dir(self.cfg.result_dir)
        except Exception as e:  # noqa: BLE001 — shutdown must not crash
            print(f"[storage] fleet-trace merge failed: {e!r}", flush=True)

    # ------------------------------------------------------------- telemetry
    def _setup_telemetry(self) -> None:
        """Construct the aggregator + exporters iff the plane has a sink
        (``Config.telemetry_enabled``); otherwise everything stays None and
        the ingest/tick paths reduce to a single ``is None`` check."""
        cfg = self.cfg
        if not cfg.telemetry_enabled:
            return
        from tpu_rl_torch.obs import (
            GoodputLedger,
            JsonExporter,
            MetricsRegistry,
            ProfilerCapture,
            TelemetryAggregator,
            TelemetryHTTPServer,
            TensorboardExporter,
            maybe_history,
            maybe_slo_engine,
        )
        from tpu_rl_torch.utils.metrics import NullWriter, make_writer

        self.aggregator = TelemetryAggregator(
            registry=MetricsRegistry(role="storage"),
            stale_after_s=cfg.telemetry_stale_s,
        )
        self.ledger = GoodputLedger("storage")
        self._wid_frames = {}
        self._slo = maybe_slo_engine(cfg)
        self._history = maybe_history(cfg)
        if cfg.result_dir is not None:
            self._prof = ProfilerCapture(os.path.join(cfg.result_dir, "prof"), "cpu")
        if cfg.telemetry_port > 0:
            self._http = TelemetryHTTPServer(
                self.aggregator,
                cfg.telemetry_port,
                tracez=self._tracez,
                slo=self._slo.report if self._slo is not None else None,
                prof=(
                    self._prof.capture_async if self._prof is not None else None
                ),
                goodput=self._goodput_payload,
                query=(
                    self._history.http_query
                    if self._history is not None else None
                ),
            )
        if cfg.result_dir is not None:
            self._json_exp = JsonExporter(
                self.aggregator,
                os.path.join(cfg.result_dir, "telemetry.json"),
                interval_s=cfg.telemetry_interval_s,
            )
            writer = make_writer(os.path.join(cfg.result_dir, "telemetry"))
            if not isinstance(writer, NullWriter):
                # Fleet health next to the loss curves; rides the JSON
                # exporter's cadence (no writer of its own clock). Skipped
                # when tensorboardX is absent — the JSON file still lands.
                self._tb_exp = TensorboardExporter(writer)

    def _telemetry_tick(self) -> None:
        reg = self.aggregator.registry
        reg.counter("storage-windows").set_total(self.n_windows)
        reg.counter("storage-requeue-full").set_total(self.n_requeue_full)
        reg.counter("storage-rejected-frames").set_total(
            self._sub.n_rejected if self._sub is not None else 0
        )
        reg.counter("storage-telemetry-ingested").set_total(
            self.aggregator.n_ingested
        )
        reg.gauge("storage-game-count").set(self.game_count)
        # Durability plane: the epoch fence and the membership lease table.
        reg.gauge("storage-run-epoch").set(self.run_epoch)
        reg.counter("storage-stale-epoch-frames").set_total(
            self.n_stale_epoch
        )
        reg.gauge("storage-members-active").set(len(self.members.active))
        reg.counter("storage-members-joined").set_total(self.members.n_joined)
        reg.counter("storage-members-evicted").set_total(
            self.members.n_evicted
        )
        # Inference-fleet membership and the version watch: the floor is the
        # ratchet clients pin to, min-active the worst staleness a balanced
        # request can land on now.
        reg.gauge("fleet-replicas-active").set(len(self.replicas.active))
        reg.counter("fleet-replicas-joined").set_total(self.replicas.n_joined)
        reg.counter("fleet-replicas-evicted").set_total(self.replicas.n_evicted)
        reg.gauge("fleet-version-floor").set(self.replicas.floor)
        reg.gauge("fleet-min-active-version").set(self.replicas.min_active_version())
        if self._ingress is not None:
            # Self-healing plane: poisoned (failed validation) and
            # quarantined (clean but from a quarantined wid) frame drops
            # are SEPARATE counters — and separate from n_rejected and
            # n_stale_epoch — so the chaos injected==poisoned parity is
            # assertable exactly.
            reg.counter("storage-poisoned-frames").set_total(
                self._ingress.n_poisoned
            )
            reg.counter("storage-quarantined-frames").set_total(
                self._ingress.n_quarantined_frames
            )
            reg.counter("storage-quarantines").set_total(
                self.members.n_quarantines
            )
            reg.counter("storage-unquarantines").set_total(
                self.members.n_unquarantines
            )
            reg.gauge("storage-wids-quarantined").set(
                len(self.members.quarantined)
            )
        now_m = time.monotonic()
        if now_m >= self._next_slo:
            # 1s cadence for the expensive bits: /proc self-stats and the
            # fleet-wide SLO pass (the tick itself runs every poll loop).
            self._next_slo = now_m + 1.0
            from tpu_rl_torch.obs.perf import process_self_stats

            rss, n_fds = process_self_stats()
            reg.gauge("storage-rss-bytes").set(rss)
            reg.gauge("storage-open-fds").set(float(n_fds))
            if self.ledger is not None:
                self.ledger.publish(reg)
            if self._wid_frames:
                # Straggler gauges BEFORE the SLO pass so rules over
                # worker-straggler-score see this second's values.
                self._straggler_tick(reg, now_m)
            if self._slo is not None:
                self._slo.evaluate(self.aggregator)
        if self._json_exp is not None and self._json_exp.maybe_export():
            if self._history is not None:
                # History rides the SAME cadence decision the JSON exporter
                # just made: one flattened row of every role's snapshot per
                # export, no clock of its own.
                self._history.record(self.aggregator)
            if self.ledger is not None:
                # Ledger + straggler audit trail on the exporter's cadence:
                # one JSON line per export, the offline twin of GET /goodput.
                from tpu_rl_torch.obs.audit import append_jsonl

                append_jsonl(
                    self.cfg.result_dir, "goodput.jsonl",
                    self._goodput_payload(),
                )
            if self._tb_exp is not None:
                self._tb_exp.export(self.aggregator)
            if self._tracer is not None:
                # Ride the JSON exporter's cadence: a recent storage ring
                # (with the clock map the merger needs) is always on disk.
                self._tracer.dump(
                    self._trace_path,
                    extra_meta={"clock": self.clocksync.snapshot()},
                )

    def _straggler_tick(self, reg, now_m: float) -> None:
        """Refresh the per-wid straggler signals and score gauges (1 Hz).

        Three signals, robust z-scored against the fleet median
        (tpu_rl_torch.obs.goodput.straggler_report): admitted-frame rate over the
        last tick window, policy staleness vs the aggregator's version
        ratchet, and the clock-sync rtt EWMA. Report-only — quarantine (the
        heal plane) stays the enforcement arm."""
        from tpu_rl_torch.obs.goodput import STRAGGLER_GAUGE, straggler_report

        rates = {}
        for wid, count in self._wid_frames.items():
            prev = self._frames_prev.get(wid)
            if prev is not None and now_m > prev[1]:
                rates[wid] = (count - prev[0]) / (now_m - prev[1])
            self._frames_prev[wid] = (count, now_m)
        self._wid_rate = rates
        floor = self.aggregator.max_version
        staleness = {
            wid: float(max(0, floor - ver))
            for wid, ver in self._wid_ver.items()
        }
        scores, top = straggler_report(
            frame_rate=rates or None,
            staleness=staleness or None,
            rtt=dict(self._wid_rtt) or None,
        )
        self._straggler_top = top
        for wid, score in scores.items():
            reg.gauge(STRAGGLER_GAUGE, {"wid": str(wid)}).set(score)

    def _goodput_payload(self) -> dict:
        """The GET /goodput document: this loop's own ledger snapshot, every
        source's published goodput/bucket gauges (rebuilt from the
        aggregator, keyed ``role/pid``), and the straggler top-k."""
        roles: dict = {}
        if self.aggregator is not None:
            for snap, _age in self.aggregator.all_snapshots():
                role = str(snap.get("role", "?"))
                ratios: dict = {}
                goodput = overcommit = None
                for name, _labels, value in snap.get("gauges", ()):
                    if name == role + "-goodput-ratio":
                        goodput = value
                    elif name.startswith(role + "-time-") and name.endswith(
                        "-ratio"
                    ):
                        bucket = name[len(role) + 6 : -6]
                        if bucket == "overcommit":
                            overcommit = value
                        else:
                            ratios[bucket] = value
                if goodput is None and not ratios:
                    continue
                roles[f"{role}/{snap.get('pid', '?')}"] = {
                    "goodput": goodput,
                    "ratios": ratios,
                    "overcommit_ratio": overcommit,
                }
        return {
            "storage": (
                self.ledger.snapshot() if self.ledger is not None else None
            ),
            "roles": roles,
            "stragglers": self._straggler_top,
            "rates": {str(w): r for w, r in self._wid_rate.items()},
        }

    def _close_telemetry(self) -> None:
        if self._http is not None:
            self._http.close()
        if self._prof is not None:
            self._prof.close()
        if self._slo is not None:
            # Final pass so the written verdict covers the run's last data.
            self._slo.evaluate(self.aggregator)
            if self.cfg.result_dir is not None:
                import json

                with open(
                    os.path.join(self.cfg.result_dir, "slo.json"), "w"
                ) as f:
                    json.dump(self._slo.report(), f, indent=2)
        if self._json_exp is not None:
            self._json_exp.maybe_export(now=float("inf"))  # final snapshot
        if self._history is not None:
            # One last row so the stored run ends at the final state, then
            # release the active chunk handle.
            self._history.record(self.aggregator)
            self._history.close()
        if self._tb_exp is not None:
            self._tb_exp.export(self.aggregator)
            self._tb_exp.close()

    @property
    def slo_failed(self) -> bool:
        """The ``Config.slo_fail_run`` exit gate: True when the final SLO
        verdict has a hard-failing rule."""
        return self._slo is not None and self._slo.failed

    def _ingest(
        self, proto: Protocol, payload, assembler, trailer: bytes | None = None
    ) -> None:
        if proto == Protocol.Rollout:
            assembler.push(payload)
        elif proto == Protocol.RolloutBatch:
            # Membership lease BEFORE the epoch fence: a stale-epoch frame
            # still proves its worker is alive (it is mid re-attach), and
            # evicting it would mis-fire a join push when it converges.
            self._touch_member(payload)
            # Ingress validation BEFORE the epoch fence: a poisoned frame
            # counts poisoned no matter its epoch, so the chaos plane's
            # injected == poisoned parity holds exactly and never shares a
            # frame with n_stale_epoch (or with transport n_rejected).
            if self._ingress is not None and not self._ingress_admit(payload):
                return  # poisoned or quarantined: dropped + counted
            if not self._epoch_admit(payload):
                return  # pre-crash incarnation's rollout: fenced + counted
            if self.aggregator is not None and isinstance(payload, dict):
                # Policy-staleness echo (tagged on Model broadcasts, echoed
                # by workers): how many updates behind was the policy this
                # tick was acted with?
                ver = payload.get("ver")
                if isinstance(ver, int):
                    self.aggregator.observe_staleness(
                        int(payload.get("wid", -1)), ver
                    )
                if self._wid_frames is not None:
                    wid = payload.get("wid")
                    if isinstance(wid, int):
                        self._wid_frames[wid] = self._wid_frames.get(wid, 0) + 1
                        if isinstance(ver, int):
                            self._wid_ver[wid] = ver
            trace_id = None
            if trailer is not None and self._tracer is not None:
                trace_id = self._note_ingest(trailer)
            # One worker tick, all envs stacked: unpack at the storage edge
            # (the only hop that needs per-step granularity — the assembler
            # keys on episode id).
            if self.cfg.relay_mode == "decode":
                # A/B baseline: per-step dicts through the scalar push path.
                for step in split_rollout_batch(payload):
                    assembler.push(step)
            else:
                # Columnar: the whole tick in one call, row views per env.
                assembler.push_tick(payload, trace_id=trace_id)
        elif proto == Protocol.Stat:
            self._relay_stat(payload)
        elif proto == Protocol.Telemetry:
            # Telemetry is health data: ratchet the fence and renew the
            # lease from its epoch echo, but never reject a snapshot — a
            # stale-epoch worker must stay visible to /healthz while it
            # re-attaches.
            self._touch_member(payload)
            self._touch_replica(payload)
            if isinstance(payload, dict):
                e = payload.get("epoch")
                if isinstance(e, int) and e > self.run_epoch:
                    self.run_epoch = e
            if self.aggregator is not None:
                if self.clocksync is not None and isinstance(payload, dict):
                    self._clock_sample(payload)
                self.aggregator.ingest(payload)

    # ---------------------------------------------------- self-healing plane
    def _ingress_admit(self, payload) -> bool:
        """True to ingest. Classification is the IngressGuard's; the
        quarantine lifecycle (strike -> drop -> clean re-probe) and every
        drop count live here, at one site. A poisoned frame from a
        quarantined wid still counts poisoned (exact chaos parity), and a
        clean frame from a quarantined wid is dropped (quarantined-frames)
        until the cooldown clears it."""
        guard = self._ingress
        if guard.tick_clean(payload):
            wid = payload.get("wid") if isinstance(payload, dict) else None
            if isinstance(wid, int) and self.members.is_quarantined(wid):
                if self.members.probe_clear(wid, self.cfg.quarantine_clear_s):
                    return True
                guard.n_quarantined_frames += 1
                return False
            return True
        guard.n_poisoned += 1
        wid = payload.get("wid") if isinstance(payload, dict) else None
        if isinstance(wid, int):
            self.members.strike(wid, self.cfg.quarantine_strikes)
        return False

    # ----------------------------------------------------- durability plane
    def _poll_epoch(self) -> None:
        """Ratchet the fence from the learner-written mailbox slot (encoded
        epoch + 1; 0 = no learner wrote yet). The mp.Array outlives child
        respawns, so this wins every race against frame echoes."""
        sa = self.stat_array
        if sa is None or len(sa) <= SLOT_RUN_EPOCH:
            return
        e = int(sa[SLOT_RUN_EPOCH]) - 1
        if e > self.run_epoch:
            self.run_epoch = e

    def _epoch_admit(self, payload) -> bool:
        """True to ingest. A frame stamped with a known epoch older than the
        fence is dropped and counted; unknown (< 0 or absent) is admitted —
        fresh fleets and pre-upgrade workers must not stall."""
        if not isinstance(payload, dict):
            return True
        e = payload.get("epoch")
        if not isinstance(e, int) or e < 0:
            return True
        if e > self.run_epoch:
            self.run_epoch = e  # frame echo: secondary ratchet source
            return True
        if e < self.run_epoch:
            self.n_stale_epoch += 1
            return False
        return True

    def _touch_member(self, payload) -> None:
        """Renew the wid's membership lease; on a NEW member, raise the
        mailbox join flag so the learner pushes weights+ver immediately."""
        if not isinstance(payload, dict):
            return
        wid = payload.get("wid")
        if not isinstance(wid, int):
            return
        if self.members.touch(wid):
            sa = self.stat_array
            if sa is not None and len(sa) > SLOT_JOIN_REQ:
                sa[SLOT_JOIN_REQ] = 1.0

    def _touch_replica(self, payload) -> None:
        """Renew an inference replica's lease from its telemetry snapshot
        (``rid`` and served ``ver``). A new replica raises the join flag a
        worker's join does: the learner's join push re-publishes the current
        weights and version, which a random-init replica needs."""
        if not isinstance(payload, dict):
            return
        rid = payload.get("rid")
        if not isinstance(rid, int):
            return
        ver = payload.get("ver")
        if self.replicas.touch(rid, ver=ver if isinstance(ver, int) else -1):
            sa = self.stat_array
            if sa is not None and len(sa) > SLOT_JOIN_REQ:
                sa[SLOT_JOIN_REQ] = 1.0

    def _note_ingest(self, trailer: bytes) -> int | None:
        """Record the storage-ingest hop for a sampled frame; returns its
        trace id for the assembler's window lineage."""
        t0 = time.perf_counter()
        try:
            wid, seq, trace_id, t_send_ns = unpack_trace(trailer)
        except ValueError:
            return None  # decode validated shape/magic; never crash on it
        self._tracer.add(
            "storage-ingest",
            t0,
            time.perf_counter() - t0,
            args={
                "trace_id": trace_id,
                "wid": wid,
                "seq": seq,
                # Raw (uncorrected) transport latency worker->here; the
                # merged timeline shows the clock-corrected truth.
                "wire_ns": time.time_ns() - t_send_ns,
            },
        )
        return trace_id

    def _clock_sample(self, payload: dict) -> None:
        """Fold one Telemetry snapshot's ``clk`` stamps into the clock-sync
        estimator: a full round trip when the source echoes a Model
        broadcast (workers), one-way otherwise (managers)."""
        clk = payload.get("clk")
        if not isinstance(clk, dict):
            return
        t2 = clk.get("t2")
        if not isinstance(t2, int):
            return
        t3 = time.time_ns()
        key = (
            f"{payload.get('role', '?')}/{payload.get('host', '?')}"
            f"/{payload.get('pid', '?')}"
        )
        t0, t1 = clk.get("t0"), clk.get("t1")
        if isinstance(t0, int) and isinstance(t1, int):
            self.clocksync.add_round_trip(key, t0, t1, t2, t3)
            wid = payload.get("wid")
            if isinstance(wid, int):
                # Per-wid transport rtt (minus the remote's hold time) as a
                # straggler signal — EWMA so one slow scrape doesn't flag.
                rtt_s = max(0.0, ((t3 - t0) - (t2 - t1)) / 1e9)
                prev = self._wid_rtt.get(wid)
                self._wid_rtt[wid] = (
                    rtt_s if prev is None else 0.8 * prev + 0.2 * rtt_s
                )
        else:
            self.clocksync.add_one_way(key, t2, t3)

    def _flush(self, assembler: RolloutAssembler, store) -> None:
        windows, traces, vers = assembler.pop_many_full()
        if not windows:
            return
        accepted = store.put_many(windows, vers=vers)
        self.n_windows += accepted
        if accepted < len(windows):
            # On-policy store full: the learner hasn't consumed yet. Requeue
            # the rejected tail in order and yield (reference spins on
            # ``num < mem_size``, ``learner_storage.py:139``).
            assembler.requeue(
                windows[accepted:],
                traces[accepted:] if traces is not None else None,
                vers[accepted:],
            )
            self.n_requeue_full += 1
        if traces is not None:
            t0 = time.perf_counter()
            for tr in traces[:accepted]:
                if not tr:
                    continue
                # A window that contains rows from sampled ticks closes
                # here: the last lineage hop the wire can measure (the shm
                # plane carries no metadata; the merger synthesizes the
                # learner consume from the first train-step after this).
                for tid in tr:
                    self._tracer.add(
                        "window-close",
                        t0,
                        time.perf_counter() - t0,
                        args={"trace_id": tid},
                    )

    def _relay_stat(self, payload) -> None:
        """Manager sends ``{"mean": m, "n": window}``; fold into the stat
        mailbox for the learner's tensorboard tick
        (``learner_storage.py:104-121``)."""
        if self.stat_array is None:
            return
        mean = float(payload["mean"]) if isinstance(payload, dict) else float(payload)
        n = int(payload.get("n", 1)) if isinstance(payload, dict) else 1
        self.game_count += n
        self.stat_array[SLOT_GAME_COUNT] = float(self.game_count)
        self.stat_array[SLOT_MEAN_REW] = mean
        if len(self.stat_array) > SLOT_MODEL_LOADS:
            # Fleet health: manager-relayed totals (worker model-SUB drops +
            # the relay's own) plus THIS sub's corrupt-frame count — every
            # transport hop is covered. Written before the activate flag so
            # the learner never reads a half-updated mailbox.
            own = self._sub.n_rejected if self._sub is not None else 0
            relayed = (
                float(payload.get("rejected", 0.0))
                if isinstance(payload, dict) else 0.0
            )
            self.stat_array[SLOT_REJECTED] = relayed + own
            self.stat_array[SLOT_MODEL_LOADS] = (
                float(payload.get("model_loads", 0.0))
                if isinstance(payload, dict) else 0.0
            )
        if len(self.stat_array) > SLOT_FORWARD_BYTES and isinstance(payload, dict):
            # Relay health: manager drop-oldest evictions and
            # forwarded wire bytes -> learner gauges.
            self.stat_array[SLOT_RELAY_DROPPED] = float(
                payload.get("relay_dropped", 0.0)
            )
            self.stat_array[SLOT_FORWARD_BYTES] = float(
                payload.get("forward_bytes", 0.0)
            )
        self.stat_array[SLOT_ACTIVATE] = 1.0  # activate flag; learner clears it

    def _stopped(self) -> bool:
        return self.stop_event is not None and self.stop_event.is_set()


def storage_main(
    cfg: Config,
    handles: ShmHandles,
    learner_port: int,
    stat_array,
    stop_event,
    heartbeat,
) -> None:
    """mp.Process target (reference ``storage_run``, ``main.py:164-187``)."""
    storage = LearnerStorage(
        cfg, handles, learner_port, stat_array, stop_event, heartbeat
    )
    storage.run()
    if cfg.slo_fail_run and storage.slo_failed:
        print("[storage] SLO verdict failing; exiting nonzero", flush=True)
        raise SystemExit(3)
