"""Manager relay process: per-machine fan-in between workers and the learner
storage — the port of ``tpu_rl.runtime.manager`` (both relay modes, and
the chaos plane's ``delay:manager`` shim on its sockets).

Capability parity with the reference manager
(``agents/manager.py:11-90``): SUB-bind on the machine's
worker port, forward Rollout messages to the learner storage, window worker
episode rewards and publish the mean every ``stat_window`` episodes. The
bounded drop-oldest queue (deque maxlen 1024, ``manager.py:45-47``) is kept —
back-pressure on a best-effort fleet means shedding the *oldest* data, since
stale rollouts are the least on-policy.

Zero-copy relay (``Config.relay_mode="raw"``, the default): the manager never
inspects rollout payloads, so it routes on the proto byte alone —
``protocol.peek`` validates the header (magic/version/size caps) without the
CRC pass, LZ4 decompress, or schema unpack, and the received wire parts are
forwarded verbatim via ``Pub.send_raw``. Per-frame relay cost drops from
O(payload) (decode + re-encode) to O(1); the single full CRC+decode runs at
the storage edge, the only consumer. Only the rare, tiny ``Stat`` frames are
decoded here, for the windowed mean. ``relay_mode="decode"`` keeps the old
decode-re-encode hop as the A/B baseline (``bench_relay.cpu.json``).

Sync loop instead of the reference's two asyncio tasks: one poll-drain-forward
pass per iteration keeps ordering within a worker's stream and needs no
coordination.
"""

from __future__ import annotations

import os
import time
from collections import deque

from tpu_rl_torch.config import Config
from tpu_rl_torch.runtime.protocol import Protocol, decode, encode, unpack_trace
from tpu_rl_torch.runtime.transport import Pub, Sub, make_data_pub

RELAY_QUEUE_MAX = 1024  # reference manager.py:45-47
STAT_WINDOW = 50  # reference manager.py:19,62-79


class Manager:
    def __init__(
        self,
        cfg: Config,
        worker_port: int,
        learner_ip: str,
        learner_port: int,
        stop_event=None,
        heartbeat=None,
    ):
        self.cfg = cfg
        self.raw = cfg.relay_mode == "raw"
        self.worker_port = worker_port
        self.learner_addr = (learner_ip, learner_port)
        self.stop_event = stop_event
        self.heartbeat = heartbeat
        # Relay queue holds fully-encoded wire parts (list[bytes]) in BOTH
        # modes: raw mode appends the received parts untouched; decode mode
        # decodes + re-encodes at ingest (the A/B baseline's per-frame
        # codec cost), so the flush path is mode-agnostic byte forwarding.
        self.queue: deque = deque(maxlen=RELAY_QUEUE_MAX)
        self.stat_q: deque = deque(maxlen=STAT_WINDOW)
        self.n_stats = 0
        self.n_forwarded = 0
        # Observability: frames shed by the drop-oldest
        # deque (previously silent data loss) and bytes forwarded to storage
        # — both relayed in the windowed stat publish so they land on the
        # learner's dashboards next to transport-rejected-frames.
        self.n_dropped = 0
        self.n_forward_bytes = 0
        # Stat frames that passed peek but failed the full decode (raw mode
        # decodes only stats; a corrupt stat body is dropped + counted).
        self.n_stat_rejected = 0
        # Per-worker health counters (last-seen cumulative values, keyed by
        # wid) relayed in the windowed stat publish so they reach the
        # learner's dashboards (n_model_loads,
        # n_rejected visibility).
        self.model_loads: dict = {}
        self.worker_rejected: dict = {}
        self._sub: Sub | None = None
        # Rollout-lineage tracing (tpu_rl_torch.obs): spans recorded ONLY for
        # frames that arrive with a trace trailer (the third wire part), so
        # the untraced relay path's trace cost is one length check. None
        # when there is nowhere to dump (no result_dir).
        self._tracer = None
        self._trace_path = None
        # Goodput ledger (tpu_rl_torch.obs.goodput), built in run() iff telemetry
        # has a sink; None keeps the plane-off loop to one check.
        self.ledger = None

    def run(self) -> None:
        # Fault injection (tpu_rl_torch.chaos): delay:manager shims the
        # forward sends to storage. None unless a chaos_spec names this site.
        chaos = None
        if self.cfg.chaos_spec:
            from tpu_rl_torch.chaos import maybe_transport_chaos

            chaos = maybe_transport_chaos(self.cfg, "manager")
        sub = self._sub = Sub("*", self.worker_port, bind=True, chaos=chaos)
        # Storage hop: shm ring when Config.transport selects it for the
        # learner address (same host), else the TCP PUB — same chaos shim,
        # same send_raw surface either way.
        pub = make_data_pub(self.cfg, *self.learner_addr, bind=False, chaos=chaos)
        recv = sub.recv_raw if self.raw else sub.recv_traced

        # Telemetry (tpu_rl_torch.obs): the relay's own health snapshot, emitted
        # on the clock onto the storage-bound PUB. None when the plane has
        # no sink — the loop then pays one `is None` check per iteration.
        registry = emitter = ledger = None
        if self.cfg.telemetry_enabled:
            from tpu_rl_torch.obs import MetricsRegistry, PeriodicSnapshot
            from tpu_rl_torch.obs.goodput import COMPUTE, IDLE, WIRE, GoodputLedger
            from tpu_rl_torch.obs.perf import process_self_stats

            registry = MetricsRegistry(role="manager")
            # Goodput ledger: the pump (drain + forward) is the work this
            # relay exists for — its compute bucket; the bounded idle recv
            # splits into wire (frame landed) vs idle (timeout).
            ledger = self.ledger = GoodputLedger("manager")

            def _send_snap(snap):
                # One-way clock-sync stamp: the storage edge pairs our send
                # time with its receive time (no return path to a relay, so
                # this bounds rather than measures the offset).
                snap["clk"] = {"t2": time.time_ns()}
                pub.send(Protocol.Telemetry, snap)

            emitter = PeriodicSnapshot(
                registry, _send_snap, interval_s=self.cfg.telemetry_interval_s
            )
        if self.cfg.result_dir is not None:
            from tpu_rl_torch.obs import TraceRecorder, flightrec

            self._tracer = TraceRecorder(
                capacity=self.cfg.trace_capacity,
                pid=os.getpid(),
                role="manager",
            )
            self._trace_path = os.path.join(
                self.cfg.result_dir, f"trace-manager-{os.getpid()}.json"
            )
            flightrec.install(
                "manager",
                self.cfg.result_dir,
                tracer=self._tracer,
                cfg=self.cfg,
                extra=lambda: {
                    "queue_depth": len(self.queue),
                    "n_forwarded": self.n_forwarded,
                    "n_dropped": self.n_dropped,
                },
            )
        try:
            while not self._stopped():
                t_pump = time.perf_counter()
                moved = self._pump(sub, pub)
                if ledger is not None:
                    ledger.add(COMPUTE, time.perf_counter() - t_pump)
                if registry is not None:
                    registry.counter("manager-forwarded-frames").set_total(
                        self.n_forwarded
                    )
                    registry.counter("manager-forward-bytes").set_total(
                        self.n_forward_bytes
                    )
                    registry.counter("manager-dropped-frames").set_total(
                        self.n_dropped
                    )
                    registry.counter("manager-stats-seen").set_total(
                        self.n_stats
                    )
                    registry.counter("manager-rejected-frames").set_total(
                        sub.n_rejected + self.n_stat_rejected
                    )
                    registry.gauge("manager-queue-depth").set(len(self.queue))
                    if hasattr(pub, "n_dropped_full"):
                        # Shm-channel shedding (ring full / no consumer
                        # bound yet) — the fabric's analogue of PUB HWM
                        # drops, surfaced on the same dashboards.
                        registry.counter("shm-dropped-full").set_total(
                            pub.n_dropped_full
                        )
                        registry.counter("shm-dropped-no-peer").set_total(
                            pub.n_dropped_no_peer
                        )
                    if chaos is not None:
                        registry.counter("chaos-corrupted-frames").set_total(chaos.n_corrupted)
                        registry.counter("chaos-dropped-frames").set_total(chaos.n_dropped)
                        registry.counter("chaos-delayed-frames").set_total(chaos.n_delayed)
                    if emitter.due():
                        # /proc self-stats refreshed only just before an
                        # emit (syscalls; the gauges only travel then).
                        rss, n_fds = process_self_stats()
                        registry.gauge("manager-rss-bytes").set(rss)
                        registry.gauge("manager-open-fds").set(float(n_fds))
                        ledger.publish(registry)
                    if emitter.maybe_emit() and self._tracer is not None:
                        # Trace dumps ride the telemetry cadence so a recent
                        # ring is always on disk for the merger.
                        self._tracer.dump(self._trace_path)
                if self.heartbeat is not None:
                    self.heartbeat.value = time.time()
                if not moved:
                    # Idle: block briefly on the socket instead of spinning.
                    t_recv = time.perf_counter()
                    msg = recv(timeout_ms=50)
                    if ledger is not None:
                        ledger.add(
                            WIRE if msg is not None else IDLE,
                            time.perf_counter() - t_recv,
                        )
                    if msg is not None:
                        self._ingest(
                            msg[0],
                            msg[1],
                            pub,
                            msg[2] if len(msg) > 2 else None,
                        )
        finally:
            if self._tracer is not None and self._tracer.n_recorded:
                self._tracer.dump(self._trace_path)
            sub.close()
            pub.close()

    # ---------------------------------------------------------------- pump
    def _pump(self, sub: Sub, pub: Pub) -> int:
        moved = 0
        drain = sub.drain_raw if self.raw else sub.drain_traced
        for got in drain():
            self._ingest(
                got[0], got[1], pub, got[2] if len(got) > 2 else None
            )
            moved += 1
        while self.queue:
            parts = self.queue.popleft()
            pub.send_raw(parts)
            self.n_forwarded += 1
            if len(parts) == 3:
                # Sampled frame: the trailer's bytes count too, and the
                # forward hop lands in the lineage timeline.
                self.n_forward_bytes += (
                    len(parts[0]) + len(parts[1]) + len(parts[2])
                )
                if self._tracer is not None:
                    self._note_trace("relay-out", parts[2])
            else:
                self.n_forward_bytes += len(parts[0]) + len(parts[1])
            moved += 1
        return moved

    def _note_trace(self, name: str, trailer: bytes) -> None:
        """One lineage span for a trailer-carrying frame at this hop."""
        t0 = time.perf_counter()
        try:
            wid, seq, trace_id, _ts = unpack_trace(trailer)
        except ValueError:
            return  # peek validated shape/magic; don't crash on a race
        self._tracer.add(
            name,
            t0,
            time.perf_counter() - t0,
            args={"trace_id": trace_id, "wid": wid, "seq": seq},
        )

    def _ingest(
        self, proto: Protocol, item, pub: Pub, trailer: bytes | None = None
    ) -> None:
        """One received message. ``item`` is the opaque wire-parts list in
        raw mode, the decoded payload in decode mode (where ``trailer`` is
        the frame's trace context, re-attached on the re-encode so the A/B
        baseline preserves lineage)."""
        if proto in (Protocol.Rollout, Protocol.RolloutBatch, Protocol.Telemetry):
            # Relay a RolloutBatch as one frame — never unpacked into
            # per-step messages. Drop-oldest granularity is one frame: a
            # whole tick for batched workers, exactly the steps that are
            # most stale together. Telemetry snapshots take the same path:
            # tiny frames, forwarded verbatim in raw mode (the aggregator at
            # the storage edge is their consumer, not this relay).
            parts = item if self.raw else encode(proto, item, trace=trailer)
            if self._tracer is not None and len(parts) == 3:
                self._note_trace("relay-in", parts[2])
            if len(self.queue) == self.queue.maxlen:
                # deque(maxlen) evicts silently; count the shed frame so the
                # loss is visible fleet-wide (satellite: silent drop fix).
                self.n_dropped += 1
            self.queue.append(parts)
        elif proto == Protocol.Stat:
            if self.raw:
                # Stats are the one frame kind the manager consumes: full
                # decode (CRC included) of a tiny payload, a few per episode.
                try:
                    _, item = decode(item)
                except ValueError:
                    self.n_stat_rejected += 1
                    return
            self._ingest_stat(item, pub)

    def _ingest_stat(self, payload, pub: Pub) -> None:
        # Workers send either the reference's bare episode reward or the
        # dict form carrying per-worker health counters.
        if isinstance(payload, dict):
            self.stat_q.append(float(payload.get("rew", 0.0)))
            wid = payload.get("wid", -1)
            self.model_loads[wid] = int(payload.get("n_model_loads", 0))
            self.worker_rejected[wid] = int(payload.get("n_rejected", 0))
        else:
            self.stat_q.append(float(payload))
        self.n_stats += 1
        if self.n_stats % STAT_WINDOW == 0:
            mean = sum(self.stat_q) / len(self.stat_q)
            own_rejected = self._sub.n_rejected if self._sub else 0
            pub.send(
                Protocol.Stat,
                {
                    "mean": mean,
                    "n": len(self.stat_q),
                    # Fleet totals: this relay's own corrupt-frame drops
                    # (peek rejects + stat-decode rejects) plus every
                    # worker's model-SUB drops / reloads.
                    "rejected": own_rejected
                    + self.n_stat_rejected
                    + sum(self.worker_rejected.values()),
                    "model_loads": sum(self.model_loads.values()),
                    # Relay health: drop-oldest evictions and
                    # forwarded wire bytes -> learner gauges.
                    "relay_dropped": self.n_dropped,
                    "forward_bytes": self.n_forward_bytes,
                },
            )

    def _stopped(self) -> bool:
        return self.stop_event is not None and self.stop_event.is_set()


def manager_main(
    cfg: Config,
    worker_port: int,
    learner_ip: str,
    learner_port: int,
    stop_event,
    heartbeat,
) -> None:
    """mp.Process target (reference ``manager_sub_process``,
    ``main.py:228-242``)."""
    Manager(
        cfg, worker_port, learner_ip, learner_port, stop_event, heartbeat
    ).run()
