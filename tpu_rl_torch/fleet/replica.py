"""Inference fleet replica — the port of ``tpu_rl.fleet.replica``: continuous
batching, sharded acting and version-keyed weight swaps.

:class:`InferenceReplica` specializes
:class:`~tpu_rl_torch.runtime.inference_service.InferenceService` on three
axes the single service fixes:

- **continuous batching**: the base service waits for ``inference_batch``
  rows or the ``inference_flush_us`` deadline before a flush. Under
  open-loop load that wait is queueing delay, so the replica admits
  whatever has arrived and dispatches it at once through the smallest
  covering bucket: requests that land during a flush form the next one.
  The base's staging, carry table and ``_flush``/``_run`` are reused;
  only the loop differs;
- **sharded acting** (``Config.inference_mesh_data = n > 1``): every bucket
  is rounded up to a multiple of n; the params are copied onto each of the
  n devices (``cuda:0 .. n-1``; on the CPU the same n-way split runs on the
  one CPU device); each flush's rows are gathered from the carry table on
  device 0 as in the base service, device k's contiguous 1/n of them is
  copied to it peer to peer, the act step (kernel B3 under
  ``act_kernel="pallas"``) runs there on that device's current stream, and
  the outputs come back to device 0 in row order, where the post-step
  carry is scattered into the table. The table stays whole on device 0;
- **version-keyed swaps**: ``set_params`` applies only strictly newer
  weights, so a re-delivered or reordered broadcast is a no-op (counted in
  ``n_stale_sets``) and never a rollback. With the client's version floor
  (``FleetClient``) no client observes weights older than ones it saw.

:func:`replica_main` is the standalone process of replicas 1..N-1 (replica
0 lives in the learner): it subscribes to the model broadcast the workers
use, applies frames through the version-keyed swap, and with telemetry on
emits snapshots stamped with its ``rid`` and served ``ver``, which storage's
:class:`~tpu_rl_torch.fleet.membership.ReplicaTable` leases on.
"""

from __future__ import annotations

import time
from bisect import bisect_left
from collections import deque
from contextlib import nullcontext

import torch

from tpu_rl_torch import resolve_device
from tpu_rl_torch.config import Config
from tpu_rl_torch.models.families import to_device_params
from tpu_rl_torch.obs.goodput import COMPUTE, IDLE, QUEUE_WAIT, WIRE
from tpu_rl_torch.ops import fused_act as FA
from tpu_rl_torch.runtime.inference_service import InferenceService


def shard_devices(n: int, device: str | torch.device | None = "cuda") -> list[torch.device]:
    """The devices of a replica spanning ``n``: ``cuda:0 .. n-1`` on the
    card (raising when fewer are visible), ``n`` times the CPU on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    if n == 1:
        return [dev]
    visible = torch.cuda.device_count()
    if n > visible:
        raise ValueError(
            f"inference_mesh_data={n}: requested {n} devices, only {visible} visible"
        )
    return [torch.device("cuda", k) for k in range(n)]


class InferenceReplica(InferenceService):
    """One fleet member. The base service's constructor and thread
    contract (``start()``, ``wait_ready()``, ``close()``)."""

    def __init__(
        self,
        cfg: Config,
        family,
        params,
        router,
        timer=None,
        seed: int = 0,
        version: int = -1,
        device: str | torch.device | None = "cuda",
    ):
        self.shards = shard_devices(int(cfg.inference_mesh_data), device)
        self.n_stale_sets = 0  # swaps refused: version not newer than served
        self.n_flush_continuous = 0  # dispatches below the padded capacity
        # (B3 launches, flushes, replies) as the serve thread leaves each
        # flush: counts a reader sees at a flush boundary.
        self.boundary: tuple = (0, 0, 0)
        # One generator a further shard (shard 0 draws from the serve
        # thread's), seeded apart from it.
        self._shard_gens = [
            torch.Generator(d).manual_seed(seed * 7919 + 17 + k)
            for k, d in enumerate(self.shards[1:], 1)
        ]
        super().__init__(cfg, family, params, router, timer=timer, seed=seed,
                         version=version, device=self.shards[0])

    # ------------------------------------------------------ version rollout
    def set_params(self, params, version: int = -1) -> None:
        """Apply only strictly newer weights. The version is checked before
        quantizing (a frame already known stale costs no device work) and
        again under the lock (a newer frame may have landed meanwhile)."""
        with self._lock:
            if version <= self._version:
                self.n_stale_sets += 1
                return
        new = self._prepare(params)
        with self._lock:
            if version <= self._version:
                self.n_stale_sets += 1
                return
            self._install(new, version)

    # -------------------------------------------------------------- sharding
    def _quantize(self, params):
        """One served copy a shard: ``{"0": tree on device 0, ...}`` when
        sharded, the base's tree otherwise."""
        q = super()._quantize(params)
        if len(self.shards) == 1:
            return q
        return {str(k): q if k == 0 else to_device_params(q, d) for k, d in enumerate(self.shards)}

    def _prepare(self, params):
        new = super()._prepare(params)
        for d in self.shards[1:]:
            if d.type == "cuda":
                torch.cuda.current_stream(d).synchronize()
        return new

    def _bucket_ladder(self) -> list[int]:
        """The base ladder, each bucket rounded up to a multiple of the
        shard count and deduplicated, so every shard takes an equal share."""
        n = len(self.shards)
        return sorted({-(-b // n) * n for b in super()._bucket_ladder()})

    def _step(self, act, params, obs, h, c, first, generator):
        """The base step, once a shard on its contiguous share of the rows
        (each on its device and that device's current stream), the outputs
        gathered back onto device 0 in row order."""
        n = len(self.shards)
        if n == 1:
            return super()._step(act, params, obs, h, c, first, generator)
        share = obs.shape[0] // n
        outs = []
        for k, dev in enumerate(self.shards):
            rows = slice(k * share, (k + 1) * share)
            with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
                args = [t[rows].to(dev, non_blocking=True) for t in (obs, h, c, first)]
                gen = generator if k == 0 else self._shard_gens[k - 1]
                outs.append(super()._step(act, params[str(k)], *args, gen))
        return tuple(
            torch.cat([o[i].to(self.device, non_blocking=True) for o in outs])
            for i in range(len(outs[0]))
        )

    def _mark_boundary(self) -> None:
        """Publish this process's B3 launch counts beside the flush counts
        (one reference assignment; only the serve thread launches B3 here)."""
        self.boundary = (FA.LAUNCHES, self.n_batches, self.n_replies)

    # --------------------------------------------------- continuous batching
    def _loop(self, act, staging, generator) -> None:
        """Admit and dispatch: no row gate, no deadline. Whatever is pending
        when the previous flush is done forms the next chunk (whole clients,
        at most the largest bucket's rows) and dispatches through the
        smallest covering bucket. A request wider than the largest bucket
        never gets here: ``_ingest`` drops and counts it. A dispatch at the
        padded capacity counts as ``n_flush_full``, any other as
        ``n_flush_continuous``; ``n_flush_deadline`` stays 0."""
        router = self.router
        buckets = self.buckets
        pad_rows = buckets[-1]
        pending: deque = deque()  # a backlog past saturation pops from the front
        ledger = self.ledger
        self._mark_boundary()  # after the warm-ups
        while not self._stop.is_set():
            # Block only when idle; with work queued, just sweep the socket.
            t_recv = time.perf_counter()
            got = router.recv(timeout_ms=0 if pending else 20)
            if ledger is not None:
                bucket = QUEUE_WAIT if pending else (WIRE if got is not None else IDLE)
                ledger.add(bucket, time.perf_counter() - t_recv)
            if got is not None:
                for parts in (got, *router.drain()):
                    req = self._ingest(*parts)
                    if req is not None:
                        pending.append(req)
            if not pending:
                continue
            chunk, rows = [], 0
            while pending and rows + pending[0].obs.shape[0] <= pad_rows:
                req = pending.popleft()
                chunk.append(req)
                rows += req.obs.shape[0]
            if rows >= pad_rows:
                self.n_flush_full += 1
            else:
                self.n_flush_continuous += 1
            t_fl = time.perf_counter()
            self._flush(act, staging[buckets[bisect_left(buckets, rows)]], chunk, rows, generator)
            self._mark_boundary()
            if ledger is not None:
                ledger.add(COMPUTE, time.perf_counter() - t_fl)


def replica_main(
    cfg: Config,
    replica_id: int,
    port: int,
    learner_ip: str,
    model_port: int,
    stat_port: int,
    stop_event,
    heartbeat,
    seed: int = 0,
) -> None:
    """Process target of a standalone replica (supervisor children named
    ``inference-<i>``). Boots on random-init params (a torch generator
    seeded ``seed * 6151 + replica_id``) at version -1, on the card unless
    ``cfg.learner_device`` is ``"cpu"`` (no card raises: no replica quietly
    serves from the CPU). Its first telemetry snapshot (``rid``) joins
    storage's ReplicaTable, whose join flag makes the learner push the
    current weights and version over the broadcast this process
    subscribes to."""
    from tpu_rl_torch.bridge import flax_to_state_dict
    from tpu_rl_torch.models.families import build_family
    from tpu_rl_torch.runtime.protocol import Protocol
    from tpu_rl_torch.runtime.transport import MODEL_HWM, Router, Sub, make_data_pub

    device = "cpu" if cfg.learner_device == "cpu" else "cuda"
    family = build_family(cfg, device=device)
    params = {"actor": family.init_params(
        torch.Generator().manual_seed(seed * 6151 + replica_id))["actor"]}
    router = Router("*", port, bind=True)
    svc = InferenceReplica(cfg, family, params, router, seed=seed + replica_id, version=-1,
                           device=device).start()
    sub = Sub(learner_ip, model_port, bind=False, hwm=MODEL_HWM)
    registry = emitter = pub = None
    if cfg.telemetry_enabled:
        from tpu_rl_torch.obs import MetricsRegistry, PeriodicSnapshot

        registry = MetricsRegistry(role="inference", labels={"rid": str(replica_id)})
        pub = make_data_pub(cfg, learner_ip, stat_port, bind=False)

        def _send_snap(snap, _rid=replica_id):
            # Top-level rid and ver: the ReplicaTable's lease key and the
            # version its floor rises from.
            snap["rid"] = _rid
            snap["ver"] = svc.version
            pub.send(Protocol.Telemetry, snap)

        emitter = PeriodicSnapshot(registry, _send_snap, interval_s=cfg.telemetry_interval_s)
    try:
        if not svc.wait_ready(300.0) or svc.error is not None:
            raise RuntimeError(f"replica {replica_id} never became ready") from svc.error
        while not (stop_event is not None and stop_event.is_set()):
            if svc.error is not None:
                raise svc.error
            for proto, payload in sub.drain(max_msgs=MODEL_HWM):
                if proto == Protocol.Model:
                    svc.set_params({"actor": flax_to_state_dict(payload["actor"])},
                                   version=int(payload.get("ver", -1)))
            if registry is not None:
                _publish_replica(registry, svc)
                emitter.maybe_emit()
            if heartbeat is not None:
                heartbeat.value = time.time()
            time.sleep(0.05)
    finally:
        svc.close()
        sub.close()
        router.close()
        if pub is not None:
            pub.close()


def _publish_replica(registry, svc: InferenceReplica) -> None:
    """The replica's counters into its registry: tpu_rl's, and B3's launches
    beside the warm-ups and flushes they must equal, as the serve thread
    left its last flush. The loop's other counts (stale sets, continuous
    and full flushes, rejected payloads) stay attributes, as in tpu_rl."""
    launches, flushes, replies = svc.boundary
    registry.counter("inference-fused-act-launches").set_total(launches)
    registry.counter("inference-batches").set_total(flushes)
    registry.counter("inference-replies").set_total(replies)
    registry.counter("inference-requests").set_total(svc.n_requests)
    registry.counter("inference-warmups").set_total(len(svc.buckets))
    registry.counter("inference-flush-deadline").set_total(svc.n_flush_deadline)
    registry.gauge("fleet-replica-version").set(svc.version)
    svc.publish_serving_metrics(registry)
    if svc.ledger is not None:
        svc.ledger.publish(registry)
