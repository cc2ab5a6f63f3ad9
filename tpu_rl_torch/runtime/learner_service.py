"""Learner process: the only process of the cluster that owns the card — the
port of ``tpu_rl.runtime.learner_service``.

It samples trajectory batches out of shared memory, runs the algorithm's
update on the card (the LSTM unrolls through kernels B1/B2), broadcasts the
actor's weights to every worker, logs losses, timers and the fleet's reward,
checkpoints every ``model_save_interval`` updates and heartbeats:

- the host data plane is pipelined (``cfg.learner_prefetch``): a feeder
  thread samples shm, assembles the batch and stages it onto the card
  through pinned buffers on a side stream (``data/prefetch.py``), so the
  next update's copy overlaps the current one; ``learner_prefetch=0`` is
  the serial feed;
- ``learner_chain=K`` consumes K batches per dispatch and runs K updates in
  a row (``tpu_rl`` scans them in one program; the port loops);
- the weight broadcast snapshots the actor on the card and starts its copy
  to pinned host memory; a publisher thread waits for the copy, lays the
  tree out as ``tpu_rl``'s flax actor (:func:`~tpu_rl_torch.bridge.state_dict_to_flax`)
  and sends the frame ``tpu_rl``'s learner sends;
- off-policy learners honour ``cfg.max_update_data_ratio``;
- ``stop_at_reward``, ``entropy_anneal``, checkpoint resume (train state,
  update index, run epoch and the generator's state), the divergence
  watchdog with its rollback (``heal/watchdog.py``), the learning-dynamics
  plane and the learner's telemetry snapshots are ``tpu_rl``'s;
- with ``act_mode="remote"`` the process also serves acting: an
  :class:`~tpu_rl_torch.runtime.inference_service.InferenceService` on the
  learner's device behind a :class:`~tpu_rl_torch.runtime.transport.Router`
  on ``inference_port``, its params swapped after every update (kernel B3
  under ``act_kernel="pallas"``); under ``inference_replicas > 1`` that
  service is the fleet's replica 0, an
  :class:`~tpu_rl_torch.fleet.replica.InferenceReplica`.

The learner runs on ``learner_device``: ``"auto"`` is the card, and raises
when there is none (ROADMAP C 7: ``tpu_rl`` degrades to the CPU instead);
``"cpu"`` runs the plain path. Its telemetry snapshot also carries the
kernels' launch counts of this process (``learner-lstm-fwd-launches``,
``learner-lstm-bwd-launches``, ``inference-fused-act-launches`` and the
service's ``inference-warmups``), which only count on the card.

**Data parallelism** (``mesh_data`` ranks on one host, spawned by the
learner role as one supervised group; or ``multihost``). On one host the
port runs ``mesh_data`` ranks where ``tpu_rl`` runs one process, and rank
0 is the learner of record: it alone attaches to storage, samples the
global batch ``tpu_rl``'s single learner would sample, publishes weights,
serves remote acting, checkpoints and exports telemetry. It scatters each
batch's rows to the ranks (one packed buffer per update, ``dist.scatter``;
chosen over attaching every rank to the shared-memory store because the
store's consume and sample move a cursor, so only one reader may draw, and
over a broadcast of the whole batch because a scatter moves each row once)
behind a command word that also carries the entropy anneal, a rollback's
state and the stop. The other ranks (:meth:`LearnerService._follow`) build
the same state, take rank 0's at start (after its resume) and run the same
data-parallel step on their rows. Under ``multihost`` each host feeds its
own rows of the global batch from its own storage, as ``tpu_rl``'s
multihost feed does: a host of one card is one rank training on its
host's batch; on a host of several cards (one rank each) the host's local
rank 0 samples its storage and scatters the rows over a host-local process
group (``dist.new_group`` per host, made in the same order on every rank)
through the same :class:`RankChannel`, and the grads still all-reduce over
the world. World rank 0 checkpoints and decides each watchdog check, and
its rollback reaches every rank: each host's rank 0 tells its followers to
join the verdict's broadcast. The
chained step over the mesh is ``make_parallel_train_step(chain=K)``. The
closing telemetry snapshot carries every rank's kernel launch counts
(``learner-lstm-fwd-launches-rank<r>``, ...), ``mesh-world`` and
``mesh-backend``.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from tpu_rl_torch.bridge import state_dict_to_flax
from tpu_rl_torch.config import Config, is_off_policy
from tpu_rl_torch.data.layout import BatchLayout
from tpu_rl_torch.data.prefetch import (
    DeviceStager,
    PrefetchPipeline,
    SynchronousFeed,
    UpdateRatioGate,
    device_batch,
    wait_ready,
)
from tpu_rl_torch.data.shm_ring import ShmHandles, make_store
from tpu_rl_torch.obs import trace as obs_trace
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
)
from tpu_rl_torch.runtime.manager import STAT_WINDOW
from tpu_rl_torch.runtime.protocol import Protocol
from tpu_rl_torch.runtime.transport import MODEL_HWM, Pub, make_data_pub
from tpu_rl_torch.types import BATCH_FIELDS, Batch, maybe_zero_carry
from tpu_rl_torch.utils.metrics import LearnerLogger, make_writer
from tpu_rl_torch.utils.timer import ExecutionTimer


def _crossed(prev: int, cur: int, interval: int) -> bool:
    """Did the counter cross a multiple of ``interval`` moving prev -> cur?
    With chained dispatch the counter advances K per iteration and plain
    modulo would skip firings whose multiple falls inside the jump."""
    return cur // interval > prev // interval


def actor_of(state) -> dict:
    """The actor's parameters of either state flavour (SACState keeps the
    actor apart; TrainState nests it under "actor")."""
    return state.actor_params if hasattr(state, "actor_params") else state.params["actor"]


class _HostSnapshot:
    """The actor's tensors copied on the card and on their way to pinned
    host memory; :meth:`host` waits for the copy."""

    def __init__(self, actor: dict):
        self._event = None
        cuda = any(t.is_cuda for t in actor.values())
        if not cuda:
            self._host = {k: v.detach().clone() for k, v in actor.items()}
            return
        self._host = {}
        for k, v in actor.items():
            dst = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            dst.copy_(v.detach(), non_blocking=True)
            self._host[k] = dst
        self._event = torch.cuda.Event()
        self._event.record()

    def host(self) -> dict:
        if self._event is not None:
            self._event.synchronize()
        return self._host


class AsyncPublisher:
    """Weight broadcast off the learner's critical path.

    ``publish(actor)`` only enqueues work on the caller's stream: the
    non-blocking copy of the actor to pinned host memory and an event after
    it. The wait for the copy (which waits for the update that produced the
    weights), the flax layout, the codec and the send happen on this
    thread. Latest-wins slot: under backpressure workers want the newest
    weights. ``close()`` flushes a pending snapshot, then joins; a send
    failure re-raises out of the next ``publish()``."""

    def __init__(self, pub: Pub):
        self._pub = pub
        self._cond = threading.Condition()
        self._pending = None
        self._error: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, name="learner-publish", daemon=True)
        self._thread.start()

    def publish(self, actor, ver: int = -1, epoch: int = 0) -> None:
        if self._error is not None:
            raise self._error
        snap = _HostSnapshot(actor)
        with self._cond:
            self._pending = (snap, ver, epoch)  # latest wins
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait(timeout=0.1)
                if self._pending is None:  # closed and flushed
                    return
                (snap, ver, epoch), self._pending = self._pending, None
            try:
                self._pub.send(
                    Protocol.Model,
                    {
                        "actor": state_dict_to_flax(snap.host()),  # tpu_rl's flax layout
                        "ver": ver,
                        "epoch": epoch,
                        # clock-sync echo origin (tpu_rl_torch.obs.clocksync)
                        "t_tx": time.time_ns(),
                    },
                )
            except BaseException as e:  # noqa: BLE001 — surfaces in publish()
                self._error = e
                return

    def close(self, timeout: float = 10.0) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._thread.join(timeout=timeout)


class RankChannel:
    """A leader rank's commands and batches to its follower ranks: world
    rank 0 to the ranks of a one-host data-parallel learner, or under
    ``multihost`` a host's local rank 0 (world rank ``src``) to the ranks
    of its host's ``group``. A command is one broadcast word
    ``[cmd, a, b, c]``; a batch is scattered as one ``(B, F)`` buffer of
    the packed fields, each rank taking its block of rows."""

    STEP, ANNEAL, STATE, STOP, WATCH = 1, 2, 3, 4, 5

    def __init__(self, mesh, layout: BatchLayout, group=None, src: int = 0,
                 size: int | None = None):
        self.mesh = mesh
        self.layout = layout
        self.group, self.src = group, src
        # ranks the channel reaches, and the row blocks a batch splits into
        # (seq minor: the seq ranks of one data shard take the same rows)
        self.size = mesh.world if size is None else size
        self.n_seq = mesh.n_seq if group is None else 1
        self.widths = [layout.seq_len * layout.width(f) for f in BATCH_FIELDS]
        self.bytes_scattered = 0

    def command(self, cmd: int, *vals: float) -> None:
        word = torch.tensor([float(cmd), *vals, *[0.0] * (3 - len(vals))],
                            dtype=torch.float64, device=self.mesh.device)
        self.mesh.broadcast_([word], src=self.src, group=self.group)

    def receive(self) -> tuple[int, list[float]]:
        word = torch.zeros(4, dtype=torch.float64, device=self.mesh.device)
        self.mesh.broadcast_([word], src=self.src, group=self.group)
        vals = word.tolist()
        return int(vals[0]), vals[1:]

    def _scatter(self, full: torch.Tensor | None, rows: int) -> torch.Tensor:
        mesh = self.mesh
        mine = torch.empty((rows, sum(self.widths)), dtype=torch.float32, device=mesh.device)
        dst = mesh.stage(mine)
        parts = None
        if full is not None:
            blocks = full.chunk(self.size // self.n_seq, dim=0)
            parts = [mesh.stage(blocks[r // self.n_seq].contiguous()) for r in range(self.size)]
            self.bytes_scattered += full.numel() * full.element_size() * self.n_seq
        dist.scatter(dst, parts, src=self.src, group=self.group)
        return mesh.unstage(dst, mine) if dst is not mine else mine

    def scatter(self, batch: Batch) -> Batch:
        """The leader: send each rank its rows of ``batch``; returns its own."""
        B = batch.obs.shape[0]
        full = torch.cat([getattr(batch, f).reshape(B, -1) for f in BATCH_FIELDS], dim=1)
        return self._unpack(self._scatter(full, B // (self.size // self.n_seq)))

    def receive_batch(self, rows: int) -> Batch:
        return self._unpack(self._scatter(None, rows))

    def _unpack(self, flat: torch.Tensor) -> Batch:
        out, off = {}, 0
        S = self.layout.seq_len
        for f, w in zip(BATCH_FIELDS, self.widths):
            out[f] = flat[:, off:off + w].reshape(flat.shape[0], S, w // S)
            off += w
        return Batch(**out)


class LearnerService:
    def __init__(
        self,
        cfg: Config,
        handles: ShmHandles,
        model_port: int,
        stat_array=None,
        stop_event=None,
        heartbeat=None,
        max_updates: int | None = None,
        publish_interval: int = 1,
        seed: int = 0,
        inference_port: int | None = None,
        stat_port: int | None = None,
    ):
        self.cfg = cfg
        self.handles = handles
        self.model_port = model_port
        self.stat_array = stat_array
        self.stop_event = stop_event
        self.heartbeat = heartbeat
        self.max_updates = max_updates
        self.publish_interval = publish_interval
        self.seed = seed
        self.inference_port = inference_port
        # Stat-channel port (the one storage binds): the learner's own
        # Telemetry snapshots ship there.
        self.stat_port = stat_port
        self._publisher: AsyncPublisher | None = None
        self._inference = None  # InferenceService when act_mode="remote"
        self._router = None  # its Router
        self._tracer = None  # TraceRecorder when result_dir is set
        self._perf = None  # PerfTracker when telemetry is on
        self._prof_capture = None
        self.n_rebroadcasts = 0
        self.run_epoch = 0
        self.n_join_pushes = 0
        self._ckpt = None
        self.n_nonfinite_updates = 0.0
        self.n_rollbacks = 0
        self._diag_vers = None
        self.device: torch.device | None = None
        self.ledger = None
        self.timer: ExecutionTimer | None = None
        self.mesh = None  # the rank mesh under data parallelism
        self._channel: RankChannel | None = None  # rank 0 -> followers (one host)
        self.n_updates = 0  # updates this process ran
        self._rank_launches = None  # every rank's launch counts at the end
        self._watch_ranks = False  # multihost: rank 0 decides each watchdog check
        self._rows = cfg.batch_size  # rows this rank trains on
        self._following = False  # a follower rank (it never sends commands)

    # ------------------------------------------------------------------ run
    def run(self) -> None:
        from tpu_rl_torch.parallel.mesh import make_mesh
        from tpu_rl_torch.parallel.multihost import host_rank, init_multihost
        from tpu_rl_torch.utils.platform import learner_device

        cfg = self.cfg
        dev = torch.device(learner_device(cfg))
        local_rank, local_ranks = host_rank()
        if cfg.multihost:
            # tpu_rl's learner joins the pod here too (learner_service.run)
            init_multihost(**cfg.multihost, device=dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        if dist.is_initialized():
            world = dist.get_world_size()
            if cfg.mesh_seq > 1:
                # the long-context learner: a (data, seq) mesh
                from tpu_rl_torch.parallel.mesh import make_sp_mesh

                self.mesh = make_sp_mesh(cfg.mesh_data, cfg.mesh_seq, device=dev)
            else:
                n = world if cfg.multihost and world > 1 and cfg.mesh_data == 1 else cfg.mesh_data
                self.mesh = make_mesh(n, device=dev)
            layout = BatchLayout.from_config(cfg)
            if not cfg.multihost and self.mesh.world > 1:
                self._channel = RankChannel(self.mesh, layout)
                self._rows = cfg.batch_size // self.mesh.n_data
                if self.mesh.rank > 0:
                    return self._follow(dev)
            elif cfg.multihost and local_ranks > 1:
                # the host's local rank 0 feeds its host's ranks their rows
                if cfg.batch_size % local_ranks:
                    raise ValueError(
                        f"batch_size={cfg.batch_size} (a host's rows) not divisible by the "
                        f"host's {local_ranks} ranks"
                    )
                group, leader = self._host_group(local_ranks)
                self._channel = RankChannel(self.mesh, layout, group=group, src=leader,
                                            size=local_ranks)
                self._rows = cfg.batch_size // local_ranks
                self._watch_ranks = bool(cfg.watchdog_enabled and cfg.model_dir)
                if local_rank > 0:
                    return self._follow(dev)
        elif cfg.mesh_data * cfg.mesh_seq > 1:
            raise ValueError(
                f"mesh_data={cfg.mesh_data} x mesh_seq={cfg.mesh_seq} needs that many ranks, one "
                "per device: the learner role spawns them (runtime.runner.learner_role)"
            )
        self._run(dev)

    @staticmethod
    def _host_group(local_ranks: int):
        """This host's process group (every host's made in the same order on
        every rank, as ``new_group`` requires) and its leader's world rank:
        hosts hold consecutive world ranks, ``process_id * local_ranks +
        local_rank``."""
        world, rank = dist.get_world_size(), dist.get_rank()
        mine = None
        for h in range(world // local_ranks):
            g = dist.new_group(list(range(h * local_ranks, (h + 1) * local_ranks)))
            if h == rank // local_ranks:
                mine = g
        return mine, rank // local_ranks * local_ranks

    @property
    def chief(self) -> bool:
        """World rank 0: the rank that checkpoints and logs."""
        return self.mesh is None or self.mesh.rank == 0

    def _build(self, dev: torch.device):
        """(spec, family, state, step, generator) of this rank: the step is
        the data-parallel one under a mesh (over a (data, seq) mesh the
        transformer splits its window over the seq group, as
        ``make_sp_train_step`` does)."""
        from tpu_rl_torch.algos.registry import get_algo

        cfg = self.cfg
        spec = get_algo(cfg.algo)
        family, state, step = spec.build(
            cfg, torch.Generator().manual_seed(self.seed), device=dev, mesh=self.mesh
        )
        # the update's own draws (SAC's sampling) come from the device
        gen = torch.Generator(dev).manual_seed(self.seed + 1)
        return spec, family, state, self._wrap(step), gen

    def _wrap(self, step):
        """``step`` as this rank calls it: wrapped for the mesh, if any."""
        from tpu_rl_torch.parallel.dp import make_parallel_train_step

        if self.mesh is None:
            return step
        return make_parallel_train_step(step, self.mesh, self.cfg, chain=self._chain())

    def _chain(self) -> int:
        chain = max(1, self.cfg.learner_chain)
        if self.max_updates is not None and chain > self.max_updates:
            chain = max(1, self.max_updates)
        return chain

    def _rebuild_step(self, spec, family):
        """The train step of the current cfg (after the entropy anneal)."""
        from tpu_rl_torch.parallel.mesh import NO_SYNC

        return self._wrap(spec.make_train_step(self.cfg, family, sync=self.mesh or NO_SYNC))

    def _sync_start(self, state, gen, start_idx: int) -> int:
        """Every rank takes world rank 0's state, generator and start index
        (rank 0 alone restored); returns the start index."""
        from tpu_rl_torch.parallel.dp import replicate

        mesh = self.mesh
        if mesh is None or mesh.world == 1:
            return start_idx
        replicate(state, mesh, check=False)
        g = gen.get_state().to(mesh.device)
        word = torch.tensor([float(start_idx), float(self.run_epoch)], dtype=torch.float64,
                            device=mesh.device)
        mesh.broadcast_([g, word])
        gen.set_state(g.cpu())
        self.run_epoch = int(word[1])
        return int(word[0])

    def _follow(self, dev: torch.device) -> None:
        """A follower rank of a one-host data-parallel learner: rank 0's
        state, then one update per batch it scatters, until it says stop."""
        from tpu_rl_torch.parallel.dp import replicate

        cfg = self.cfg
        self._following = True
        spec, family, state, train_step, gen = self._build(dev)
        replicate(state, self.mesh)  # as rank 0: the seed-built init agrees
        self._sync_start(state, gen, 0)
        rows = self._rows
        chain = self._chain()
        ch = self._channel
        while True:
            cmd, vals = ch.receive()
            if cmd == RankChannel.STEP:
                batches = [ch.receive_batch(rows) for _ in range(int(vals[0]))]
                if chain > 1:
                    state, _m = train_step(state, batches, gen)
                else:
                    for b in batches:
                        state, _m = train_step(state, b, gen)
                self.n_updates += len(batches)
                if self.heartbeat is not None:
                    self.heartbeat.value = time.time()
            elif cmd == RankChannel.ANNEAL:
                self.cfg = cfg = cfg.replace(entropy_coef=vals[0], lr=vals[1])
                train_step = self._rebuild_step(spec, family)
            elif cmd == RankChannel.STATE:
                replicate(state, self.mesh, check=False)
                self._sync_start(state, gen, 0)
            elif cmd == RankChannel.WATCH:
                # world rank 0's watchdog verdict; a rollback's state follows it
                if self._watch_word() == self.WATCH_ROLLBACK:
                    replicate(state, self.mesh, check=False)
                    self._sync_start(state, gen, 0)
                    self.n_rollbacks += 1
            elif cmd == RankChannel.STOP:
                self._gather_launches()
                self.state = state
                return
            else:
                raise RuntimeError(f"learner rank {self.mesh.rank}: unknown command {cmd}")

    def _gather_launches(self) -> list[list[float]] | None:
        """Every rank's (B1 launches, B2 launches, updates), gathered to
        every rank in rank order; None without a mesh."""
        from tpu_rl_torch.ops import lstm as L

        if self.mesh is None or self.mesh.world == 1:
            return None
        table = torch.zeros((self.mesh.world, 3), dtype=torch.float64, device=self.mesh.device)
        table[self.mesh.rank] = torch.tensor(
            [float(L.LSTM_FWD_LAUNCHES), float(L.LSTM_BWD_LAUNCHES), float(self.n_updates)],
            dtype=torch.float64)
        return self.mesh.all_reduce_(table).tolist()  # every rank's row

    def _run(self, dev: torch.device) -> None:
        from tpu_rl_torch.checkpoint import Checkpointer, resume_fingerprint

        cfg = self.cfg
        layout = BatchLayout.from_config(cfg)
        store = make_store(cfg, layout, handles=self.handles)
        rng = np.random.default_rng(self.seed)
        spec, family, state, train_step, gen = self._build(dev)
        if self.mesh is not None:
            from tpu_rl_torch.parallel.dp import replicate

            replicate(state, self.mesh)  # the seed-built init agrees on every rank

        # ---- checkpoint resume (newest COMMITTED index wins; world rank 0) ----
        ckpt = None
        start_idx = 0
        fingerprint = resume_fingerprint(cfg)
        if cfg.model_dir and self.chief:
            ckpt = self._ckpt = Checkpointer(
                cfg.model_dir, cfg.algo, keep=cfg.ckpt_keep, async_save=cfg.ckpt_async
            )
            restored = ckpt.restore_run(state, fingerprint=fingerprint, force=cfg.resume_force)
            if restored is not None:
                state, start_idx, meta = restored
                self.run_epoch = int(meta.get("epoch", 0)) + 1
                self._restore_generator(gen, meta)
                print(
                    f"[learner] resumed from checkpoint idx {start_idx} "
                    f"(run epoch {self.run_epoch})"
                )
                self._record_resume(start_idx)
        start_idx = self._sync_start(state, gen, start_idx)
        # The epoch reaches the cross-respawn mailbox BEFORE the first
        # broadcast, so storage fences stale frames deterministically.
        sa = self.stat_array
        if sa is not None and len(sa) > SLOT_RUN_EPOCH:
            sa[SLOT_RUN_EPOCH] = float(self.run_epoch + 1)  # 0 = unknown

        chain = self._chain()
        if chain < cfg.learner_chain:
            print(
                f"[learner] learner_chain {cfg.learner_chain} exceeds max_updates "
                f"{self.max_updates}; clamping chain to {chain}", flush=True,
            )

        anneal = cfg.entropy_anneal
        anneal_at = None
        anneal_absolute = False
        if anneal is not None:
            if "at" in anneal:
                anneal_at = max(1, int(anneal["at"]))
                anneal_absolute = True
            elif self.max_updates is not None:
                anneal_at = max(1, int(float(anneal["frac"]) * self.max_updates))
            else:
                print(
                    "[learner] entropy_anneal uses 'frac' but the run has no "
                    "max_updates budget; anneal disabled", flush=True,
                )

        # Fault injection (tpu_rl_torch.chaos): delay:learner shims the model
        # broadcast sends. None unless a chaos_spec names this site.
        chaos = None
        if cfg.chaos_spec:
            from tpu_rl_torch.chaos import maybe_transport_chaos

            chaos = maybe_transport_chaos(cfg, "learner")
        pub = Pub("*", self.model_port, bind=True, hwm=MODEL_HWM, chaos=chaos)
        self._publisher = AsyncPublisher(pub) if cfg.learner_prefetch > 0 else None
        writer = make_writer(cfg.result_dir)
        logger = LearnerLogger(writer, cfg.algo)
        telem_reg = telem_pub = None
        telem_last = float("-inf")
        ledger = self.ledger = None
        if cfg.telemetry_enabled and self.stat_port is not None:
            from tpu_rl_torch.obs import MetricsRegistry
            from tpu_rl_torch.obs.goodput import (
                CKPT,
                COMPUTE,
                H2D,
                IDLE,
                QUEUE_WAIT,
                RECOMPILE,
                ROLLBACK,
                WIRE,
                GoodputLedger,
            )
            from tpu_rl_torch.obs.perf import PerfTracker

            telem_reg = MetricsRegistry(role="learner")
            ledger = self.ledger = GoodputLedger("learner")
            wait_bucket = QUEUE_WAIT if cfg.learner_prefetch > 0 else H2D
            self._perf = PerfTracker(dev, world=self.mesh.world if self.mesh else 1)
            # loopback by construction (storage shares the host), so
            # transport="shm"/"auto" routes it through the shm channel
            telem_pub = make_data_pub(cfg, "127.0.0.1", self.stat_port, bind=False)
        if cfg.result_dir is not None:
            from tpu_rl_torch.obs import TraceRecorder, flightrec

            self._tracer = TraceRecorder(
                capacity=cfg.trace_capacity, pid=os.getpid(), role="learner"
            )
            flightrec.install("learner", cfg.result_dir, tracer=self._tracer, cfg=cfg)
        tracer = self._tracer
        prof_capture = self._prof_capture = None
        if cfg.profile_dir is not None or cfg.result_dir is not None:
            from tpu_rl_torch.obs.perf import ProfilerCapture

            prof_capture = self._prof_capture = ProfilerCapture(
                cfg.profile_dir or os.path.join(cfg.result_dir, "prof"), dev
            )
        timer = self.timer = ExecutionTimer(num_transition=cfg.seq_len * cfg.batch_size * chain)

        def _ckpt_meta() -> dict:
            return {
                "epoch": self.run_epoch,
                "generator": gen.get_state().tolist(),
                "fingerprint": fingerprint,
            }

        # SEED-style centralized inference (act_mode="remote"): batched
        # acting on the learner's device, params swapped in-process after
        # every update. Requests that land while the buckets warm up wait
        # in the Router's queue.
        if cfg.act_mode == "remote" and self.inference_port is not None:
            from tpu_rl_torch.runtime.transport import Router

            if cfg.inference_replicas > 1:
                # Fleet: the learner's service is replica 0, continuous
                # batching and the version-keyed swap (the learner's versions
                # only rise, so every in-process swap applies).
                from tpu_rl_torch.fleet import InferenceReplica as InferenceService
            else:
                from tpu_rl_torch.runtime.inference_service import InferenceService

            self._router = Router("*", self.inference_port, bind=True)
            self._inference = InferenceService(
                cfg, family, {"actor": actor_of(state)}, self._router,
                timer=timer, seed=self.seed, version=start_idx, device=dev,
            ).start()
            self._inference.wait_ready()
            self._check_inference()

        self._publish(pub, state, ver=start_idx)
        self._consume_join_flag()
        last_pub_m = time.monotonic()

        if self.max_updates is not None and chain > 1 and self.max_updates % chain:
            print(
                f"[learner] max_updates {self.max_updates} is not a multiple "
                f"of learner_chain {chain}; budget rounds DOWN to "
                f"{self.max_updates // chain * chain} updates", flush=True,
            )
        track_nf = cfg.update_guard
        nf_acc = 0.0
        nf_base = 0.0
        watchdog = budget = None
        # Under multihost world rank 0, which holds the checkpoints, decides
        # every watchdog check and broadcasts its word; the other ranks act
        # on it (_watch_word).
        self._watch_ranks = bool(cfg.watchdog_enabled and cfg.model_dir and cfg.multihost
                                 and self.mesh is not None and self.mesh.world > 1)
        if cfg.watchdog_enabled and ckpt is not None:
            from tpu_rl_torch.heal.watchdog import DivergenceWatchdog, RollbackBudget

            watchdog = DivergenceWatchdog(
                window=cfg.watchdog_window,
                z_max=cfg.watchdog_z,
                sustain=cfg.watchdog_sustain,
                nonfinite_max=cfg.watchdog_nonfinite,
            )
            budget = RollbackBudget(max_rollbacks=cfg.max_rollbacks, window_s=cfg.rollback_window_s)
        diag_acc = None
        if cfg.learn_diag:
            from collections import deque as _deque

            from tpu_rl_torch.obs.learn import (
                DiagAccumulator,
                host_stale_rows,
                learn_record,
            )
            from tpu_rl_torch.obs.learn import publish as publish_diag

            diag_acc = DiagAccumulator()
            self._diag_vers = _deque()
        stager = DeviceStager(dev, slots=chain * (cfg.learner_prefetch + 1) + 1) if dev.type == "cuda" else None
        feed = self._make_feed(store, rng, chain, dev, stager)
        idx = start_idx
        profiling = profiled = False
        metrics: dict = {}
        # With a profiler window or a result dir, the train step's phase spans
        # (obs.trace) land on the profile's timeline and in the flight ring.
        spans_before = (obs_trace.set_spans(True, tracer) if prof_capture is not None
                        else None)
        try:
            while not self._stopped():
                if self.max_updates is not None and idx - start_idx + chain > self.max_updates:
                    break
                t_wait = time.perf_counter()
                item = feed.get(timeout=0.05)
                if item is None:
                    if self.heartbeat is not None:
                        self.heartbeat.value = time.time()
                    self._check_inference()
                    # Idle rebroadcast: a SUB that connected after a send
                    # never saw it, so a joiner would act on a stale policy.
                    if self._maybe_join_push(pub, state, ver=idx):
                        last_pub_m = time.monotonic()
                    elif cfg.rebroadcast_idle_s > 0:
                        now_m = time.monotonic()
                        if now_m - last_pub_m >= cfg.rebroadcast_idle_s:
                            self._publish(pub, state, ver=idx)
                            last_pub_m = time.monotonic()
                            self.n_rebroadcasts += 1
                    self._note_ckpt(timer)
                    if telem_reg is not None:
                        now_m = time.monotonic()
                        if now_m - telem_last >= cfg.telemetry_interval_s:
                            telem_last = now_m
                            self._emit_telemetry(telem_reg, telem_pub, timer, idx)
                    if feed.poll_sleep:
                        time.sleep(feed.poll_sleep)
                    if ledger is not None:
                        ledger.add(IDLE, time.perf_counter() - t_wait)
                    continue
                wait_secs = time.perf_counter() - t_wait
                batches, feed_secs = item
                vers = self._diag_vers.popleft() if self._diag_vers else None
                rc0 = self._perf.recompiles if self._perf is not None else 0
                t_step = time.perf_counter()
                with obs_trace.span("learner-dispatch"):
                    batches = [wait_ready(b) for b in batches]
                    if self._channel is not None:
                        # one host: every rank takes its rows of the global batch
                        self._channel.command(RankChannel.STEP, len(batches))
                        batches = [self._channel.scatter(b) for b in batches]
                    # the mesh's chained step takes the K batches at once
                    calls = [batches] if self.mesh is not None and chain > 1 else batches
                    for batch in calls:
                        if self._perf is not None:
                            state, metrics = self._perf.call(train_step, state, batch, gen)
                        else:
                            state, metrics = train_step(state, batch, gen)
                        if track_nf and "nonfinite-updates" in metrics:
                            nf_acc = nf_acc + metrics["nonfinite-updates"]
                        diag = metrics.pop("diag", None)
                        if diag_acc is not None and diag is not None:
                            n_rows = next(iter(diag["rows"].values())).shape[0] if diag["rows"] else 0
                            stale = host_stale_rows(idx, vers, n_rows) if chain == 1 else np.zeros(n_rows, np.float32)
                            diag_acc.add(diag, torch.from_numpy(stale).to(dev))
                    self.n_updates += len(batches)
                step_secs = time.perf_counter() - t_step
                if self._perf is not None:
                    self._perf.note(wait_secs + step_secs)
                if tracer is not None:
                    tracer.add("queue-wait", t_wait, wait_secs)
                    tracer.add("train-step", t_step, step_secs)
                if self._inference is not None:
                    self._check_inference()
                    self._inference.set_params({"actor": actor_of(state)}, version=idx + chain)
                timer.record("learner-batching-time", feed_secs)
                timer.record("learner-queue-wait-time", wait_secs)
                timer.record("learner-step-time", step_secs)
                if ledger is not None:
                    ledger.add(wait_bucket, wait_secs)
                    recompiled = self._perf is not None and self._perf.recompiles > rc0
                    ledger.add(RECOMPILE if recompiled else COMPUTE, step_secs)
                timer.record_gauge("learner-queue-depth", feed.qsize())
                timer.record("learner-throughput", wait_secs + step_secs, check_throughput=True)
                prev_idx, idx = idx, idx + chain

                progress = idx if anneal_absolute else idx - start_idx
                if anneal_at is not None and progress >= anneal_at:
                    cfg = cfg.replace(
                        entropy_coef=float(anneal["coef"]),
                        lr=float(anneal.get("lr", cfg.lr)),
                    )
                    self.cfg = cfg
                    train_step = self._rebuild_step(spec, family)
                    if self._channel is not None:
                        self._channel.command(RankChannel.ANNEAL, cfg.entropy_coef, cfg.lr)
                    anneal_at = None  # fire once
                    print(
                        f"[learner] update {idx}: entropy_coef -> "
                        f"{cfg.entropy_coef}, lr -> {cfg.lr}", flush=True,
                    )

                if cfg.profile_dir is not None and not profiled:
                    # one window of profile_steps updates, relative to this
                    # run (tpu_rl's loop opens a new window after each
                    # close; the port captures the one its Config describes)
                    rel = idx - start_idx
                    if not profiling and rel >= cfg.profile_start:
                        profiling = prof_capture.start() is not None
                    elif profiling and rel >= cfg.profile_start + cfg.profile_steps:
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
                        profiled = prof_capture.stop() is not None
                        profiling = False
                t_pub = time.perf_counter()
                if _crossed(prev_idx, idx, self.publish_interval):
                    self._publish(pub, state, ver=idx)
                    self._consume_join_flag()  # this broadcast serves joiners
                    last_pub_m = time.monotonic()
                elif self._maybe_join_push(pub, state, ver=idx):
                    last_pub_m = time.monotonic()
                if ledger is not None:
                    ledger.add(WIRE, time.perf_counter() - t_pub)
                if telem_reg is not None:
                    now_m = time.monotonic()
                    if now_m - telem_last >= cfg.telemetry_interval_s:
                        telem_last = now_m
                        self._emit_telemetry(telem_reg, telem_pub, timer, idx)
                if _crossed(prev_idx, idx, cfg.loss_log_interval):
                    host_metrics = {k: float(v) for k, v in metrics.items()}
                    logger.log_losses(idx, host_metrics)
                    logger.log_timers(idx, timer)
                    self._log_fleet_stat(logger)
                    logger.flush()
                    if tracer is not None:
                        tracer.dump(os.path.join(cfg.result_dir, "trace.json"))
                    if track_nf:
                        self.n_nonfinite_updates = float(nf_acc)
                    diag_doc = diag_acc.drain(idx) if diag_acc is not None else None
                    if diag_doc is not None:
                        if telem_reg is not None:
                            publish_diag(telem_reg, diag_doc)
                        if cfg.result_dir is not None:
                            from tpu_rl_torch.obs.audit import append_jsonl

                            append_jsonl(cfg.result_dir, "learn.jsonl", learn_record(idx, diag_doc))
                    if watchdog is not None:
                        sa_h = self.stat_array
                        signals = {
                            "loss": host_metrics["loss"],
                            "grad-norm": host_metrics.get("grad-norm", 0.0),
                        }
                        if cfg.watchdog_diag and diag_doc is not None:
                            g = diag_doc["global"]
                            if "approx-kl" in g:
                                signals["diag-approx-kl"] = float(g["approx-kl"])
                            if "ess" in g:
                                signals["diag-neg-ess"] = -float(g["ess"])
                        if sa_h is not None and len(sa_h) > SLOT_MEAN_REW and sa_h[SLOT_GAME_COUNT] > 0:
                            signals["mean-return"] = float(sa_h[SLOT_MEAN_REW])
                        tripped = watchdog.observe(signals)
                        if watchdog.note_nonfinite(self.n_nonfinite_updates - nf_base):
                            tripped = True
                        if tripped:
                            if budget.exhausted():
                                print(
                                    f"[learner] rollback budget exhausted "
                                    f"({budget.used}/{cfg.max_rollbacks} in "
                                    f"{cfg.rollback_window_s:.0f}s): "
                                    f"{watchdog.last_reason}; stopping "
                                    f"cleanly", flush=True,
                                )
                                self._watch_word(self.WATCH_STOP)
                                break
                            t_rb = time.perf_counter()
                            rolled = self._rollback(ckpt, state, pub, fingerprint, gen, watchdog.last_reason)
                            if ledger is not None:
                                ledger.add(ROLLBACK, time.perf_counter() - t_rb)
                            if rolled is not None:
                                state, idx = rolled
                                last_pub_m = time.monotonic()
                                watchdog.reset()
                                nf_base = self.n_nonfinite_updates
                                budget.record()
                                continue
                        else:
                            self._watch_word(self.WATCH_GO)
                    elif self._watch_ranks:
                        word = self._watch_word()
                        if word == self.WATCH_STOP:
                            break
                        if word == self.WATCH_ROLLBACK:
                            state, idx = self._follow_rollback(state, gen, pub)
                            last_pub_m = time.monotonic()
                            continue
                if ckpt is not None and _crossed(prev_idx, idx, cfg.model_save_interval):
                    t_ck = time.perf_counter()
                    ckpt.save(state, idx, meta=_ckpt_meta())
                    if ledger is not None:
                        ledger.add(CKPT, time.perf_counter() - t_ck)
                self._note_ckpt(timer)
                if self.heartbeat is not None:
                    self.heartbeat.value = time.time()
                sa = self.stat_array
                if (
                    cfg.stop_at_reward is not None
                    and sa is not None
                    and sa[SLOT_GAME_COUNT] >= STAT_WINDOW
                    and sa[SLOT_MEAN_REW] >= cfg.stop_at_reward
                ):
                    logger.log_stat(int(sa[SLOT_GAME_COUNT]), float(sa[SLOT_MEAN_REW]))
                    logger.flush()
                    print(
                        f"[learner] fleet 50-game mean {sa[SLOT_MEAN_REW]:.1f} >= "
                        f"stop_at_reward {cfg.stop_at_reward}: solved, "
                        f"stopping at update {idx}", flush=True,
                    )
                    break
        finally:
            if spans_before is not None:
                obs_trace.set_spans(*spans_before)
            if self._channel is not None:
                self._channel.command(RankChannel.STOP)
            # every rank's launch counts, for the closing snapshot
            self._rank_launches = self._gather_launches()
            # Service and feeder first (they touch the card and the store),
            # then the publisher (flushing the final snapshot), then sockets.
            if self._inference is not None:
                self._inference.close()
            if self._router is not None:
                self._router.close()
            feed.close()
            if self._publisher is not None:
                self._publisher.close()
            if prof_capture is not None:
                prof_capture.close()
            if ckpt is not None:
                if idx > start_idx:
                    ckpt.save(state, idx, meta=_ckpt_meta())
                ckpt.close()
                self._note_ckpt(timer)
            if telem_reg is not None:
                self._emit_telemetry(telem_reg, telem_pub, timer, idx, closing=True)
                telem_pub.close()
            if tracer is not None and tracer.n_recorded:
                tracer.dump(os.path.join(cfg.result_dir, "trace.json"))
            pub.close()
            writer.close()

    @staticmethod
    def _restore_generator(gen: torch.Generator, meta: dict) -> None:
        saved = torch.tensor(meta.get("generator", []), dtype=torch.uint8)
        if saved.numel() == gen.get_state().numel():
            gen.set_state(saved)
        else:
            print(
                "[learner] checkpointed generator state unreadable; keeping "
                "the seed-derived stream", flush=True,
            )

    def _check_inference(self) -> None:
        """A dead serve thread fails the learner instead of leaving workers
        to time out into local acting."""
        svc = self._inference
        if svc is not None and svc.error is not None:
            raise RuntimeError("inference service failed") from svc.error

    # ------------------------------------------------------------- batching
    def _next_batch(self, store, rng) -> dict | None:
        if is_off_policy(self.cfg.algo):
            return store.sample(self.cfg.batch_size, rng)
        return store.consume()

    def _make_fetch(self, store, rng):
        """Raw-batch producer for the feed, with the off-policy update:data
        ratio gate folded in (counted at fetch time, so prefetch cannot
        overdraw the budget)."""
        gate = None
        if is_off_policy(self.cfg.algo) and self.cfg.max_update_data_ratio is not None:
            gate = UpdateRatioGate(self.cfg.max_update_data_ratio)
        self._feed_gate = gate

        def fetch():
            if gate is not None and not gate.ready(store.transitions_received()):
                return None
            raw = self._next_batch(store, rng)
            if raw is not None and gate is not None:
                gate.note_fetched()
            return raw

        return fetch

    def _make_feed(self, store, rng, chain: int, dev: torch.device, stager):
        """Prefetch pipeline (feeder thread) or the synchronous feed; both
        yield the same batches in the same order."""
        fetch = self._make_fetch(store, rng)

        def assemble(raws: list) -> list:
            return self._assemble_device(raws, dev, stager)

        if self.cfg.learner_prefetch > 0:
            return PrefetchPipeline(
                fetch, assemble, chain=chain, depth=self.cfg.learner_prefetch,
                stop_event=self.stop_event,
            )
        return SynchronousFeed(fetch, assemble, chain=chain)

    def _assemble_device(self, raws: list, dev, stager) -> list:
        """One dispatch's batches on the learner's device (one per chained
        update), the host-to-device copies started on the stager's side
        stream."""
        tracer = self._tracer
        t0 = time.perf_counter()
        self._pop_vers(raws)
        out = [device_batch([maybe_zero_carry(self.cfg, r)], dev, stager) for r in raws]
        if tracer is not None:
            tracer.add("h2d", t0, time.perf_counter() - t0, tid="feeder")
        return out

    def _pop_vers(self, raws: list) -> None:
        """Detach each raw batch's ``"ver"`` staleness sidecar and queue the
        dispatch's per-row versions for the diag fold."""
        vs = [r.pop("ver", None) if isinstance(r, dict) else None for r in raws]
        if self._diag_vers is None:
            return
        if any(v is None for v in vs):
            self._diag_vers.append(None)
        else:
            self._diag_vers.append(np.concatenate([np.asarray(v).reshape(-1) for v in vs]))

    def _to_batch(self, raw: dict):
        """The train batch of one raw store sample, on the CPU (the feed's
        placement without the stager)."""
        return device_batch([maybe_zero_carry(self.cfg, raw)], "cpu")

    # ------------------------------------------------------------ broadcast
    def _publish(self, pub: Pub, state, ver: int = -1) -> None:
        """Ship the actor (SAC broadcasts the actor only), tagged with the
        update index that produced it. With the async publisher the caller
        only starts the copy to the host."""
        t0 = time.perf_counter()
        actor = actor_of(state)
        if self._publisher is not None:
            self._publisher.publish(actor, ver, epoch=self.run_epoch)
        else:
            pub.send(
                Protocol.Model,
                {
                    "actor": state_dict_to_flax(_HostSnapshot(actor).host()),
                    "ver": ver,
                    "epoch": self.run_epoch,
                    "t_tx": time.time_ns(),
                },
            )
        if self._tracer is not None:
            self._tracer.add("broadcast", t0, time.perf_counter() - t0)

    def _consume_join_flag(self) -> bool:
        """Clear a pending join request: any broadcast serves the joiner."""
        sa = self.stat_array
        if sa is None or len(sa) <= SLOT_JOIN_REQ or sa[SLOT_JOIN_REQ] < 1.0:
            return False
        sa[SLOT_JOIN_REQ] = 0.0
        self.n_join_pushes += 1
        return True

    def _maybe_join_push(self, pub: Pub, state, ver: int) -> bool:
        """Storage raised the join flag: push weights and ver now."""
        if not self._consume_join_flag():
            return False
        self._publish(pub, state, ver=ver)
        return True

    def _note_ckpt(self, timer: ExecutionTimer) -> None:
        ckpt = self._ckpt
        if ckpt is None:
            return
        for dur in ckpt.drain_save_secs():
            timer.record("learner-ckpt-time", dur)
        timer.record_gauge("learner-ckpt-pending", float(ckpt.pending))

    def _rollback(self, ckpt, state, pub, fingerprint, gen, reason: str):
        """Watchdog-triggered restore of the PREVIOUS committed checkpoint;
        bumps the run epoch (storage fences pre-rollback frames),
        rebroadcasts and audits. Returns (state, idx) or None."""
        ckpt.flush()
        restored = ckpt.restore_nth_latest(
            state, n=2, fingerprint=fingerprint, force=self.cfg.resume_force
        )
        if restored is None:
            print(
                f"[learner] watchdog tripped ({reason}) but no committed "
                "checkpoint exists to roll back to; continuing", flush=True,
            )
            self._watch_word(self.WATCH_GO)
            return None
        state, r_idx, meta = restored
        ckpt.discard_above(r_idx)
        if meta.get("generator") is not None:
            self._restore_generator(gen, meta)
        self.run_epoch += 1
        if self._channel is not None or self._watch_ranks:
            # the other ranks take the restored state and generator
            from tpu_rl_torch.parallel.dp import replicate

            if self._channel is not None and not self._watch_ranks:
                self._channel.command(RankChannel.STATE)
            self._watch_word(self.WATCH_ROLLBACK)
            replicate(state, self.mesh, check=False)
            self._sync_start(state, gen, r_idx)
        sa = self.stat_array
        if sa is not None and len(sa) > SLOT_RUN_EPOCH:
            sa[SLOT_RUN_EPOCH] = float(self.run_epoch + 1)
        self._publish(pub, state, ver=r_idx)
        self.n_rollbacks += 1
        from tpu_rl_torch.obs.audit import append_jsonl

        append_jsonl(
            self.cfg.result_dir,
            "learner_rollback.jsonl",
            {"idx": r_idx, "epoch": self.run_epoch, "reason": reason,
             "nonfinite": self.n_nonfinite_updates},
        )
        print(
            f"[learner] rollback #{self.n_rollbacks}: {reason}; restored "
            f"committed idx {r_idx}, run epoch -> {self.run_epoch}",
            flush=True,
        )
        return state, r_idx

    WATCH_GO, WATCH_ROLLBACK, WATCH_STOP = 0, 1, 2

    def _watch_word(self, word: int | None = None) -> int | None:
        """World rank 0's verdict on one watchdog check under multihost
        (``word`` on rank 0, received elsewhere); a no-op returning
        ``word`` otherwise."""
        if not self._watch_ranks:
            return word
        if self._channel is not None and self._channel.group is not None and not self._following:
            # this host's follower ranks join the verdict's broadcast
            self._channel.command(RankChannel.WATCH)
        t = torch.tensor([float(word or 0)], dtype=torch.float64, device=self.mesh.device)
        self.mesh.broadcast_([t])
        return int(t.item())

    def _follow_rollback(self, state, gen, pub):
        """A multihost rank's side of world rank 0's rollback: its restored
        state, generator, update index and run epoch, then this host's
        broadcast to its workers. Returns (state, idx)."""
        from tpu_rl_torch.parallel.dp import replicate

        replicate(state, self.mesh, check=False)
        r_idx = self._sync_start(state, gen, 0)
        sa = self.stat_array
        if sa is not None and len(sa) > SLOT_RUN_EPOCH:
            sa[SLOT_RUN_EPOCH] = float(self.run_epoch + 1)
        self._publish(pub, state, ver=r_idx)
        self.n_rollbacks += 1
        print(f"[learner] rank {self.mesh.rank}: rank 0's rollback #{self.n_rollbacks} to idx "
              f"{r_idx}, run epoch -> {self.run_epoch}", flush=True)
        return state, r_idx

    def _record_resume(self, idx: int) -> None:
        from tpu_rl_torch.obs.audit import append_resume

        append_resume(self.cfg.result_dir, idx, self.run_epoch)

    def _emit_telemetry(
        self, reg, pub, timer: ExecutionTimer, idx: int, closing: bool = False
    ) -> None:
        """Refresh the learner registry and ship one snapshot;
        "learner-update-index" is the policy version the aggregator's
        staleness math ratchets on. The run's last snapshot, sent after the
        service and the feed have stopped, carries ``"closing": True``."""
        from tpu_rl_torch.obs import LEARNER_VERSION_GAUGE
        from tpu_rl_torch.ops import fused_act as FA
        from tpu_rl_torch.ops import lstm as L

        reg.gauge(LEARNER_VERSION_GAUGE).set(idx)
        if self.ledger is not None:
            self.ledger.publish(reg)
        for name, val in timer.scalars().items():
            reg.gauge(name).set(val)
        reg.counter("learner-rebroadcasts").set_total(self.n_rebroadcasts)
        reg.gauge("learner-run-epoch").set(self.run_epoch)
        reg.counter("learner-join-pushes").set_total(self.n_join_pushes)
        if self.cfg.update_guard:
            reg.counter("learner-nonfinite-updates").set_total(self.n_nonfinite_updates)
        reg.counter("learner-rollbacks").set_total(self.n_rollbacks)
        # this process's kernel launches (counted only on the card)
        reg.counter("learner-lstm-fwd-launches").set_total(L.LSTM_FWD_LAUNCHES)
        reg.counter("learner-lstm-bwd-launches").set_total(L.LSTM_BWD_LAUNCHES)
        reg.counter("learner-updates-run").set_total(self.n_updates)
        if self.mesh is not None:
            from tpu_rl_torch.parallel.mesh import publish_mesh

            publish_mesh(reg, self.mesh)
            if self._channel is not None:
                reg.counter("learner-scattered-bytes").set_total(self._channel.bytes_scattered)
            # every rank's counts, folded in at the end of the run
            for r, (fwd, bwd, ups) in enumerate(getattr(self, "_rank_launches", None) or []):
                reg.counter(f"learner-lstm-fwd-launches-rank{r}").set_total(fwd)
                reg.counter(f"learner-lstm-bwd-launches-rank{r}").set_total(bwd)
                reg.counter(f"learner-updates-run-rank{r}").set_total(ups)
        perf = self._perf
        if perf is not None:
            from tpu_rl_torch.obs.perf import device_memory_bytes, process_self_stats

            reg.gauge("learner-flops-per-step").set(perf.flops_per_call)
            achieved = perf.achieved_flops_per_s()
            if achieved is not None:
                reg.gauge("learner-achieved-flops").set(achieved)
            mfu = perf.mfu()
            if mfu is not None:
                reg.gauge("learner-mfu").set(mfu)
            reg.counter("learner-xla-recompiles").set_total(perf.recompiles)
            mem_used, mem_peak = device_memory_bytes(self.device)
            reg.gauge("learner-device-mem-bytes").set(mem_used)
            reg.gauge("learner-device-mem-peak-bytes").set(mem_peak)
            rss, n_fds = process_self_stats()
            reg.gauge("learner-rss-bytes").set(rss)
            reg.gauge("learner-open-fds").set(n_fds)
        sa = self.stat_array
        if sa is not None and len(sa) > SLOT_MODEL_LOADS:
            reg.counter("transport-rejected-frames").set_total(float(sa[SLOT_REJECTED]))
        if self._ckpt is not None:
            reg.gauge("learner-ckpt-pending").set(float(self._ckpt.pending))
            reg.counter("learner-ckpt-saves").set_total(self._ckpt.n_saves)
        svc = self._inference
        if svc is not None:
            reg.counter("inference-requests").set_total(svc.n_requests)
            reg.counter("inference-replies").set_total(svc.n_replies)
            reg.counter("inference-batches").set_total(svc.n_batches)
            reg.counter("inference-warmups").set_total(len(svc.buckets))
            if svc.chaos is not None:
                reg.counter("inference-chaos-stalls").set_total(svc.chaos.n_stalled)
                reg.counter("inference-chaos-refusals").set_total(svc.chaos.n_refused)
            reg.counter("inference-fused-act-launches").set_total(FA.LAUNCHES)
            if self._router is not None:
                reg.counter("inference-rejected-frames").set_total(self._router.n_rejected)
            if svc.ledger is not None:
                svc.ledger.publish(reg)
            svc.publish_serving_metrics(reg)
        snap = reg.snapshot()
        snap["epoch"] = self.run_epoch
        if closing:
            snap["closing"] = True
        pub.send(Protocol.Telemetry, snap)

    def _log_fleet_stat(self, logger: LearnerLogger) -> None:
        """Consume the stat mailbox if storage activated it."""
        sa = self.stat_array
        if sa is not None and sa[SLOT_ACTIVATE] >= 1.0:
            logger.log_stat(int(sa[SLOT_GAME_COUNT]), float(sa[SLOT_MEAN_REW]))
            if len(sa) > SLOT_MODEL_LOADS:
                self.timer.record_gauge("transport-rejected-frames", float(sa[SLOT_REJECTED]))
                self.timer.record_gauge("worker-model-loads", float(sa[SLOT_MODEL_LOADS]))
            if len(sa) > SLOT_FORWARD_BYTES:
                self.timer.record_gauge("relay-dropped-frames", float(sa[SLOT_RELAY_DROPPED]))
                self.timer.record_gauge("manager-forward-bytes", float(sa[SLOT_FORWARD_BYTES]))
            sa[SLOT_ACTIVATE] = 0.0

    def _stopped(self) -> bool:
        return self.stop_event is not None and self.stop_event.is_set()


def learner_main(
    cfg: Config,
    handles: ShmHandles,
    model_port: int,
    stat_array,
    stop_event,
    heartbeat,
    max_updates=None,
    publish_interval: int = 1,
    seed: int = 0,
    inference_port: int | None = None,
    stat_port: int | None = None,
) -> None:
    """mp.Process target (reference ``run_learner``)."""
    LearnerService(
        cfg,
        handles,
        model_port,
        stat_array,
        stop_event,
        heartbeat,
        max_updates,
        publish_interval,
        seed,
        inference_port=inference_port,
        stat_port=stat_port,
    ).run()
