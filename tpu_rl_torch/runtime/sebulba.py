"""The Sebulba split of the colocated loop — the port of
``tpu_rl.runtime.sebulba``.

Podracer's Sebulba (arxiv 2104.06272) splits one host's devices into two
groups instead of fusing acting and training into one program: an ACTOR
group runs the act -> env step rollout while the LEARNER group runs the
train step, and the two overlap in wall time. The seam between them is a
bounded queue of batches already on the learner's device:

    actor lane (thread)                    learner lane (the caller's thread)
    -------------------                    ----------------------------------
    rollout on the actor device(s)         train step on the learner device
    copy to the learner device    ──►      BoundedPipe.get (queue-wait)
    BoundedPipe.put (queue-wait)           fresh act params -> actor device(s)

One process, two lane threads. Each lane makes its device current on its
own thread (CUDA's current device is per host thread, and B1/B2 launch on
it) and runs on a ``torch.cuda.Stream`` of its own, so lanes that share a
card do not serialize on its default stream. Each hand-off carries an
event the producer recorded on its stream, which the consumer's stream
waits on (``tpu_rl``'s ``jax.block_until_ready`` and ``jax.device_put``),
and the consumer marks every tensor it takes with ``record_stream``, so
the caching allocator does not hand the memory out again while the
consumer's kernels are still queued.

Queue protocol (:class:`BoundedPipe`): ``Config.sebulba_queue`` slots. A
full queue blocks the actor (backpressure, its ledger's ``queue-wait``); an
empty one blocks the learner (actor-bound, the same bucket on its ledger).
The queue holds batches already copied to the learner's device (the copy is
actor-lane time, ``h2d``), so its depth bounds both the learner's staging
memory and the policy lag: a batch is at most ``depth + 1`` updates stale,
and each one is stamped with the version of the params it was acted with.
Parameter feedback is latest-wins: after each update the learner copies
the acting params for the actor group into a slot the actor reads at its
next rollout; the actor never waits for params.

Random streams are stateless, as ``tpu_rl``'s ``fold_in`` streams: the
actor's generator for its ``produced``-th batch is seeded from ``(seed,
0xAC7, produced, device index)`` and the learner's for update ``it`` from
``(seed, 0x7EA, it)`` (``population.spec.fold_in``), so a resumed run replays the
unbroken run's streams with no generator state in its checkpoint.

Device groups. :func:`split_local_devices` gives the first
``sebulba_split`` cards to the actor group and the rest to the learner
group, and refuses a split that leaves a group empty, naming the count of
cards (one card: always). An actor group of several cards steps
``batch_size / n_act`` envs on each. A learner group of several cards
trains data-parallel, one rank per card as everywhere in the port: this
process is rank 0 of the group (``runner.colocated_role`` spawns the group
as a ``RankGroup``), samples nothing but scatters each batch's rows to the
follower ranks through ``RankChannel`` as the learner service does, and the
followers (:meth:`SebulbaLoop.follow`) train on their rows; the grads'
all-reduce keeps the replicas equal. The split is a single-host affair, as
in ``tpu_rl``.

Test seam, not a feature: ``devices=`` hands :func:`split_local_devices`
and :class:`SebulbaLoop` an explicit device list that may repeat a device
(``["cpu", "cpu"]`` in the tests, ``["cuda:0", "cuda:0"]`` on one card), in
place of ``tpu_rl``'s eight virtual CPU devices. The config path
(``sebulba_split`` through the runner) never passes it.

Durability, telemetry and diagnostics are ``tpu_rl``'s: checkpoints by
``model_save_interval`` and at the end, newest-committed resume with the
run epoch bumped; one goodput ledger per lane thread (``sebulba-actor``,
``sebulba-learner``); the gauges ``sebulba-queue-depth`` and
``sebulba-queue-peak-depth``; learn-diag rows stamped with their real
staleness.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Any

import torch
import torch.distributed as dist

from tpu_rl_torch.config import Config
from tpu_rl_torch.obs.goodput import CKPT, COMPUTE, H2D, QUEUE_WAIT
from tpu_rl_torch.population.spec import fold_in as derive_seed
from tpu_rl_torch.runtime.colocated import ColocatedLoop, SloFailedError, act_params
from tpu_rl_torch.types import BATCH_FIELDS, Batch
from tpu_rl_torch.utils.tree import tree_leaves

# Stream tags of the derived seeds (tpu_rl's fold_in constants where it has
# them); ``derive_seed(seed, tag, index, ...)`` is a stateless stream's seed.
ACT_STREAM, LEARN_STREAM, CARRY_STREAM = 0xAC7, 0x7EA, 0xC0C0


def local_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """This host's devices of ``device``'s kind: every card, or the CPU."""
    from tpu_rl_torch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def split_local_devices(
    n_act: int, devices: list | None = None, device: str | torch.device = "cuda"
) -> tuple[list, list]:
    """Partition this host's devices of ``device``'s kind (or the test
    seam's ``devices``) into (actor, learner) groups: the actor takes the
    first ``n_act``, the learner the rest. Raises, naming the config knob
    and the count, when the split leaves a group empty."""
    if devices is not None:
        local, what = [torch.device(d) for d in devices], "len(devices)"
    else:
        local = local_devices(device)
        what = ("torch.cuda.device_count()" if local[0].type == "cuda"
                else "the CPU's device count")
    if not 0 < n_act < len(local):
        raise ValueError(
            f"sebulba_split={n_act} must partition {what}={len(local)} into two non-empty "
            f"groups (actor devices [0, split), learner devices [split, n))"
        )
    return local[:n_act], local[n_act:]


class BoundedPipe:
    """Bounded hand-off between the two lanes.

    A thin ``queue.Queue`` wrapper that (a) attributes the caller's
    blocking time to its goodput ledger's ``queue-wait`` bucket (the
    backpressure signal) and (b) tracks the depth high-watermark, so tests
    and telemetry can pin "bounded, never past ``depth``". Waits poll in
    ``poll_s`` slices so a stop event always unsticks both lanes."""

    __slots__ = ("_q", "depth", "peak_depth", "_peak_lock")

    def __init__(self, depth: int):
        self._q = queue.Queue(maxsize=int(depth))
        self.depth = int(depth)
        self.peak_depth = 0
        self._peak_lock = threading.Lock()

    def qsize(self) -> int:
        return self._q.qsize()

    def put(self, item, ledger=None, stop=None, poll_s: float = 0.05) -> bool:
        """Enqueue; block while full (backpressure). False = stop was set
        before a slot opened, and the item was NOT enqueued."""
        t0 = time.perf_counter()
        ok = False
        while True:
            try:
                self._q.put(item, timeout=poll_s)
                ok = True
                break
            except queue.Full:
                if stop is not None and stop.is_set():
                    break
        if ledger is not None:
            ledger.add(QUEUE_WAIT, time.perf_counter() - t0)
        if ok:
            with self._peak_lock:
                depth = self._q.qsize()
                if depth > self.peak_depth:
                    self.peak_depth = depth
        return ok

    def get(self, ledger=None, stop=None, poll_s: float = 0.05):
        """Dequeue; block while empty. None = stop was set while empty."""
        t0 = time.perf_counter()
        item = None
        while True:
            try:
                item = self._q.get(timeout=poll_s)
                break
            except queue.Empty:
                if stop is not None and stop.is_set():
                    break
        if ledger is not None:
            ledger.add(QUEUE_WAIT, time.perf_counter() - t0)
        return item


def _lane_stream(dev: torch.device):
    """A stream of the lane's own on a card (None on the CPU)."""
    return torch.cuda.Stream(dev) if dev.type == "cuda" else None


@contextlib.contextmanager
def _on(dev: torch.device, stream):
    """Make ``dev`` current on this thread and ``stream`` its current stream."""
    if stream is None:
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


def _record(stream):
    """An event after the work queued so far on ``stream`` (None on the CPU)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _take(tensors, ev, stream) -> None:
    """The consumer's side of a hand-off: its stream waits for the
    producer's event, and every tensor is marked as used on it."""
    if stream is None:
        return
    if ev is not None:
        stream.wait_event(ev)
    for t in tensors:
        if t.is_cuda:
            t.record_stream(stream)


def _batch_tensors(batch: Batch) -> list[torch.Tensor]:
    return [getattr(batch, f) for f in BATCH_FIELDS]


class SebulbaLoop(ColocatedLoop):
    """The Sebulba split of the colocated plane: the envs, the algorithm's
    build and the checkpoint/resume semantics of :class:`ColocatedLoop`;
    ``cfg.sebulba_split`` cards act, the rest train, and :meth:`run`
    drives the two lanes concurrently through a :class:`BoundedPipe`.

    ``devices`` is the test seam of the module doc (the config path never
    passes it). ``stop_event`` ends both lanes; ``heartbeat`` beats once
    per update. ``record_batches=True`` keeps every batch the learner lane
    consumed (with its update index and generator seed) in
    ``consumed``, so a test can replay the lane's updates."""

    def __init__(
        self,
        cfg: Config,
        seed: int = 0,
        max_updates: int | None = None,
        device: str | torch.device | None = "cuda",
        devices: list | None = None,
        stop_event=None,
        heartbeat=None,
        record_batches: bool = False,
    ):
        if cfg.sebulba_split < 1:
            raise ValueError(f"SebulbaLoop needs sebulba_split >= 1, got {cfg.sebulba_split}")
        self._devices_arg = devices
        self._stop = stop_event
        self._heartbeat = heartbeat
        self.record_batches = record_batches
        self.consumed: list = []
        self.max_staleness = 0
        self.n_updates = 0  # updates this process ran
        super().__init__(cfg, seed=seed, max_updates=max_updates, device=device)

    # ------------------------------------------------------------- topology
    def _build_meshes(self) -> None:
        from tpu_rl_torch.parallel.mesh import make_mesh

        cfg = self.cfg
        acts, learns = split_local_devices(cfg.sebulba_split, self._devices_arg, self.device)
        if cfg.batch_size % len(acts):
            raise ValueError(
                f"batch_size={cfg.batch_size} not divisible by the actor group ({len(acts)} devices)"
            )
        self.act_devices, self.learn_devices = acts, learns
        self.n_local = cfg.batch_size // len(acts)  # envs on each actor device
        self._channel = None
        self.mesh = None
        if len(learns) == 1:
            self.device = learns[0]
            return
        if not dist.is_initialized() or dist.get_world_size() != len(learns):
            raise ValueError(
                f"a learner group of {len(learns)} devices trains on {len(learns)} ranks, one per "
                "device: run the colocated role (runner.colocated_role spawns them) or join a "
                "process group of that size before building the loop"
            )
        rank = dist.get_rank()
        self.device = learns[rank]
        self.mesh = make_mesh(len(learns), device=self.device)
        if cfg.batch_size % len(learns):
            raise ValueError(
                f"batch_size={cfg.batch_size} not divisible by the learner group "
                f"({len(learns)} devices)"
            )

    def _env_spec(self):
        # the actor lane steps the whole batch: no rank slicing of the envs
        return self.spec

    def _act_noise(self, generator: torch.Generator) -> dict:
        return {}  # the act draws its own noise on the actor device

    def _stopping(self) -> bool:
        return self._stop is not None and self._stop.is_set()

    def _learner_channel(self):
        """Rank 0's channel to the learner group's follower ranks."""
        if self.mesh is not None and self._channel is None:
            from tpu_rl_torch.data.layout import BatchLayout
            from tpu_rl_torch.runtime.learner_service import RankChannel

            self._channel = RankChannel(self.mesh, BatchLayout.from_config(self.cfg))
        return self._channel

    def _learn_generator(self, it: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(
            derive_seed(self.seed, LEARN_STREAM, it))

    # ------------------------------------------------------------- telemetry
    def _setup_telemetry(self) -> None:
        self._pipe = None
        self.ledger_actor = None
        super()._setup_telemetry()
        if self.ledger is not None:
            from tpu_rl_torch.obs import GoodputLedger

            # one ledger per lane thread: the inherited main-lane ledger
            # becomes the learner's, and the actor gets its own
            self.ledger = GoodputLedger("sebulba-learner")
            self.ledger_actor = GoodputLedger("sebulba-actor")

    def _ledgers(self) -> list:
        return [led for led in (self.ledger, self.ledger_actor) if led is not None]

    def _goodput_payload(self) -> dict:
        return {
            "colocated": self.ledger.snapshot() if self.ledger is not None else None,
            "roles": {led.role: led.snapshot() for led in self._ledgers()},
            "stragglers": [],
        }

    def _telemetry_tick(self, *args) -> None:
        # queue gauges first: the base tick may export this tick's row
        if self.aggregator is not None and self._pipe is not None:
            reg = self.aggregator.registry
            reg.gauge("sebulba-queue-depth").set(float(self._pipe.qsize()))
            reg.gauge("sebulba-queue-peak-depth").set(float(self._pipe.peak_depth))
            if self.ledger_actor is not None:
                self.ledger_actor.publish(reg)
        super()._telemetry_tick(*args)

    # ------------------------------------------------------------ the lanes
    def _act_params_for(self, state) -> list[dict]:
        """The acting params copied for each actor device (on the caller's
        current stream)."""
        actor = act_params(state)["actor"]
        return [{"actor": {k: v.detach().to(d, copy=True) for k, v in actor.items()}}
                for d in self.act_devices]

    def _actor_loop(self, carries: list, stats: list, needed: int | None) -> None:
        """Actor-lane thread: rollouts on the actor device(s), each batch
        copied to the learner's device and handed over through the pipe."""
        try:
            self._actor_body(carries, stats, needed)
        except Exception as e:  # noqa: BLE001 — re-raised on the learner lane
            self._actor_error = e
            self._lane_stop.set()

    def _actor_body(self, carries: list, stats: list, needed: int | None) -> None:
        from tpu_rl_torch.models.families import build_family

        ledger, pipe = self.ledger_actor, self._pipe
        devs = self.act_devices
        streams = [_lane_stream(d) for d in devs]
        # modules of the lane's own: an act's functional_call swaps its
        # module's parameters, which must not race the learner's unroll
        families = [build_family(self.cfg, device=d) for d in devs]
        for c, st, s in zip(carries, stats, streams):
            # made on another stream before this thread started
            _take(tree_leaves(c) + tree_leaves(st), None, s)
        # the copies onto the learner's device, where the batch is not
        # already there
        same = len(devs) == 1 and devs[0] == self.device
        xfer = None if same else _lane_stream(self.device)
        produced = self._start_it
        seen_ver = None
        while not self._lane_stop.is_set() and (needed is None or produced < needed):
            with self._lane_lock:
                params, pev, pver = self._params_slot
            t0 = time.perf_counter()
            parts = []
            for i, (d, s) in enumerate(zip(devs, streams)):
                with _on(d, s):
                    if pver != seen_ver:
                        _take(params[i]["actor"].values(), pev, s)
                    gen = torch.Generator(d).manual_seed(
                        derive_seed(self.seed, ACT_STREAM, produced, i))
                    carries[i], batch, done, ep_ret = self.rollout(params[i], carries[i], gen,
                                                                   families[i])
                    stats[i] = {"episodes": stats[i]["episodes"] + done.sum(),
                                "ret_sum": stats[i]["ret_sum"] + ep_ret.sum()}
                    parts.append(batch)
            seen_ver = pver
            for s in streams:
                if s is not None:
                    s.synchronize()
            t1 = time.perf_counter()
            if ledger is not None:
                ledger.add(COMPUTE, t1 - t0)
            # onto the learner's device, the split's analogue of a host feed
            # (the rollouts are complete: their streams were synchronized)
            if same:
                lbatch, ev = parts[0], None
            else:
                with _on(self.device, xfer):
                    lbatch = Batch(**{f: torch.cat([getattr(p, f).to(self.device, non_blocking=True)
                                                    for p in parts]) for f in BATCH_FIELDS})
                    ev = _record(xfer)
            if ledger is not None:
                ledger.add(H2D, time.perf_counter() - t1)
            snap = list(stats)
            with self._lane_lock:
                self._stats_slot = snap
            if not pipe.put((lbatch, ev, snap, pver), ledger=ledger, stop=self._lane_stop):
                break
            produced += 1

    def _sum_stats(self, stats: list) -> tuple[int, float]:
        eps = sum(int(s["episodes"]) for s in stats)
        ret = sum(float(s["ret_sum"]) for s in stats)
        return eps, ret

    def _init_lanes(self, state):
        """Fresh carries and stats on each actor device, and the first
        params slot."""
        carries, stats = [], []
        for i, d in enumerate(self.act_devices):
            gen = torch.Generator(d).manual_seed(derive_seed(self.seed, CARRY_STREAM, i))
            carries.append(self.init_carry(gen, device=d))
            stats.append({
                "episodes": torch.zeros((), dtype=torch.int64, device=d),
                "ret_sum": torch.zeros((), dtype=torch.float32, device=d),
            })
        with _on(self.device, self._learn_stream):
            params = self._act_params_for(state)
            ev = _record(self._learn_stream)
        self._params_slot = (params, ev, self._start_it)
        self._stats_slot = list(stats)
        for d in {*self.act_devices, self.device}:
            if d.type == "cuda":  # the state, carries and stats: made on the default stream
                torch.cuda.synchronize(d)
        return carries, stats

    def _restore(self, state):
        """Every rank resumes from the newest committed checkpoint (the
        update index, and the run epoch one above the checkpoint's)."""
        restored = self.ckpt.restore_run(
            state, fingerprint=self._fingerprint, force=self.cfg.resume_force)
        if restored is None:
            return state
        state, self._start_it, meta = restored
        self.run_epoch = int(meta.get("epoch", 0)) + 1
        return state

    def save_meta(self) -> dict:
        # no generator state: every stream derives from the index
        return {"epoch": self.run_epoch, "fingerprint": self._fingerprint}

    def run(self, log: bool = True) -> dict:
        """Drive both lanes to ``max_updates`` (or the stop event). The
        learner lane is this thread; the actor lane is a daemon thread
        joined on every exit path. Returns ``ColocatedLoop.run``'s totals
        plus ``queue_peak_depth`` and ``max_staleness``."""
        from tpu_rl_torch.obs import DiagAccumulator, append_jsonl, learn_record
        from tpu_rl_torch.obs import publish as publish_diag
        from tpu_rl_torch.parallel.dp import replicate
        from tpu_rl_torch.utils.metrics import make_writer
        from tpu_rl_torch.utils.timer import ExecutionTimer

        cfg = self.cfg
        if self.mesh is not None and self.mesh.rank > 0:
            raise RuntimeError("a follower rank of the learner group runs follow(), not run()")
        n, s = cfg.batch_size, cfg.seq_len
        timer = ExecutionTimer(num_transition=n * s)
        writer = make_writer(cfg.result_dir)
        state = self.state
        if self.ckpt is not None:
            state = self._restore(state)
            if self.run_epoch:
                self._record_resume(self._start_it)
                if log:
                    print(f"[sebulba] resumed from committed checkpoint idx {self._start_it} "
                          f"(run epoch {self.run_epoch})", flush=True)
        channel = self._learner_channel()
        if self.mesh is not None:
            replicate(state, self.mesh)  # the followers built or restored the same state
        self._learn_stream = _lane_stream(self.device)
        self._pipe = BoundedPipe(cfg.sebulba_queue)
        self._lane_stop = threading.Event()
        self._lane_lock = threading.Lock()
        self._actor_error = None
        carries, stats = self._init_lanes(state)
        # made on the default stream: freed, they must wait for this lane's use
        _take([t for f in dataclasses.fields(state) for t in tree_leaves(getattr(state, f.name))
               if torch.is_tensor(t)], None, self._learn_stream)
        ledger = self.ledger
        diag_acc = DiagAccumulator() if cfg.learn_diag and cfg.telemetry_enabled else None
        log_every = max(1, cfg.loss_log_interval)
        it = last_it = self._start_it
        last_ep, last_ret = 0, 0.0
        mean_ret, best_ret = 0.0, float("-inf")
        metrics: Any = {}
        learn_stream = self._learn_stream
        actor = threading.Thread(target=self._actor_loop, args=(carries, stats, self.max_updates),
                                 name="sebulba-actor", daemon=True)
        t0 = t_mark = time.perf_counter()
        actor.start()
        try:
            with _on(self.device, learn_stream):
                while not self._stopping() and (self.max_updates is None or it < self.max_updates):
                    item = self._pipe.get(ledger=ledger, stop=self._lane_stop)
                    if item is None:
                        break
                    batch, bev, stats_ref, bver = item
                    _take(_batch_tensors(batch), bev, learn_stream)
                    stale = max(0, it - bver)
                    self.max_staleness = max(self.max_staleness, stale)
                    seed_it = derive_seed(self.seed, LEARN_STREAM, it)
                    gen = self._learn_generator(it)
                    if self.record_batches:
                        self.consumed.append((it, seed_it, bver,
                                              Batch(**{f: t.clone() for f, t in
                                                       zip(BATCH_FIELDS, _batch_tensors(batch))})))
                    t_disp = time.perf_counter()
                    if channel is not None:
                        channel.command(channel.STEP, float(it))
                        batch = channel.scatter(batch)
                    if self._perf is not None:
                        state, metrics = self._perf.call(self.train_step, state, batch, gen)
                    else:
                        state, metrics = self.train_step(state, batch, gen)
                    self.n_updates += 1
                    diag = metrics.pop("diag", None)
                    if diag_acc is not None and diag is not None:
                        n_rows = next(iter(diag["rows"].values())).shape[0] if diag["rows"] else 0
                        diag_acc.add(diag, torch.full((n_rows,), float(stale),
                                                      dtype=torch.float32, device=self.device))
                    done_ev = _record(learn_stream)
                    if done_ev is not None:
                        done_ev.synchronize()
                    t_done = time.perf_counter()
                    if ledger is not None:
                        ledger.add(COMPUTE, t_done - t_disp)
                    # latest-wins params for the actor group: the lag is
                    # bounded by the queue's depth, not by a handshake
                    aparams = self._act_params_for(state)
                    pev = _record(learn_stream)
                    if ledger is not None:
                        ledger.add(H2D, time.perf_counter() - t_done)
                    with self._lane_lock:
                        self._params_slot = (aparams, pev, it + 1)
                    it += 1
                    if self._heartbeat is not None:
                        self._heartbeat.value = time.time()
                    if self.ckpt is not None and it % cfg.model_save_interval == 0:
                        t_ck = time.perf_counter()
                        self.ckpt.save(state, it, meta=self.save_meta())
                        if ledger is not None:
                            ledger.add(CKPT, time.perf_counter() - t_ck)
                        self._last_saved = it
                    if it % log_every and it != self.max_updates:
                        continue
                    episodes, ret_sum = self._sum_stats(stats_ref)
                    host_metrics = {k: float(v) for k, v in metrics.items()}
                    now = time.perf_counter()
                    iters = it - last_it
                    chunk_s = (now - t_mark) / max(1, iters)
                    timer.record("sebulba-iteration", chunk_s, check_throughput=True)
                    ups = iters / max(now - t_mark, 1e-9)
                    tps = ups * n * s
                    if episodes > last_ep:
                        mean_ret = (ret_sum - last_ret) / (episodes - last_ep)
                        best_ret = max(best_ret, mean_ret)
                    self._telemetry_tick(it, it * n * s, episodes, ups, tps, chunk_s, mean_ret)
                    if diag_acc is not None:
                        diag_doc = diag_acc.drain(it)
                        if diag_doc is not None:
                            if self.aggregator is not None:
                                publish_diag(self.aggregator.registry, diag_doc)
                            append_jsonl(cfg.result_dir, "learn.jsonl", learn_record(it, diag_doc))
                    for name, val in host_metrics.items():
                        writer.add_scalar(f"loss/{name}", val, it)
                    writer.add_scalar("colocated/env_steps_per_s", tps, it)
                    writer.add_scalar("colocated/mean_episode_return", mean_ret, it)
                    if log:
                        print(
                            f"[sebulba] update {it}  tps {tps:,.0f}  "
                            f"queue {self._pipe.qsize()}/{self._pipe.depth}  episodes {episodes}  "
                            f"mean_return {mean_ret:.1f}  "
                            + "  ".join(f"{k} {v:.4f}" for k, v in host_metrics.items()),
                            flush=True,
                        )
                    last_it, last_ep, last_ret = it, episodes, ret_sum
                    t_mark = time.perf_counter()
        finally:
            self._lane_stop.set()
            actor.join(timeout=30.0)
            if channel is not None:
                channel.command(channel.STOP)
        if self._actor_error is not None:
            raise RuntimeError("the sebulba actor lane failed") from self._actor_error
        for d in self.act_devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        with self._lane_lock:
            final_stats = self._stats_slot
        episodes, ret_sum = self._sum_stats(final_stats)
        elapsed = time.perf_counter() - t0
        if self.ckpt is not None and it > self._start_it and it != self._last_saved:
            t_ck = time.perf_counter()
            self.ckpt.save(state, it, meta=self.save_meta())
            if ledger is not None:
                ledger.add(CKPT, time.perf_counter() - t_ck)
            self._last_saved = it
        writer.flush()
        writer.close()
        self.close()
        self.state = state
        totals = {
            "updates": it,
            "env_steps": it * n * s,
            "episodes": episodes,
            "mean_return_overall": ret_sum / max(1, episodes),
            "mean_return_recent": mean_ret,
            "mean_return_best_window": best_ret,
            "elapsed_s": elapsed,
            "transitions_per_s": (it - self._start_it) * n * s / max(elapsed, 1e-9),
            "queue_peak_depth": self._pipe.peak_depth,
            "max_staleness": self.max_staleness,
            "scalars": timer.scalars(),
        }
        if cfg.slo_fail_run and self.slo_failed:
            failing = [r["rule"] for r in self._slo.report()["rules"] if r["ok"] is False]
            raise SloFailedError(
                f"the final SLO verdict fails {failing} (slo_fail_run); run totals: {totals}")
        return totals

    def follow(self) -> int:
        """A follower rank of the learner group: rank 0's state, then one
        update on its rows of each batch rank 0 scatters, until it says
        stop. Returns the updates run."""
        from tpu_rl_torch.data.layout import BatchLayout
        from tpu_rl_torch.parallel.dp import replicate
        from tpu_rl_torch.runtime.learner_service import RankChannel

        state = self.state
        if self.ckpt is not None:
            state = self._restore(state)
        replicate(state, self.mesh)
        ch = RankChannel(self.mesh, BatchLayout.from_config(self.cfg))
        rows = self.cfg.batch_size // self.mesh.n_data
        stream = _lane_stream(self.device)
        with _on(self.device, stream):
            while True:
                cmd, vals = ch.receive()
                if cmd == RankChannel.STEP:
                    it = int(vals[0])
                    state, _m = self.train_step(state, ch.receive_batch(rows),
                                                self._learn_generator(it))
                    self.n_updates += 1
                    if self._heartbeat is not None:
                        self._heartbeat.value = time.time()
                elif cmd == RankChannel.STOP:
                    break
                else:
                    raise RuntimeError(f"sebulba learner rank {self.mesh.rank}: unknown command {cmd}")
        self.state = state
        self.close()
        return self.n_updates


def sebulba_main(
    cfg: Config, stop_event, heartbeat, max_updates: int | None = None, seed: int = 0,
) -> None:
    """Supervised child entry of the split (the colocated role routes here
    when ``cfg.sebulba_split > 0``); a follower rank of a learner group of
    several cards runs :meth:`SebulbaLoop.follow`."""
    from tpu_rl_torch.utils.platform import learner_device

    loop = SebulbaLoop(cfg, seed=seed, max_updates=max_updates, device=learner_device(cfg),
                       stop_event=stop_event, heartbeat=heartbeat)
    if loop.mesh is not None and loop.mesh.rank > 0:
        loop.follow()
        return
    out = loop.run()
    print(
        f"[sebulba] done: {out['updates']} updates, {out['env_steps']:,} env steps, "
        f"{out['episodes']} episodes, mean return {out['mean_return_overall']:.1f}, "
        f"{out['transitions_per_s']:,.0f} transitions/s, queue peak {out['queue_peak_depth']}",
        flush=True,
    )
