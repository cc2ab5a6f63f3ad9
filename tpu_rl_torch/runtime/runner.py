"""Process orchestration: spawn, supervise and tear down the role processes
— the port of ``tpu_rl.runtime.runner``.

Role dispatch, spawn-start-method children, a stop event, per-child
heartbeats and a supervisor that terminates and respawns any child whose
heartbeat goes silent, within a sliding-window restart budget with backoff.
Learner children resume from their newest checkpoint on respawn
(``checkpoint.py``), so supervision composes with resume.

Roles:

- ``learner``: LearnerStorage + LearnerService sharing a shm store and the
  stat mailbox;
- ``manager``: one relay;
- ``worker``: ``num_p`` actor processes;
- ``local``: everything on one host, the smallest real cluster;
- ``colocated``: the single colocated-loop child (``runtime/colocated.py``),
  or with ``sebulba_split`` the split's (``runtime/sebulba.py``);
- ``population``: the PBT controller (``population/controller.py``), which
  runs in the calling process and supervises the K members itself.

With ``act_mode="remote"`` and ``inference_replicas`` N > 1 the learner
role also spawns the inference fleet's replicas 1..N-1 (``inference-<i>``,
:func:`~tpu_rl_torch.fleet.replica.replica_main`).

Workers, managers and storage are host processes: the supervisor starts
them with ``CUDA_VISIBLE_DEVICES=""`` in their environment and
``role_entry`` hides the card again before the role runs
(``utils.platform.host_role``), so only the learner and the inference
replicas open a CUDA context.
The autopilot role comes with the serving and operations slice of the port
(ROADMAP A 9).
"""

from __future__ import annotations

import contextlib
import functools
import multiprocessing as mp
import os
import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from tpu_rl_torch.config import Config, MachinesConfig
from tpu_rl_torch.data.layout import BatchLayout
from tpu_rl_torch.data.shm_ring import alloc_handles
from tpu_rl_torch.runtime.mailbox import STAT_SLOTS

# Supervision defaults. Deployments override these via Config
# (heartbeat_timeout_s / startup_grace_s / supervise_poll_s / max_restarts /
# restart_*) — see Supervisor.from_config; the constants remain the
# dataclass defaults so direct Supervisor() construction keeps working.
HEARTBEAT_TIMEOUT = 60.0  # seconds of silence before a child is declared dead
STARTUP_GRACE = 180.0  # extra silence allowed after (re)start: imports,
# kernel builds and warm-ups legitimately take minutes before the first beat
SUPERVISE_POLL = 2.0
RESTART_WINDOW = 300.0  # sliding window for the restart budget
RESTART_BACKOFF = 1.0  # base respawn delay within a crash streak
RESTART_BACKOFF_MAX = 30.0


@contextlib.contextmanager
def _child_env(**env: str):
    """Temporarily set env vars so a spawn-child inherits them."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def rank_entry(target: Callable, rank: int, world: int, rdv: str | None, *args) -> None:
    """One rank of a group child: join the group's process group (through
    the ``file://`` rendezvous ``rdv``; None when the target joins by
    ``multihost`` itself), then run ``target(*args)``. ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` name the rank on its host, as torchrun does."""
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    if rdv is not None:
        import torch

        from tpu_rl_torch.parallel.mesh import init_process_group, rank_device

        cfg = args[0]
        # a sebulba learner group's ranks take the cards after the actor group's
        first = cfg.sebulba_split if cfg.env_mode == "colocated" else 0
        dev, share = rank_device(rank, world, "cpu" if cfg.learner_device == "cpu" else "cuda",
                                 first=first)
        init_process_group(f"file://{rdv}", world, rank, dev, share)
        del torch
    target(*args)


class RankGroup:
    """The ranks of one data-parallel role as ONE supervised child, with
    ``mp.Process``'s surface: alive while every rank is alive; when one rank
    exits non-zero, the others are stopped and the group's exit code is
    that rank's; it exits 0 when every rank did. Each start joins a fresh
    ``file://`` rendezvous, so a respawn brings the whole group back."""

    def __init__(self, ctx, target: Callable, args: tuple, world: int, name: str, daemon: bool,
                 init: bool = True):
        self.ctx, self.target, self.args = ctx, target, args
        self.world, self.name, self.daemon, self.init = world, name, daemon, init
        self.procs: list = []
        self._exitcode: int | None = None

    def start(self) -> None:
        import tempfile

        rdv = None
        if self.init:
            fd, rdv = tempfile.mkstemp(prefix=f"{self.name}-rdv-")
            os.close(fd)
            os.unlink(rdv)  # the file store creates it
        self.procs = [
            self.ctx.Process(
                target=rank_entry, args=(self.target, r, self.world, rdv, *self.args),
                name=f"{self.name}-rank{r}", daemon=self.daemon,
            )
            for r in range(self.world)
        ]
        for p in self.procs:
            p.start()

    def _reap(self) -> None:
        if self._exitcode is not None:
            return
        codes = [p.exitcode for p in self.procs]
        bad = [c for c in codes if c not in (None, 0)]
        if bad:
            self._exitcode = bad[0]
            for p in self.procs:
                if p.is_alive():
                    p.terminate()
            for p in self.procs:
                p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join(5)
        elif all(c == 0 for c in codes):
            self._exitcode = 0

    def is_alive(self) -> bool:
        self._reap()
        return self._exitcode is None

    @property
    def exitcode(self) -> int | None:
        self._reap()
        return self._exitcode

    @property
    def pid(self) -> int | None:
        return self.procs[0].pid if self.procs else None

    def join(self, timeout: float | None = None) -> None:
        deadline = None if timeout is None else time.time() + timeout
        for p in self.procs:
            p.join(None if deadline is None else max(0.0, deadline - time.time()))
            self._reap()
            if self._exitcode not in (None, 0):
                return

    def terminate(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.terminate()

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()


@dataclass
class Child:
    name: str
    target: Callable
    args: tuple
    proc: mp.Process
    heartbeat: Any  # mp.Value("d")
    cpu_only: bool
    # Daemonic children die with the supervisor (the default and the right
    # answer for leaf roles). Population members running a NESTED fleet
    # must be non-daemonic — multiprocessing forbids daemonic processes
    # from having children of their own.
    daemon: bool = True
    restarts: int = 0
    started_at: float = 0.0
    # Sliding-window restart budget + backoff state (Supervisor.check):
    restart_times: list = field(default_factory=list)  # respawn timestamps
    streak: int = 0  # consecutive crashes without an intervening healthy window
    respawn_at: float = 0.0  # dead, respawn scheduled at this time (0 = none)
    exhausted: bool = False  # budget blown; fleet shuts down
    # Ranks of a data-parallel role, supervised as one child (RankGroup);
    # rank_init False: the target joins its process group itself (multihost).
    world: int = 1
    rank_init: bool = True


@dataclass
class Supervisor:
    """Owns the children of one role process; restart-on-silence is the
    feature the reference disabled (``main.py:417-473``). Every child is
    wrapped so a crash writes ``logs/<role>/error_log_<ts>.txt``
    (``utils.errlog``) before the supervisor sees the nonzero exit."""

    ctx: Any = field(default_factory=lambda: mp.get_context("spawn"))
    heartbeat_timeout: float = HEARTBEAT_TIMEOUT
    startup_grace: float = STARTUP_GRACE
    max_restarts: int = 3
    log_root: str = "logs"
    children: list[Child] = field(default_factory=list)
    # Restart budget is per sliding window, not per process lifetime: a
    # child may restart at most `max_restarts` times per trailing
    # `restart_window_s` seconds. Within a crash streak, respawn N is
    # delayed `backoff_s * 2**(N-2)` (first respawn immediate), capped at
    # `backoff_max_s`; a child that stays up a full window resets its
    # streak. This replaces the old lifetime counter + instant respawn,
    # which hot-looped a crashing child straight through its budget.
    restart_window_s: float = RESTART_WINDOW
    backoff_s: float = RESTART_BACKOFF
    backoff_max_s: float = RESTART_BACKOFF_MAX
    poll_s: float = SUPERVISE_POLL
    # Injectable for tests (backoff timing with a mocked clock).
    clock: Callable[[], float] = time.time
    # Audit sink of process events (result_dir); None = no audit.
    audit_dir: str | None = None

    def __post_init__(self):
        self.stop_event = self.ctx.Event()
        self._telem_cfg = None  # (cfg, ip, port) set by enable_telemetry
        self._telem = None  # lazily: (registry, pub, emitter)

    @classmethod
    def from_config(cls, cfg, **kw) -> "Supervisor":
        """Build a supervisor from Config's supervision fields."""
        return cls(
            heartbeat_timeout=cfg.heartbeat_timeout_s,
            startup_grace=cfg.startup_grace_s,
            max_restarts=cfg.max_restarts,
            restart_window_s=cfg.restart_window_s,
            backoff_s=cfg.restart_backoff_s,
            backoff_max_s=cfg.restart_backoff_max_s,
            poll_s=cfg.supervise_poll_s,
            audit_dir=getattr(cfg, "result_dir", None),
            **kw,
        )

    # ----------------------------------------------------------------- spawn
    def spawn(
        self,
        name: str,
        target: Callable,
        *args,
        cpu_only: bool = True,
        daemon: bool = True,
        world: int = 1,
        rank_init: bool = True,
    ) -> Child:
        from tpu_rl_torch.utils.errlog import role_entry

        hb = self.ctx.Value("d", time.time())
        child = Child(
            name=name,
            target=functools.partial(
                role_entry, target, name, self.log_root, cpu_only=cpu_only
            ),
            args=(*args, self.stop_event, hb),
            proc=None,  # type: ignore[arg-type]
            heartbeat=hb,
            cpu_only=cpu_only,
            daemon=daemon,
            world=world,
            rank_init=rank_init,
        )
        self._start(child)
        self.children.append(child)
        return child

    def _start(self, child: Child) -> None:
        from tpu_rl_torch.utils.platform import HOST_ENV

        # A host child starts with no card visible; the learner keeps it.
        env = HOST_ENV if child.cpu_only else {}
        target = child.target
        with _child_env(**env):
            if child.world > 1:
                child.proc = RankGroup(self.ctx, target, child.args, child.world, child.name,
                                       child.daemon, init=child.rank_init)
            else:
                child.proc = self.ctx.Process(
                    target=target,
                    args=child.args,
                    name=child.name,
                    daemon=child.daemon,
                )
            child.heartbeat.value = self.clock()
            child.started_at = self.clock()
            child.proc.start()

    # ------------------------------------------------------------- supervise
    def _ensure_dead(self, child: Child) -> None:
        """Terminate, escalating to SIGKILL: SIGTERM stays *pending* on a
        SIGSTOP'd process, so a hung-but-stopped child survives terminate()
        and would wedge its bound ports forever without the escalation."""
        if child.proc.is_alive():
            child.proc.terminate()
            child.proc.join(5)
        if child.proc.is_alive():
            child.proc.kill()
            child.proc.join(5)

    def check(self) -> list[str]:
        """One supervision pass; returns names of children respawned."""
        restarted = []
        now = self.clock()
        for child in self.children:
            if child.exhausted:
                continue
            if child.respawn_at:
                # Dead, waiting out its backoff delay.
                if now >= child.respawn_at:
                    child.respawn_at = 0.0
                    child.restarts += 1
                    self._start(child)
                    restarted.append(child.name)
                continue
            dead = not child.proc.is_alive()
            if dead and child.proc.exitcode == 0:
                continue  # clean exit (e.g. learner hit max_updates): done
            # Silence only counts after the startup grace: imports, kernel
            # builds and warm-ups block the child's first heartbeat.
            silent = (
                now - child.heartbeat.value > self.heartbeat_timeout
                and now - child.started_at
                > self.heartbeat_timeout + self.startup_grace
            )
            if not (dead or silent):
                continue
            self._ensure_dead(child)
            if now - child.started_at >= self.restart_window_s:
                child.streak = 0  # it ran healthy for a full window
            child.streak += 1
            child.restart_times = [
                t for t in child.restart_times
                if now - t < self.restart_window_s
            ]
            if len(child.restart_times) >= self.max_restarts:
                child.exhausted = True
                print(
                    f"[supervisor] {child.name}: {len(child.restart_times)} "
                    f"restarts within {self.restart_window_s:.0f}s — budget "
                    "exhausted"
                )
                continue
            child.restart_times.append(now)
            # First crash in a streak respawns immediately (a one-off kill
            # should not cost latency); repeats back off exponentially.
            delay = (
                0.0
                if child.streak <= 1
                else min(
                    self.backoff_s * 2.0 ** (child.streak - 2),
                    self.backoff_max_s,
                )
            )
            if delay > 0:
                child.respawn_at = now + delay
                print(
                    f"[supervisor] {child.name}: crash streak "
                    f"{child.streak}, respawn in {delay:.1f}s"
                )
                continue
            child.restarts += 1
            self._start(child)
            restarted.append(child.name)
        return restarted

    def loop(self, poll: float | None = None) -> None:
        """Block until stop: supervise children, exit when all are gone or
        any child exhausted its restart budget."""
        poll = self.poll_s if poll is None else poll
        while not self.stop_event.is_set():
            restarted = self.check()
            for name in restarted:
                print(f"[supervisor] restarted silent/dead child: {name}")
            self._emit_telemetry()
            if any(
                not c.proc.is_alive() and c.proc.exitcode == 0
                and not c.respawn_at
                for c in self.children
            ):
                # A role completed its bounded work (learner max_updates):
                # wind the whole deployment down.
                self.stop_event.set()
                break
            if any(c.exhausted for c in self.children):
                print("[supervisor] child exhausted restart budget; stopping")
                self.stop_event.set()
                break
            if all(
                not c.proc.is_alive() and not c.respawn_at
                for c in self.children
            ):
                break
            time.sleep(poll)
        self._emit_telemetry(force=True)

    # ------------------------------------------------------------ telemetry
    def enable_telemetry(self, cfg, stat_ip: str, stat_port: int) -> None:
        """Arm supervisor telemetry (restart counters shipped onto the
        fleet's stat channel). Idempotent: the first caller wins, so
        local_cluster's three role builders don't triple-publish."""
        if self._telem_cfg is None and cfg.telemetry_enabled:
            self._telem_cfg = (cfg, stat_ip, stat_port)

    def _emit_telemetry(self, force: bool = False) -> None:
        if self._telem_cfg is None:
            return
        if self._telem is None:
            # Lazy build on the first loop() pass: keeps construction off
            # Supervisor.__init__ (tests build bare supervisors) and off
            # import time.
            from tpu_rl_torch.obs import MetricsRegistry, PeriodicSnapshot
            from tpu_rl_torch.runtime.protocol import Protocol
            from tpu_rl_torch.runtime.transport import make_data_pub

            cfg, ip, port = self._telem_cfg
            reg = MetricsRegistry(role="supervisor")
            pub = make_data_pub(cfg, ip, port, bind=False)
            emitter = PeriodicSnapshot(
                reg,
                lambda snap: pub.send(Protocol.Telemetry, snap),
                interval_s=cfg.telemetry_interval_s,
            )
            self._telem = (reg, pub, emitter)
        reg, pub, emitter = self._telem
        reg.counter("supervisor-restarts").set_total(
            sum(c.restarts for c in self.children)
        )
        reg.counter("supervisor-exhausted").set_total(
            sum(1 for c in self.children if c.exhausted)
        )
        reg.gauge("supervisor-children-alive").set(
            sum(1 for c in self.children if c.proc.is_alive())
        )
        if force:
            emitter.maybe_emit(now=float("inf"))
        else:
            emitter.maybe_emit()

    # ---------------------------------------------------------------- stop
    def stop(self, timeout: float = 10.0) -> None:
        self.stop_event.set()
        deadline = time.time() + timeout
        for c in self.children:
            c.proc.join(max(0.1, deadline - time.time()))
        for c in self.children:
            if c.proc.is_alive():
                c.proc.terminate()
        for c in self.children:
            c.proc.join(2)
            if c.proc.is_alive():
                c.proc.kill()
        if self._telem is not None:
            self._telem[1].close()
            self._telem = None

    def install_signal_handlers(self) -> None:
        """SIGINT/SIGTERM -> cooperative stop (reference ``main.py:493-502``)."""

        def handler(signum, frame):
            self.stop_event.set()

        signal.signal(signal.SIGINT, handler)
        signal.signal(signal.SIGTERM, handler)


# --------------------------------------------------------------------- roles
def learner_role(
    cfg: Config,
    machines: MachinesConfig,
    supervisor: Supervisor | None = None,
    max_updates: int | None = None,
    publish_interval: int = 1,
    seed: int = 0,
) -> Supervisor:
    """Spawn LearnerStorage + LearnerService sharing shm (reference
    ``learner_sub_process``, ``main.py:301-414``)."""
    from tpu_rl_torch.runtime.learner_service import learner_main
    from tpu_rl_torch.runtime.storage import storage_main

    sup = supervisor or Supervisor.from_config(cfg)
    # Supervisor restart counters ride the stat channel the storage
    # child SUB-binds on this host (same path as the learner's snapshots).
    sup.enable_telemetry(cfg, "127.0.0.1", machines.learner_port)
    layout = BatchLayout.from_config(cfg)
    from tpu_rl_torch.config import is_off_policy

    capacity = cfg.buffer_size if is_off_policy(cfg.algo) else cfg.batch_size
    handles = alloc_handles(layout, capacity, ctx=sup.ctx)
    stat_array = sup.ctx.Array("f", STAT_SLOTS, lock=False)

    sup.spawn(
        "storage", storage_main, cfg, handles, machines.learner_port, stat_array
    )
    # Inference port plan (collision-checked): replica 0 lives inside the
    # learner process (zero-staleness swaps), replicas 1..N-1 are children.
    inference_ports = (
        machines.inference_ports(cfg) if cfg.act_mode == "remote" else None
    )
    sup.spawn(
        "learner",
        functools.partial(
            learner_main,
            max_updates=max_updates,
            publish_interval=publish_interval,
            seed=seed,
            # The centralized-inference ROUTER (act_mode="remote") binds in
            # the learner process; the service itself gates on act_mode.
            inference_port=(
                inference_ports[0] if inference_ports is not None else None
            ),
            # The stat channel storage SUB-binds: the learner's Telemetry
            # snapshots ship there (LearnerService gates on telemetry_enabled).
            stat_port=machines.learner_port,
        ),
        cfg,
        handles,
        machines.model_port,
        stat_array,
        # "auto": the learner owns the card (and raises without one).
        # "cpu": a host process on the plain path (tests).
        cpu_only=(cfg.learner_device == "cpu"),
        # one rank per device on this host, supervised as one child; under
        # multihost the ranks join the pod at the coordinator themselves
        world=_host_ranks(cfg),
        rank_init=not cfg.multihost,
    )
    if inference_ports is not None and cfg.inference_replicas > 1:
        from tpu_rl_torch.fleet import replica_main

        for i in range(1, cfg.inference_replicas):
            # Named as tpu_rl's: its chaos plane's kill:inference-<i> faults
            # match these children. A replica holds the card as the learner
            # does (or runs the plain path beside a CPU learner).
            sup.spawn(
                f"inference-{i}",
                functools.partial(replica_main, seed=seed),
                cfg,
                i,
                inference_ports[i],
                "127.0.0.1",  # the learner (model PUB) is on this host
                machines.model_port,
                machines.learner_port,
                cpu_only=(cfg.learner_device == "cpu"),
            )
    return sup


def _host_ranks(cfg: Config) -> int:
    """Ranks this host runs for the learner or colocated role: ``mesh_data``
    x ``mesh_seq`` on one host; under ``multihost`` one rank per card of
    the host (``tpu_rl``'s host process drives every local device; one on
    the CPU), each rank joining the pod at the coordinator."""
    if cfg.multihost:
        if cfg.learner_device == "cpu":
            return 1
        import torch

        return max(1, torch.cuda.device_count())
    return max(1, int(cfg.mesh_data) * int(cfg.mesh_seq))


def worker_role(
    cfg: Config,
    machines: MachinesConfig,
    machine_idx: int = 0,
    supervisor: Supervisor | None = None,
    seed: int = 0,
) -> Supervisor:
    """Spawn num_p actor processes (reference ``worker_sub_process``,
    ``main.py:244-299``)."""
    from tpu_rl_torch.runtime.worker import worker_main

    sup = supervisor or Supervisor.from_config(cfg)
    sup.enable_telemetry(cfg, machines.learner_ip, machines.learner_port)
    m = machines.workers[machine_idx]
    # Warm-start every worker from the newest checkpoint when one exists
    # (reference ``main.py:247-252``: the newest saved model is loaded into
    # each worker before spawn). Loaded once here, shared by all num_p
    # children; workers without a checkpoint start from random init and catch
    # the learner's first broadcast.
    initial_params = None
    if cfg.model_dir:
        from tpu_rl_torch.checkpoint import restore_actor_params

        initial_params = restore_actor_params(cfg.model_dir, cfg.algo)
    for i in range(m.num_p):
        sup.spawn(
            f"worker-{machine_idx}-{i}",
            functools.partial(
                worker_main,
                seed=seed * 1000 + machine_idx * 100 + i,
                initial_params=initial_params,
                # A fleet (N > 1) hands workers every replica's port, for the
                # FleetClient to balance and hedge over; one service keeps
                # the scalar port and the plain InferenceClient.
                inference_port=(
                    None if cfg.act_mode != "remote"
                    else machines.inference_ports(cfg)
                    if cfg.inference_replicas > 1
                    else machines.inference_ports(cfg)[0]
                ),
            ),
            cfg,
            i,
            m.manager_ip,
            m.port,
            machines.learner_ip,
            machines.model_port,
        )
    return sup


def manager_role(
    cfg: Config,
    machines: MachinesConfig,
    machine_idx: int = 0,
    supervisor: Supervisor | None = None,
) -> Supervisor:
    """Spawn the relay (reference ``manager_sub_process``, ``main.py:228-242``)."""
    from tpu_rl_torch.runtime.manager import manager_main

    sup = supervisor or Supervisor.from_config(cfg)
    sup.enable_telemetry(cfg, machines.learner_ip, machines.learner_port)
    m = machines.workers[machine_idx]
    sup.spawn(
        f"manager-{machine_idx}",
        manager_main,
        cfg,
        m.port,
        machines.learner_ip,
        machines.learner_port,
    )
    return sup


def colocated_main(
    cfg: Config, stop_event, heartbeat, max_updates: int | None = None,
    seed: int = 0,
) -> None:
    """Supervised child entry of colocated mode: the whole deployment is
    this one process, the existing :class:`~tpu_rl_torch.runtime.colocated.ColocatedLoop`
    on ``learner_device``. The loop runs to ``max_updates`` in one call, so
    the heartbeat beats from a thread of its own while it runs."""
    import threading

    from tpu_rl_torch.runtime.colocated import ColocatedLoop
    from tpu_rl_torch.utils.platform import learner_device

    done = threading.Event()

    def beat() -> None:
        while not done.wait(1.0):
            heartbeat.value = time.time()

    threading.Thread(target=beat, name="colocated-heartbeat", daemon=True).start()
    try:
        loop = ColocatedLoop(
            cfg, seed=seed, max_updates=max_updates, device=learner_device(cfg)
        )
        out = loop.run()
    finally:
        done.set()
    print(
        f"[colocated] done: {out['updates']} updates, "
        f"{out['env_steps']:,} env steps, {out['episodes']} episodes, "
        f"mean return {out['mean_return_overall']:.1f}, "
        f"{out['transitions_per_s']:,.0f} transitions/s",
        flush=True,
    )


def colocated_role(
    cfg: Config,
    machines: MachinesConfig | None = None,
    supervisor: Supervisor | None = None,
    max_updates: int | None = None,
    seed: int = 0,
) -> Supervisor:
    """Spawn the colocated-mode loop: envs live on the device inside the
    training loop, so this host's whole deployment is ONE supervised child.
    ``machines`` is accepted (and ignored) so the CLI can dispatch every
    role through one signature. With ``mesh_data > 1`` (or ``multihost``
    on a host with more than one card) the child is a group of one rank
    per device (:class:`RankGroup`). With ``sebulba_split > 0`` the child
    is the split (``runtime/sebulba.py``), checked here against the host's
    cards first: a split that leaves a group empty (any split of one card)
    is refused before anything is spawned; a learner group of several
    cards is a group of one rank per learner card."""
    del machines  # colocated mode has no fleet topology
    world = _host_ranks(cfg)
    child_main = colocated_main
    if cfg.sebulba_split > 0:
        from tpu_rl_torch.runtime.sebulba import sebulba_main, split_local_devices
        from tpu_rl_torch.utils.platform import learner_device

        _acts, learns = split_local_devices(cfg.sebulba_split, device=learner_device(cfg))
        world, child_main = len(learns), sebulba_main
    sup = supervisor or Supervisor.from_config(cfg)
    sup.spawn(
        "colocated",
        functools.partial(child_main, max_updates=max_updates, seed=seed),
        cfg,
        cpu_only=(cfg.learner_device == "cpu"),
        world=world,
        rank_init=not cfg.multihost,
    )
    return sup


def local_cluster(
    cfg: Config,
    machines: MachinesConfig | None = None,
    max_updates: int | None = None,
    publish_interval: int = 1,
    seed: int = 0,
) -> Supervisor:
    """Everything on one host: learner + storage + manager + workers under a
    single supervisor. The smallest real deployment and the integration-test
    harness. In colocated mode the "cluster" collapses to the single fused
    child (``colocated_role``) — same entry point, same supervisor contract."""
    machines = machines or MachinesConfig()
    sup = Supervisor.from_config(cfg)
    if cfg.env_mode == "colocated":
        return colocated_role(
            cfg, machines, supervisor=sup, max_updates=max_updates, seed=seed
        )
    learner_role(
        cfg,
        machines,
        supervisor=sup,
        max_updates=max_updates,
        publish_interval=publish_interval,
        seed=seed,
    )
    manager_role(cfg, machines, supervisor=sup)
    worker_role(cfg, machines, supervisor=sup, seed=seed)
    return sup


def population_role(
    cfg: Config,
    machines: MachinesConfig | None = None,
    max_updates: int | None = None,
):
    """Build the PBT controller (``population/controller.py``). Unlike the
    other roles this returns the controller, not a Supervisor: the
    controller is the orchestrator and runs in the calling process, owning
    its own supervisor whose children are the K ``member-<k>`` runs."""
    from tpu_rl_torch.population import PopulationController

    return PopulationController(cfg, machines=machines, max_updates=max_updates)


def autopilot_role(
    cfg: Config,
    machines: MachinesConfig | None = None,
    manage_all: bool = False,
    seed: int = 0,
):
    """tpu_rl's fleet autopilot; not in the port yet."""
    raise NotImplementedError(
        "the autopilot role comes with the serving and operations slice of the "
        "port (ROADMAP A 9)"
    )
