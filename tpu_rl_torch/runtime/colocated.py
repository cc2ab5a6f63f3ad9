"""Colocated (Anakin-mode) training loop on one GPU — the port of
``tpu_rl.runtime.colocated``.

Envs, acting and training all run on the device in one process: no workers,
no ZMQ, no shared-memory ring. One iteration (:meth:`ColocatedLoop.program`):

1. :meth:`~ColocatedLoop.rollout`: ``cfg.seq_len`` acting ticks. Each tick
   keeps the worker's tick semantics: store the pre-step obs, pre-step carry
   (zero placeholders for the transformer, which acts from KV caches it
   never stores) and pre-tick ``is_fir``, act (``family.act``: a (B,1)
   action index, or a (B,A) action and per-dimension log-prob for a
   Gaussian policy), step the vectorized env
   (auto-reset and the ``time_horizon`` truncation live in
   :func:`~tpu_rl_torch.envs.make_vec_env`), scale the reward, zero the
   carry on done with ``torch.where`` (never a multiply: a NaN carry must
   not survive the reset), and raise ``is_fir`` for the post-reset step.
   The ticks stack into the learner's batch-major ``(B, S, w)``
   :class:`~tpu_rl_torch.types.Batch`.
2. The algorithm's ``train_step(state, batch, generator=...)`` on that
   batch while it is still on the device (V-MPO draws its KL bound from the
   loop's generator); its LSTM unroll runs the kernels of
   :mod:`tpu_rl_torch.ops.lstm`; the transformer attends through
   ``cfg.attention_impl``: kernel B4 (:mod:`tpu_rl_torch.ops.attention`)
   with ``"flash"``, the plain tile loop with ``"blockwise"`` (the
   long-context config as shipped), or the full scores with ``"full"``.

Episode counts and return sums accumulate on the device; the host reads
them, and the metrics, only every ``cfg.loss_log_interval`` updates.

With ``cfg.model_dir`` set, :meth:`ColocatedLoop.run` saves a crash-atomic
checkpoint (:mod:`tpu_rl_torch.checkpoint`) every
``cfg.model_save_interval`` updates and once more at the end, and starts by
resuming from the newest committed one (refused if its config fingerprint
differs, unless ``cfg.resume_force``): the update index continues from the
checkpoint's, the run epoch is one above its, and the loop's random
generator continues from the state saved in its meta (``tpu_rl`` needs only
the index, since it draws ``fold_in(base, it)``; this loop draws from one
stateful generator). The env carry starts afresh, as in ``tpu_rl``.

With the telemetry plane on (``cfg.telemetry_enabled``: a ``result_dir``
or a ``telemetry_port``) the loop also keeps, as ``tpu_rl``'s does, a
metrics registry behind a :class:`~tpu_rl_torch.obs.TelemetryAggregator`
(``colocated-*`` counters and gauges, among them the FLOPs per update,
achieved FLOP/s, MFU, recompiles and device memory of a
:class:`~tpu_rl_torch.obs.PerfTracker` that counts the first update), a
goodput ledger (compute and checkpoint time), the SLO engine
(``slo_spec``), the history store, the learning-dynamics accumulator fed
with each update's ``diag`` at staleness 0 (with ``learn_diag``), the
``/metrics`` server (``telemetry_port``) and, under ``result_dir``,
``telemetry.json``, ``learn.jsonl``, ``goodput.jsonl``,
``learner_resume.jsonl`` (one line per resume), ``slo.json``, ``history/``
and profiler traces (``prof/``). None of it feeds back into the update:
params with the plane on are bitwise those with it off. With
``cfg.slo_fail_run`` a failing final SLO verdict makes :meth:`run` raise
:class:`SloFailedError` (``tpu_rl``'s role exits non-zero).

**Data parallelism** (``mesh_data`` ranks, or ``multihost``): each rank is
one process on one device, joined to a process group before the loop is
built (``python -m tpu_rl_torch local`` in colocated mode spawns the ranks
of one host;
under ``multihost`` every host's ranks join at ``tcp://coordinator``, and
``mesh_data=1`` widens to the world, as ``tpu_rl``'s pod does). Each rank
steps its ``colocated_envs / world`` envs; every random draw of a tick
(env resets, the action noise) is drawn at the global batch's shape from
the same generator on every rank and sliced by rank, and the train step
takes the mean of the grads over the ranks, so a data-parallel run is the
single-device run up to the order of the reductions (bit for bit at world
size 1). The state is replicated from rank 0 at start (a check that every
rank built or restored the same one); rank 0 alone checkpoints (behind a
barrier), logs and exports telemetry, every rank resumes from the newest
committed checkpoint, and the episode counts are summed over the ranks at
each log point. ``PerfTracker`` counts the world's FLOPs against the
world's peak.
"""

from __future__ import annotations

import json
import os
import time

import torch
import torch.distributed as dist

from tpu_rl_torch import resolve_device
from tpu_rl_torch.algos.registry import get_algo
from tpu_rl_torch.checkpoint import Checkpointer, resume_fingerprint
from tpu_rl_torch.config import Config
from tpu_rl_torch.envs import get_spec, make_vec_env
from tpu_rl_torch.obs import (
    DiagAccumulator,
    GoodputLedger,
    JsonExporter,
    MetricsRegistry,
    PerfTracker,
    ProfilerCapture,
    TelemetryAggregator,
    TelemetryHTTPServer,
    append_jsonl,
    append_resume,
    device_memory_bytes,
    learn_record,
    maybe_history,
    maybe_slo_engine,
    process_self_stats,
)
from tpu_rl_torch.obs import publish as publish_diag
from tpu_rl_torch.obs.goodput import CKPT, COMPUTE
from tpu_rl_torch.ops import distributions as D
from tpu_rl_torch.ops import lstm as L
from tpu_rl_torch.parallel.dp import make_parallel_train_step, replicate
from tpu_rl_torch.parallel.mesh import check_divisible, make_mesh, publish_mesh
from tpu_rl_torch.parallel.multihost import init_multihost
from tpu_rl_torch.types import BATCH_FIELDS, Batch
from tpu_rl_torch.utils.metrics import make_writer
from tpu_rl_torch.utils.timer import ExecutionTimer


def act_params(state) -> dict:
    """The acting parameter dict of either train-state kind (the colocated
    loop is on-policy only; the SAC shape is kept for completeness)."""
    if hasattr(state, "actor_params"):
        return {"actor": state.actor_params}
    return {"actor": state.params["actor"]}


def rank_rows_spec(spec, mesh):
    """``spec`` whose ``reset(n, ...)`` draws the fresh states of all
    ``n * mesh.n_data`` envs of the world and keeps this rank's rows, so
    every rank draws what the single-device run draws."""
    import dataclasses

    def reset(n, generator, device):
        phys, obs = spec.reset(n * mesh.n_data, generator, device)  # (N, ...) tensors
        rows = mesh.rows(n)
        return phys[rows], obs[rows]

    return dataclasses.replace(spec, reset=reset)


def resolve_colocated_config(cfg: Config) -> Config:
    """``colocated_envs`` replaces ``batch_size`` (the env batch IS the train
    batch), and the obs/action spaces come from the env spec."""
    if cfg.colocated_envs:
        cfg = cfg.replace(
            batch_size=cfg.colocated_envs,
            buffer_size=max(cfg.buffer_size, cfg.colocated_envs),
        )
    spec = get_spec(cfg.env)
    return cfg.replace(
        obs_shape=spec.obs_shape, action_space=spec.action_space, is_continuous=spec.is_continuous
    )


class SloFailedError(RuntimeError):
    """Raised by :meth:`ColocatedLoop.run` at its end, after every file is
    written, when ``Config.slo_fail_run`` is set and the final SLO verdict
    fails a rule: uncaught, the run's process exits non-zero."""


class ColocatedLoop:
    """Owns the act -> env step -> train loop and its device state.

    - :meth:`rollout` ``(params, carry, generator) -> (carry, batch, done,
      ep_ret)``: the acting ticks alone;
    - :meth:`program` ``(state, carry, stats, generator) -> (state, carry,
      stats, metrics)``: rollout + train step;
    - :meth:`run`: :meth:`program` up to ``max_updates``, with a summary.

    Runs on ``device="cuda"`` unless the caller passes ``device="cpu"``.
    The initial weights are drawn from a CPU generator seeded with ``seed``;
    acting and env resets draw from a generator on the device seeded with
    ``seed + 1``.
    """

    def __init__(
        self,
        cfg: Config,
        seed: int = 0,
        max_updates: int | None = None,
        device: str | torch.device | None = "cuda",
    ):
        self.device = resolve_device(device)
        cfg = resolve_colocated_config(cfg)
        if cfg.env_mode != "colocated":
            raise ValueError(f"ColocatedLoop needs env_mode='colocated', got {cfg.env_mode!r}")
        self.cfg = cfg
        self.seed = int(seed)
        self.max_updates = max_updates
        if cfg.multihost:
            # this host's ranks (one per card) join the pod's process group
            init_multihost(**cfg.multihost, device=self.device)
        self._build_meshes()
        self.chief = self.mesh is None or self.mesh.rank == 0
        self.spec = get_spec(cfg.env)
        self._v_reset, self._v_step = make_vec_env(self._env_spec(), self.n_local, cfg.time_horizon)
        self.family, self.state, step = get_algo(cfg.algo).build(
            cfg, torch.Generator().manual_seed(self.seed), self.device, mesh=self.mesh
        )
        self.train_step = (step if self.mesh is None
                           else make_parallel_train_step(step, self.mesh, cfg))
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        # Durability: the checkpointer, the run epoch (one above the resumed
        # checkpoint's), the update index run() starts from, the last index
        # saved, and the config fingerprint stored with every save.
        self.ckpt = None
        self.run_epoch = 0
        self._start_it = 0
        self._last_saved = -1
        self._fingerprint = None
        if cfg.model_dir:
            self.ckpt = Checkpointer(
                cfg.model_dir, cfg.algo, keep=cfg.ckpt_keep, async_save=cfg.ckpt_async,
                writer=self.chief,
            )
            self._fingerprint = resume_fingerprint(cfg)
        # Telemetry plane (None unless cfg.telemetry_enabled; rank 0's).
        self.aggregator = None
        self.ledger = None
        self._perf = None
        self._slo = None
        self._history = None
        self._prof = None
        self._http = None
        self._json_exp = None
        self._setup_telemetry()

    # ------------------------------------------------------------- topology
    def _build_meshes(self) -> None:
        """The rank mesh of the loop: None on one device outside a process
        group (the plain path); else a data mesh over the world, where
        under ``multihost`` the default ``mesh_data=1`` widens to the whole
        world."""
        cfg = self.cfg
        if cfg.mesh_seq > 1:
            raise ValueError(
                "the colocated loop trains on a data mesh only, as tpu_rl's does: mesh_seq > 1 "
                "is the learner service's (make_sp_train_step)"
            )
        if not dist.is_initialized():
            if cfg.mesh_data > 1:
                raise ValueError(
                    f"mesh_data={cfg.mesh_data} needs {cfg.mesh_data} ranks, one per device: "
                    "run the colocated role (runner.colocated_role, python -m tpu_rl_torch "
                    "local), which spawns them, or join a process group before building the loop"
                )
            self.mesh = None
            self.n_local = cfg.batch_size
            return
        if self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        world = dist.get_world_size()
        n = world if cfg.multihost and world > 1 and cfg.mesh_data == 1 else cfg.mesh_data
        self.mesh = make_mesh(n, device=self.device)
        check_divisible(cfg.batch_size, self.mesh)
        self.n_local = cfg.batch_size // self.mesh.n_data

    def _env_spec(self):
        """The env spec the vectorized envs step: under a mesh, the one whose
        resets draw the world's envs and keep this rank's rows."""
        return self.spec if self.mesh is None else rank_rows_spec(self.spec, self.mesh)

    # ------------------------------------------------------------ device init
    def init_carry(self, generator: torch.Generator | None = None,
                   device: torch.device | None = None) -> dict:
        """Fresh acting carry on ``device`` (the loop's by default): reset
        envs, zero recurrent state, ``is_fir=1`` (every env starts an
        episode), zero running returns."""
        gen = self.generator if generator is None else generator
        dev = self.device if device is None else device
        env, obs = self._v_reset(gen, dev)
        n = self.n_local
        hw, cw = self.family.carry_widths
        f32 = dict(dtype=torch.float32, device=dev)
        return {
            "env": env,
            "obs": obs,
            "h": torch.zeros((n, hw), **f32),
            "c": torch.zeros((n, cw), **f32),
            "is_fir": torch.ones((n,), **f32),
            "ret": torch.zeros((n,), **f32),
        }

    def init_stats(self) -> dict:
        return {
            "episodes": torch.zeros((), dtype=torch.int64, device=self.device),
            "ret_sum": torch.zeros((), dtype=torch.float32, device=self.device),
        }

    # ------------------------------------------------------------------ steps
    def _tick(self, params, cr: dict, generator: torch.Generator, family=None):
        """One acting tick: the worker loop's body on the device (acting
        through ``family``, the loop's by default)."""
        a, logits, log_prob, h2, c2 = (family or self.family).act(
            params, cr["obs"], cr["h"], cr["c"], generator, **self._act_noise(generator))
        env, obs2, rew, done = self._v_step(cr["env"], a, generator)
        ret2 = cr["ret"] + rew
        if self.family.store_carry:
            hx, cx = cr["h"], cr["c"]
        else:  # transformer: zero placeholders, not the caches
            n = self.n_local
            hx, cx = (torch.zeros((n, w), dtype=torch.float32, device=cr["obs"].device)
                      for w in self.family.stored_carry_widths)
        ys = dict(
            obs=cr["obs"],
            act=a,
            rew=(rew * self.cfg.reward_scale)[:, None],
            logits=logits,
            log_prob=log_prob,
            is_fir=cr["is_fir"][:, None],
            hx=hx,
            cx=cx,
            done=done,
            # Completed-episode raw return, on the terminal tick.
            ep_ret=torch.where(done, ret2, 0.0),
        )
        keep = (~done)[:, None]
        cr2 = {
            "env": env,
            "obs": obs2,
            "h": torch.where(keep, h2, 0.0),
            "c": torch.where(keep, c2, 0.0),
            "is_fir": done.float(),
            "ret": torch.where(done, 0.0, ret2),
        }
        return cr2, ys

    def _act_noise(self, generator: torch.Generator) -> dict:
        """Under a mesh, this rank's rows of the tick's action noise drawn
        at the global batch's shape (the draw the single-device act makes);
        on one device, nothing (the act draws it)."""
        if self.mesh is None:
            return {}
        shape = (self.cfg.batch_size, self.family.n_actions)
        rows = self.mesh.rows(self.n_local)
        if self.family.continuous:
            e = torch.empty(shape, dtype=torch.float32, device=self.device)
            return {"noise": e.normal_(generator=generator)[rows]}
        like = torch.empty((), dtype=torch.float32, device=self.device)
        return {"gumbel": D.gumbel_noise(shape, like, generator)[rows]}

    @torch.no_grad()
    def rollout(self, params, carry: dict, generator: torch.Generator | None = None, family=None):
        gen = self.generator if generator is None else generator
        ticks = []
        for _ in range(self.cfg.seq_len):
            carry, ys = self._tick(params, carry, gen, family)
            ticks.append(ys)

        def stack(f: str) -> torch.Tensor:  # S ticks of (B, w) -> (B, S, w)
            return torch.stack([y[f] for y in ticks], dim=1)

        batch = Batch(**{f: stack(f) for f in BATCH_FIELDS})
        return carry, batch, stack("done"), stack("ep_ret")

    def program(self, state, carry: dict, stats: dict, generator: torch.Generator | None = None):
        gen = self.generator if generator is None else generator
        carry, batch, done, ep_ret = self.rollout(act_params(state), carry, gen)
        state, metrics = self.train_step(state, batch, generator=gen)
        stats = {
            "episodes": stats["episodes"] + done.sum(),
            "ret_sum": stats["ret_sum"] + ep_ret.sum(),
        }
        return state, carry, stats, metrics

    # ----------------------------------------------------------- durability
    def _save(self, state, it: int) -> None:
        """Rank 0 writes the checkpoint (or queues it, with ``ckpt_async``);
        every rank waits at a barrier for it, so the ranks leave every save
        together."""
        if self.chief:
            self.ckpt.save(state, it, meta=self.save_meta())
        if self.mesh is not None:
            dist.barrier()

    def _world_stats(self, stats: dict) -> tuple[int, float]:
        """(episodes, return sum) of the whole world: the ranks' device
        counters summed at a log point (every rank reaches it together)."""
        if self.mesh is None:
            return int(stats["episodes"]), float(stats["ret_sum"])
        both = torch.stack([stats["episodes"].double(), stats["ret_sum"].double()])
        self.mesh.all_reduce_(both)
        return int(both[0]), float(both[1])

    def save_meta(self) -> dict:
        """The run meta committed with a checkpoint: the run epoch, the
        config fingerprint and the generator's state (as a list of bytes)."""
        return {
            "epoch": self.run_epoch,
            "fingerprint": self._fingerprint,
            "generator": self.generator.get_state().tolist(),
        }

    def restore(self, state):
        """Resume from the newest committed checkpoint, if there is one:
        returns its state (else ``state``), and sets the update index, the
        run epoch and the generator's state from it."""
        restored = self.ckpt.restore_run(
            state, fingerprint=self._fingerprint, force=self.cfg.resume_force
        )
        if restored is None:
            return state
        state, self._start_it, meta = restored
        self.run_epoch = int(meta.get("epoch", 0)) + 1
        saved = torch.tensor(meta.get("generator", []), dtype=torch.uint8)
        if saved.numel() == self.generator.get_state().numel():
            self.generator.set_state(saved)
        else:  # no state saved, or one of another device's generator
            print(
                "[colocated] the checkpoint holds no generator state for this device; the "
                "random stream restarts from the seed",
                flush=True,
            )
        return state

    # ------------------------------------------------------------- telemetry
    def _setup_telemetry(self) -> None:
        cfg = self.cfg
        if not cfg.telemetry_enabled or not self.chief:
            return
        self.aggregator = TelemetryAggregator(
            registry=MetricsRegistry(role="colocated"), stale_after_s=cfg.telemetry_stale_s
        )
        self.ledger = GoodputLedger("colocated")
        self._perf = PerfTracker(self.device, world=self.mesh.world if self.mesh else 1)
        self._slo = maybe_slo_engine(cfg)
        self._history = maybe_history(cfg)
        if cfg.result_dir is not None:
            self._prof = ProfilerCapture(os.path.join(cfg.result_dir, "prof"), self.device)
        if cfg.telemetry_port > 0:
            self._http = TelemetryHTTPServer(
                self.aggregator,
                cfg.telemetry_port,
                slo=self._slo.report if self._slo is not None else None,
                prof=self._prof.capture_async if self._prof is not None else None,
                goodput=self._goodput_payload,
                query=self._history.http_query if self._history is not None else None,
            )
        if cfg.result_dir is not None:
            self._json_exp = JsonExporter(
                self.aggregator,
                os.path.join(cfg.result_dir, "telemetry.json"),
                interval_s=cfg.telemetry_interval_s,
            )

    def _telemetry_tick(
        self, updates: int, env_steps: int, episodes: int, ups: float, tps: float,
        chunk_s: float, mean_ret: float,
    ) -> None:
        if self.aggregator is None:
            return
        reg = self.aggregator.registry
        reg.counter("colocated-updates").set_total(updates)
        reg.counter("colocated-env-steps").set_total(env_steps)
        reg.counter("colocated-episodes").set_total(episodes)
        # this process's updates and its B1/B2 launches (counted on the card
        # only): a population member's launches are read against them
        reg.counter("colocated-updates-run").set_total(updates - self._start_it)
        reg.counter("colocated-lstm-fwd-launches").set_total(L.LSTM_FWD_LAUNCHES)
        reg.counter("colocated-lstm-bwd-launches").set_total(L.LSTM_BWD_LAUNCHES)
        if self.mesh is not None:
            publish_mesh(reg, self.mesh)
        reg.gauge("colocated-updates-per-s").set(ups)
        reg.gauge("colocated-env-steps-per-s").set(tps)
        reg.gauge("colocated-mean-episode-return").set(mean_ret)
        reg.histogram("colocated-scan-chunk-s").observe(chunk_s)
        if self._perf is not None:
            # chunk_s is the per-update mean measured against a blocking
            # read: the dispatch interval the tracker wants.
            self._perf.note(chunk_s)
            reg.gauge("colocated-flops-per-step").set(self._perf.flops_per_call)
            achieved = self._perf.achieved_flops_per_s()
            if achieved is not None:
                reg.gauge("colocated-achieved-flops").set(achieved)
            mfu = self._perf.mfu()
            if mfu is not None:
                reg.gauge("colocated-mfu").set(mfu)
            reg.counter("colocated-xla-recompiles").set_total(self._perf.recompiles)
            in_use, peak = device_memory_bytes(self.device)
            reg.gauge("colocated-device-mem-bytes").set(in_use)
            reg.gauge("colocated-device-mem-peak-bytes").set(peak)
            rss, n_fds = process_self_stats()
            reg.gauge("colocated-rss-bytes").set(rss)
            reg.gauge("colocated-open-fds").set(float(n_fds))
        if self.ledger is not None:
            self.ledger.publish(reg)
        if self._slo is not None:
            self._slo.evaluate(self.aggregator)
        if self._json_exp is not None and self._json_exp.maybe_export():
            if self._history is not None:
                # one history row per export, on the exporter's cadence
                self._history.record(self.aggregator)
            if self.ledger is not None:
                append_jsonl(self.cfg.result_dir, "goodput.jsonl", self._goodput_payload())

    def _goodput_payload(self) -> dict:
        """The GET /goodput document of the single-process deployment: this
        loop's ledger snapshot (no fleet, so no stragglers)."""
        return {
            "colocated": self.ledger.snapshot() if self.ledger is not None else None,
            "roles": {},
            "stragglers": [],
        }

    def _record_resume(self, idx: int) -> None:
        """One resume record in result_dir/learner_resume.jsonl, the file
        and schema ``{"idx", "epoch", "t"}`` of ``tpu_rl``'s learner and
        colocated loop."""
        append_resume(self.cfg.result_dir, idx, self.run_epoch)

    @property
    def slo_failed(self) -> bool:
        """Whether the latest SLO verdict fails a rule: the
        ``Config.slo_fail_run`` gate of :meth:`run`."""
        return self._slo is not None and self._slo.failed

    def close(self) -> None:
        if self.ckpt is not None:
            self.ckpt.close()
            self.ckpt = None
        if self._http is not None:
            self._http.close()
            self._http = None
        if self._prof is not None:
            self._prof.close()
            self._prof = None
        if self._slo is not None and self.cfg.result_dir is not None:
            os.makedirs(self.cfg.result_dir, exist_ok=True)
            with open(os.path.join(self.cfg.result_dir, "slo.json"), "w") as f:
                json.dump(self._slo.report(), f, indent=2)
        if self._json_exp is not None:
            # a final write whatever the exporter's cadence
            self._json_exp.maybe_export(now=float("inf"))
        if self._history is not None:
            self._history.record(self.aggregator)
            self._history.close()
            self._history = None

    # --------------------------------------------------------------- run loop
    def run(self, log: bool = True) -> dict:
        """Drive :meth:`program` to ``max_updates`` (the update index, which
        continues from a resumed checkpoint's). Returns the run totals:
        ``updates`` (the final index), ``env_steps``, ``episodes``,
        ``mean_return_overall``, ``mean_return_recent`` (the last log
        window's completed-episode mean), ``mean_return_best_window`` (the
        best such window), ``elapsed_s``, ``transitions_per_s`` (of this
        run's updates), and the timer's ``scalars``."""
        cfg = self.cfg
        log = log and self.chief
        n, s = cfg.batch_size, cfg.seq_len
        timer = ExecutionTimer(num_transition=n * s)
        writer = make_writer(cfg.result_dir if self.chief else None)
        state = self.state
        if self.ckpt is not None:
            state = self.restore(state)  # every rank, from the newest committed
            if self.run_epoch and self.chief:
                self._record_resume(self._start_it)
                if log:
                    print(
                        f"[colocated] resumed from committed checkpoint idx {self._start_it} "
                        f"(run epoch {self.run_epoch})",
                        flush=True,
                    )
        if self.mesh is not None:
            replicate(state, self.mesh)  # raises if a rank built or restored another
        carry = self.init_carry()
        stats = self.init_stats()
        ledger, perf = self.ledger, self._perf
        # Learning-dynamics plane: each update's diag folds into the device
        # accumulator (a few device ops, no sync), drained at the log
        # cadence. Colocated rollouts train the iteration they are made,
        # so every row is staleness 0. Built only where the document has
        # somewhere to go.
        diag_acc = DiagAccumulator() if cfg.learn_diag and cfg.telemetry_enabled else None
        stale0 = None
        log_every = max(1, cfg.loss_log_interval)
        it = last_it = self._start_it
        last_ep, last_ret = 0, 0.0
        mean_ret, best_ret = 0.0, float("-inf")
        t0 = t_mark = time.perf_counter()
        while self.max_updates is None or it < self.max_updates:
            t_disp = time.perf_counter()
            if perf is not None:
                # the first update is the one whose FLOPs are counted
                state, carry, stats, metrics = perf.call(self.program, state, carry, stats)
            else:
                state, carry, stats, metrics = self.program(state, carry, stats)
            diag = metrics.pop("diag", None)
            if diag_acc is not None and diag is not None:
                if stale0 is None:
                    n_rows = next(iter(diag["rows"].values())).shape[0] if diag["rows"] else 0
                    stale0 = torch.zeros((n_rows,), dtype=torch.float32, device=self.device)
                diag_acc.add(diag, stale0)
            if ledger is not None:
                ledger.add(COMPUTE, time.perf_counter() - t_disp)
            it += 1
            if self.ckpt is not None and it % cfg.model_save_interval == 0:
                t_ck = time.perf_counter()
                self._save(state, it)
                if ledger is not None:
                    ledger.add(CKPT, time.perf_counter() - t_ck)
                self._last_saved = it
            if it % log_every and it != self.max_updates:
                continue
            # The host reads block on iteration `it`, so the clock below
            # covers the device's work (and the ledger's compute bucket).
            t_get = time.perf_counter()
            episodes, ret_sum = self._world_stats(stats)
            host_metrics = {k: float(v) for k, v in metrics.items()}
            now = time.perf_counter()
            if ledger is not None:
                ledger.add(COMPUTE, now - t_get)
            iters = it - last_it
            chunk_s = (now - t_mark) / max(1, iters)
            timer.record("colocated-iteration", chunk_s, check_throughput=True)
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
                    f"[colocated] update {it}  tps {tps:,.0f}  episodes {episodes}  "
                    f"mean_return {mean_ret:.1f}  "
                    + "  ".join(f"{k} {v:.4f}" for k, v in host_metrics.items()),
                    flush=True,
                )
            last_it, last_ep, last_ret = it, episodes, ret_sum
            t_mark = time.perf_counter()
        episodes, ret_sum = self._world_stats(stats)
        elapsed = time.perf_counter() - t0
        if self.ckpt is not None and it > self._start_it and it != self._last_saved:
            # the newest state is left durable when the run ends between saves
            t_ck = time.perf_counter()
            self._save(state, it)
            if ledger is not None:
                ledger.add(CKPT, time.perf_counter() - t_ck)
            self._last_saved = it
        writer.flush()
        writer.close()
        self.close()
        if self.mesh is not None:
            # rank 0's checkpoint writer has drained: a loop built next, on
            # any rank, restores what this one saved
            dist.barrier()
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
            "scalars": timer.scalars(),
        }
        if cfg.slo_fail_run and self.slo_failed:
            failing = [r["rule"] for r in self._slo.report()["rules"] if r["ok"] is False]
            raise SloFailedError(
                f"the final SLO verdict fails {failing} (slo_fail_run); run totals: {totals}"
            )
        return totals
