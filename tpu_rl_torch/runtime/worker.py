"""Actor (worker) process: step the env with the latest broadcast policy and
stream per-step transitions to the manager relay — the port of
``tpu_rl.runtime.worker``.

One framed ``RolloutBatch`` per tick carries all ``worker_num_envs``
transitions; per-episode stats, hot weight reload from the learner's
broadcast, the ``time_horizon`` cap, reward scaling, the step throttle and
the heartbeat are ``tpu_rl``'s. A worker is a host process: it acts with the
port's ``make_act_fn`` on CPU tensors (``tpu_rl``'s topology: the learner
owns the accelerator), so with ``act_kernel="pallas"`` it runs kernel B3's
plain version. The broadcast carries the actor in ``tpu_rl``'s flax layout
(the frame ``tpu_rl``'s learner sends); the worker bridges it into its
``state_dict`` (:func:`~tpu_rl_torch.bridge.flax_to_state_dict`).

``Config.act_mode`` selects the acting path:

- ``"local"``: the policy forward on the worker's host cores against the
  freshest broadcast params, sampling from a torch generator seeded with
  ``seed * 9973 + worker_id``;
- ``"remote"``: the tick's observations go to the learner's
  :class:`~tpu_rl_torch.runtime.inference_service.InferenceService` over a
  DEALER/ROUTER channel, or, with ``inference_replicas > 1``, to the
  inference fleet through a :class:`~tpu_rl_torch.fleet.client.FleetClient`
  (``inference_port`` is then the list of replica ports); actions, logits,
  log-probs (and the pre-step carry rows) come back and the published
  RolloutBatch has the same layout as in local mode. If the service (or
  every replica) times out ``inference_retries`` times the worker logs once
  and falls back to local acting on its last broadcast params, then
  re-probes every ``inference_reprobe_s`` seconds (doubling);
  ``inference_reprobe_s=0`` keeps the fallback permanent.

With ``Config.chaos_spec`` set, the chaos plane shims the worker's PUB and
model SUB (``delay:worker``, ``corrupt``/``drop:model``) and poisons the
tick payload's values just before the send (``nan``/``spike``), and the
worker publishes the six ``chaos-*`` counters.
"""

from __future__ import annotations

import os
import sys
import time
import uuid

import numpy as np

import torch

from tpu_rl_torch.bridge import flax_to_state_dict
from tpu_rl_torch.config import Config
from tpu_rl_torch.runtime.env import EnvAdapter
from tpu_rl_torch.runtime.protocol import Protocol, make_trace_id, pack_trace
from tpu_rl_torch.runtime.transport import MODEL_HWM, Pub, Sub


# The FleetClient's event counts, published by their telemetry names.
_FLEET_COUNTERS = {
    "fleet-hedge-fired": "n_hedges",
    "fleet-failovers": "n_failovers",
    "fleet-dedup-replies": "n_dedups",
    "fleet-floor-rejects": "n_floor_rejects",
    "fleet-reprobes": "n_reprobes",
}


class Worker:
    def __init__(
        self,
        cfg: Config,
        worker_id: int,
        manager_ip: str,
        manager_port: int,
        learner_ip: str,
        model_port: int,
        stop_event=None,
        heartbeat=None,
        initial_params=None,
        seed: int = 0,
        inference_port: int | list[int] | None = None,
    ):
        self.cfg = cfg
        self.worker_id = worker_id
        self.addr = (manager_ip, manager_port, learner_ip, model_port)
        self.stop_event = stop_event
        self.heartbeat = heartbeat
        self.initial_params = initial_params
        self.seed = seed
        self.inference_port = inference_port
        self.fell_back = False  # currently acting locally after a timeout
        self.n_remote_acts = 0
        # Recovery-event counters (telemetry + flight recorder): fallbacks
        # to local acting, re-probe attempts, successful restorations.
        self.n_fallbacks = 0
        self.n_reprobes = 0
        self.n_restores = 0

    # ------------------------------------------------- cold one-time/fault
    # Helpers kept OUT of run(): the tick loop's function is held to the
    # hot-path purity gate's fmt tier (tools/analysis), so all string
    # rendering lives here on the cold setup/fault paths.
    def _init_tracer(self, cfg: Config):
        """Build the trace recorder + dump path and install the flight
        recorder; -> (tracer, trace_path)."""
        from tpu_rl_torch.obs import TraceRecorder, flightrec

        tracer = TraceRecorder(
            capacity=cfg.trace_capacity, pid=os.getpid(), role="worker"
        )
        trace_path = os.path.join(
            cfg.result_dir, f"trace-worker-{os.getpid()}.json"
        )
        flightrec.install(
            "worker",
            cfg.result_dir,
            tracer=tracer,
            cfg=cfg,
            extra=lambda: {
                "fell_back": self.fell_back,
                "n_fallbacks": self.n_fallbacks,
                "n_reprobes": self.n_reprobes,
                "n_restores": self.n_restores,
            },
        )
        return tracer, trace_path

    def _log_fallback(self, cfg: Config, reprobe_backoff: float) -> None:
        """Log (once per fallback) the drop from remote to local acting."""
        print(
            f"[worker {self.worker_id}] inference service "
            f"unreachable after "
            f"{cfg.inference_retries + 1} attempts of "
            f"{cfg.inference_timeout_ms} ms; falling back to "
            f"local acting"
            + (
                f" (re-probing every {reprobe_backoff:.0f}s)"
                if cfg.inference_reprobe_s > 0
                else " permanently"
            ),
            file=sys.stderr,
            flush=True,
        )

    def _log_restore(self) -> None:
        print(
            f"[worker {self.worker_id}] inference service "
            "reachable again; remote acting restored",
            file=sys.stderr,
            flush=True,
        )

    def _make_remote(self, cfg: Config, learner_ip: str):
        """Build the remote-acting client for ``self.inference_port``: a
        :class:`~tpu_rl_torch.fleet.client.FleetClient` over a list of
        replica ports, else the single service's :class:`InferenceClient`.
        Used for the initial client and every re-probe, so a fallback under
        a fleet re-probes the whole fleet."""
        port = self.inference_port
        if isinstance(port, (list, tuple)):
            from tpu_rl_torch.fleet import FleetClient

            return FleetClient(cfg, [(learner_ip, int(p)) for p in port], wid=self.worker_id)
        from tpu_rl_torch.runtime.inference_service import InferenceClient

        return InferenceClient(cfg, learner_ip, port, wid=self.worker_id)

    # ------------------------------------------------------------------ run
    def run(self) -> None:
        with torch.inference_mode():
            self._run()

    def _run(self) -> None:
        from tpu_rl_torch.models.families import build_family

        cfg = self.cfg
        manager_ip, manager_port, learner_ip, model_port = self.addr
        # Fault injection (tpu_rl_torch.chaos): delay:worker shims this
        # worker's sends, corrupt/drop:model its model-SUB receives; nan:/
        # spike: poison rollout payload values pre-send (the wire stays
        # CRC-valid: the heal plane must contain them). None unless a
        # chaos_spec names this site / this worker instance.
        chaos = dchaos = None
        if cfg.chaos_spec:
            from tpu_rl_torch.chaos import maybe_data_chaos, maybe_transport_chaos

            chaos = maybe_transport_chaos(cfg, "worker", instance=self.worker_id)
            dchaos = maybe_data_chaos(cfg, "worker", instance=self.worker_id)
        pub = Pub(manager_ip, manager_port, bind=False, chaos=chaos)
        model_sub = Sub(learner_ip, model_port, bind=False, hwm=MODEL_HWM, chaos=chaos)

        # Telemetry (tpu_rl_torch.obs): periodic registry snapshots ride the same
        # PUB as rollouts/stats, emitted on the CLOCK — an idle or wedged
        # worker keeps announcing itself to /healthz. Disabled (None) when
        # the plane has no sink, so the tick loop pays one `is None` check.
        registry = emitter = None
        # Clock-sync echo (tpu_rl_torch.obs.clocksync): (t0, t1) of the newest
        # Model broadcast — t0 the learner's send stamp, t1 our receive
        # stamp — shipped inside Telemetry snapshots so the storage edge can
        # close a full NTP round trip through this worker. None until the
        # first stamped broadcast arrives.
        clk_echo: list | None = None
        # Run epoch adopted from the newest Model broadcast; -1 = unknown
        # (no broadcast yet). Echoed on every RolloutBatch and Telemetry
        # frame so storage can fence out frames acted under a pre-crash
        # learner incarnation (unknown is always accepted).
        run_epoch = -1
        ledger = None
        if cfg.telemetry_enabled:
            from tpu_rl_torch.obs import MetricsRegistry, PeriodicSnapshot
            from tpu_rl_torch.obs.goodput import COMPUTE, IDLE, WIRE, GoodputLedger
            from tpu_rl_torch.obs.perf import process_self_stats

            registry = MetricsRegistry(
                role="worker", labels={"wid": str(self.worker_id)}
            )
            # Goodput ledger: act + env stepping is this role's compute
            # (remote acting included — outsourced or not, it is the tick's
            # purposeful work); model-SUB drains and the rollout publish are
            # wire; the reference throttle sleep is idle.
            ledger = self.ledger = GoodputLedger("worker")

            def _send_snap(snap, _wid=self.worker_id):
                snap["wid"] = _wid  # aggregator source key + UI grouping
                snap["epoch"] = run_epoch  # membership lease + epoch fence
                clk = {"t2": time.time_ns()}  # our clock at snapshot send
                if clk_echo is not None:
                    clk["t0"], clk["t1"] = clk_echo
                snap["clk"] = clk
                pub.send(Protocol.Telemetry, snap)

            emitter = PeriodicSnapshot(
                registry, _send_snap, interval_s=cfg.telemetry_interval_s
            )

        # Rollout-lineage tracing (tpu_rl_torch.obs): every trace_sample_n-th tick
        # ships a trace-context trailer as the frame's third wire part and
        # records a local span. sample_n == 0 (the default) keeps the loop's
        # entire trace branch to one falsy check; the recorder itself needs
        # result_dir to have somewhere to dump.
        sample_n = int(cfg.trace_sample_n)
        tracer = None
        trace_path = None
        if cfg.result_dir is not None:
            tracer, trace_path = self._init_tracer(cfg)

        family = build_family(cfg, device="cpu")
        gen = torch.Generator().manual_seed(self.seed * 9973 + self.worker_id)
        if self.initial_params is not None:
            params = {"actor": self.initial_params["actor"]}  # checkpoint warm start
        else:
            params = {"actor": family.init_params(gen)["actor"]}
        # Local act path shares the serving kernel dispatch
        # (Config.act_kernel): "pallas" is kernel B3's wrapper, which takes
        # its plain version on these CPU tensors; "xla" is family.act.
        from tpu_rl_torch.models.quant import make_act_fn

        act = make_act_fn(cfg, family)

        # Remote acting (act_mode="remote"): ship obs to the learner-device
        # inference service, fall back to the local jitted path above if it
        # ever becomes unreachable.
        remote = None
        if cfg.act_mode == "remote" and self.inference_port is not None:
            remote = self._make_remote(cfg, learner_ip)
        # Corrupt-reply count accumulated from CLOSED inference clients
        # (each fallback/failed probe folds its client's n_rejected in
        # before closing); the live client's count is added at read sites,
        # so the published total survives any number of fallback/restore
        # cycles.
        remote_rejected = 0
        # Fleet-event totals, accumulated the same way across client
        # generations (FleetClient only; 0 under a single service).
        fleet = dict.fromkeys(_FLEET_COUNTERS.values(), 0)

        def _fold_fleet(client) -> None:
            for attr in fleet:
                fleet[attr] += getattr(client, attr, 0)
        # Fallback recovery state: when remote acting drops to local, probe
        # the service again every `inference_reprobe_s`, doubling up to
        # `inference_reprobe_max_s` while it stays down. 0 disables (the
        # old permanent one-way degradation).
        next_reprobe: float | None = None
        reprobe_backoff = cfg.inference_reprobe_s

        # Vectorized acting: N envs stepped per tick with ONE batched policy
        # forward (worker_num_envs; N=1 reproduces the reference's
        # one-env-per-process loop exactly). Each env keeps its own episode
        # identity, carry row, and stats; resets zero only that env's carry.
        n = cfg.worker_num_envs
        envs = [
            EnvAdapter(cfg, seed=self.seed * 131 + self.worker_id + i * 7919)
            for i in range(n)
        ]
        # Acting carry shapes come from the family (LSTM: hidden states;
        # transformer: obs-history window + counter); batch storage widths
        # come from the layout and may be placeholders when the carry is
        # worker-local (family.store_carry False).
        from tpu_rl_torch.data.layout import BatchLayout

        lay = BatchLayout.from_config(cfg)
        hw, cw = family.carry_widths
        h = torch.zeros((n, hw))
        c = torch.zeros((n, cw))
        hx_stub = np.zeros((n, lay.hx), np.float32)
        cx_stub = np.zeros((n, lay.cx), np.float32)
        obs = np.stack([e.reset() for e in envs]).astype(np.float32)
        episode_ids = [uuid.uuid4().hex for _ in range(n)]
        is_fir = np.ones(n, np.float32)
        epi_rew = np.zeros(n, np.float64)
        epi_steps = np.zeros(n, np.int64)
        n_model_loads = 0
        # Policy version = the learner update index tagged onto the frame
        # that delivered the params this tick acts with ("ver" on Model
        # broadcasts and inference Act replies). Echoed into every
        # RolloutBatch so storage can measure policy staleness per worker;
        # -1 = still on local random init (never broadcast-loaded).
        policy_ver = -1
        tick_seq = 0  # advances only while lineage sampling is on

        try:
            while not self._stopped():
                # Lineage sampling decision for this tick (off: one falsy
                # check). The sampled tick's span covers act + env-step +
                # publish — the worker-side cost of the frame.
                sampled = False
                if sample_n:
                    tick_seq += 1
                    sampled = tick_seq % sample_n == 0
                    if sampled:
                        t_tick = time.perf_counter()
                        trace_id = make_trace_id(self.worker_id, tick_seq)
                # Hot-reload the freshest broadcast params (reference
                # ``req_model`` task, ``worker.py:62-72``).
                t_drain = time.perf_counter()
                for proto, payload in model_sub.drain(max_msgs=MODEL_HWM):
                    if proto == Protocol.Model:
                        params = {"actor": flax_to_state_dict(payload["actor"])}
                        policy_ver = int(payload.get("ver", -1))
                        run_epoch = int(payload.get("epoch", run_epoch))
                        n_model_loads += 1
                        if registry is not None:
                            # Clock-sync echo: pair the learner's send stamp
                            # with our receive stamp (t0, t1).
                            t_tx = payload.get("t_tx")
                            if isinstance(t_tx, int):
                                clk_echo = [t_tx, time.time_ns()]

                t_act = time.perf_counter()
                if ledger is not None:
                    ledger.add(WIRE, t_act - t_drain)
                if remote is not None:
                    t_rtt = time.perf_counter()
                    reply = remote.act(obs, is_fir)
                    if reply is not None and registry is not None:
                        # Worker-observed round trip through the inference
                        # service — the p99 the SLO examples budget against.
                        registry.histogram("inference-rtt").observe(
                            time.perf_counter() - t_rtt
                        )
                else:
                    reply = None
                if remote is not None and reply is None:
                    # Fault path: the service timed out through every retry.
                    # Log once per fallback, drop to local acting on the
                    # last broadcast params — a dead server must never
                    # wedge the fleet — and schedule a re-probe so a
                    # RESTARTED server regains this client.
                    self._log_fallback(cfg, reprobe_backoff)
                    remote_rejected += remote.n_rejected
                    _fold_fleet(remote)
                    remote.close()
                    remote = None
                    self.fell_back = True
                    self.n_fallbacks += 1
                    if cfg.inference_reprobe_s > 0:
                        next_reprobe = time.monotonic() + reprobe_backoff
                elif (
                    remote is None
                    and next_reprobe is not None
                    and time.monotonic() >= next_reprobe
                ):
                    # Re-probe: one zero-retry request on a FRESH client
                    # (fresh DEALER identities — the old ones may be black-
                    # holed in a dead server's queue). Under a fleet the
                    # probe client spans every replica, so ANY healthy
                    # replica restores remote acting — a single timeout
                    # never strands the worker on local acting while the
                    # rest of the fleet is up. Success restores remote
                    # acting and this tick already has its reply; failure
                    # costs one inference_timeout_ms and doubles the probe
                    # interval.
                    probe = self._make_remote(cfg, learner_ip)
                    self.n_reprobes += 1
                    reply = probe.act(obs, is_fir, retries=0)
                    if reply is not None:
                        remote = probe
                        self.fell_back = False
                        self.n_restores += 1
                        reprobe_backoff = cfg.inference_reprobe_s
                        next_reprobe = None
                        self._log_restore()
                    else:
                        remote_rejected += probe.n_rejected
                        _fold_fleet(probe)
                        probe.close()
                        reprobe_backoff = min(
                            reprobe_backoff * 2.0,
                            cfg.inference_reprobe_max_s,
                        )
                        next_reprobe = time.monotonic() + reprobe_backoff
                if reply is not None:
                    # The service already sampled on the learner's device;
                    # for store_carry families the reply carries the
                    # pre-step carry rows the learner trains from (the
                    # running carry itself stays server-side).
                    self.n_remote_acts += 1
                    a_np = np.asarray(reply["act"], np.float32)
                    logits_np = np.asarray(reply["logits"], np.float32)
                    lp_np = np.asarray(reply["log_prob"], np.float32)
                    h_np = (
                        np.asarray(reply["hx"], np.float32)
                        if family.store_carry else None
                    )
                    c_np = (
                        np.asarray(reply["cx"], np.float32)
                        if family.store_carry else None
                    )
                else:
                    a, logits, log_prob, h2, c2 = act(
                        params, torch.from_numpy(obs), h, c, generator=gen
                    )
                    a_np = a.numpy()
                    logits_np = logits.numpy()
                    lp_np = log_prob.numpy()
                    h_np = h.numpy() if family.store_carry else None
                    c_np = c.numpy() if family.store_carry else None

                # One framed RolloutBatch per tick: step every env, stack
                # the tick's transitions, send ONCE (per-env sends were
                # measured to cap the wire at ~3.2k env-steps/s at 32 envs
                # — framing overhead, not stepping). Episode-end Stats stay
                # per-episode messages (rare).
                rews = np.zeros((n, 1), np.float32)
                dones = np.zeros(n, np.uint8)
                tick_obs = obs.copy()  # pre-step observations, (n, obs)
                tick_fir = is_fir.copy()
                tick_ids = list(episode_ids)
                for i, env in enumerate(envs):
                    next_ob, rew, done = env.step(a_np[i])
                    epi_rew[i] += rew
                    epi_steps[i] += 1
                    horizon_hit = epi_steps[i] >= cfg.time_horizon
                    rews[i, 0] = rew * cfg.reward_scale
                    dones[i] = 1 if (done or horizon_hit) else 0

                    is_fir[i] = 0.0
                    obs[i] = next_ob
                    if done or horizon_hit:
                        # Episode stat rides as a dict so per-worker health
                        # counters (model reloads)
                        # reach the dashboards; the manager also accepts the
                        # reference's bare-float form. n_rejected covers both
                        # of this worker's receive channels: the model SUB
                        # and (when acting remotely) the inference DEALER.
                        pub.send(
                            Protocol.Stat,
                            {
                                "rew": float(epi_rew[i]),
                                "n_model_loads": n_model_loads,
                                "n_rejected": model_sub.n_rejected
                                + remote_rejected
                                + (remote.n_rejected if remote else 0),
                                "wid": self.worker_id,
                            },
                        )
                        obs[i] = env.reset()
                        episode_ids[i] = uuid.uuid4().hex
                        is_fir[i], epi_rew[i], epi_steps[i] = 1.0, 0.0, 0
                t_built = time.perf_counter()
                if ledger is not None:
                    # Policy forward + env stepping (episode-end stat sends
                    # are rare and ride inside the span — sub-ms noise).
                    ledger.add(COMPUTE, t_built - t_act)
                # Version echo: remote ticks acted with the server's params
                # (the reply says which update produced them); local ticks
                # acted with the last broadcast. Extra keys are ignored by
                # the assembler (it reads only the batch fields + id/done),
                # so pre-upgrade consumers are unaffected.
                tick_ver = (
                    int(reply.get("ver", policy_ver))
                    if reply is not None
                    else policy_ver
                )
                trailer = (
                    pack_trace(
                        self.worker_id, tick_seq, trace_id, time.time_ns()
                    )
                    if sampled
                    else None
                )
                tick_payload = dict(
                    obs=tick_obs,
                    act=a_np,
                    rew=rews,
                    logits=logits_np,
                    log_prob=lp_np,
                    is_fir=tick_fir[:, None],
                    hx=h_np if family.store_carry else hx_stub,
                    cx=c_np if family.store_carry else cx_stub,
                    id=tick_ids,
                    done=dones,
                    wid=self.worker_id,
                    ver=tick_ver,
                    epoch=run_epoch,
                )
                if dchaos is not None:
                    dchaos.on_tick(tick_payload)
                pub.send(Protocol.RolloutBatch, tick_payload, trace=trailer)
                if ledger is not None:
                    ledger.add(WIRE, time.perf_counter() - t_built)
                if sampled and tracer is not None:
                    tracer.add(
                        "worker-tick",
                        t_tick,
                        time.perf_counter() - t_tick,
                        args={"trace_id": trace_id, "seq": tick_seq},
                    )

                # Carry forward; zero only the rows whose episode ended
                # (where(), not multiply: a transient NaN in a dying
                # episode's carry must not survive the reset as NaN*0).
                # Remote ticks skip this: the carry lives server-side and
                # the next request's is_fir flags do the zeroing there.
                if reply is None:
                    if dones.any():
                        keep = torch.from_numpy(dones == 0)[:, None]
                        h = torch.where(keep, h2, 0.0)
                        c = torch.where(keep, c2, 0.0)
                    else:
                        h, c = h2, c2

                if registry is not None:
                    registry.counter("worker-env-steps").inc(n)
                    registry.counter("worker-ticks").inc()
                    if dones.any():
                        registry.counter("worker-episodes").inc(
                            int(dones.sum())
                        )
                    registry.gauge("worker-policy-version").set(tick_ver)
                    registry.gauge("worker-run-epoch").set(run_epoch)
                    registry.counter("worker-model-loads").set_total(
                        n_model_loads
                    )
                    registry.counter("worker-rejected-frames").set_total(
                        model_sub.n_rejected
                        + remote_rejected
                        + (remote.n_rejected if remote else 0)
                    )
                    if cfg.act_mode == "remote":
                        registry.counter(
                            "worker-remote-fallbacks"
                        ).set_total(self.n_fallbacks)
                        registry.counter(
                            "worker-remote-reprobes"
                        ).set_total(self.n_reprobes)
                        registry.counter(
                            "worker-remote-restores"
                        ).set_total(self.n_restores)
                        for name, attr in _FLEET_COUNTERS.items():
                            registry.counter(name).set_total(
                                fleet[attr] + getattr(remote, attr, 0)
                            )
                    if chaos is not None:
                        registry.counter("chaos-corrupted-frames").set_total(chaos.n_corrupted)
                        registry.counter("chaos-dropped-frames").set_total(chaos.n_dropped)
                        registry.counter("chaos-delayed-frames").set_total(chaos.n_delayed)
                    if dchaos is not None:
                        registry.counter("chaos-nan-injected").set_total(dchaos.n_nan)
                        registry.counter("chaos-spike-injected").set_total(dchaos.n_spike)
                        registry.counter("chaos-logp-nan-injected").set_total(dchaos.n_logp_nan)
                    if emitter.due():
                        # /proc self-stats only just before an emit — the
                        # reads cost syscalls, the gauges only travel then.
                        rss, n_fds = process_self_stats()
                        registry.gauge("worker-rss-bytes").set(rss)
                        registry.gauge("worker-open-fds").set(float(n_fds))
                        ledger.publish(registry)
                    if emitter.maybe_emit() and tracer is not None:
                        # Trace dumps ride the telemetry cadence: no clock
                        # of their own, and a crash between dumps still
                        # leaves a recent ring on disk for the merger.
                        tracer.dump(trace_path)
                if self.heartbeat is not None:
                    self.heartbeat.value = time.time()
                if cfg.worker_step_sleep > 0:
                    # Reference throttle (``worker.py:131``); 0 disables.
                    # Applies per tick (= per batched act), so N envs yield
                    # N env-steps per throttle window.
                    time.sleep(cfg.worker_step_sleep)
                    if ledger is not None:
                        ledger.add(IDLE, cfg.worker_step_sleep)
        finally:
            if tracer is not None and tracer.n_recorded:
                tracer.dump(trace_path)
            for env in envs:
                env.close()
            pub.close()
            model_sub.close()
            if remote is not None:
                remote.close()

    def _stopped(self) -> bool:
        return self.stop_event is not None and self.stop_event.is_set()


def worker_main(
    cfg: Config,
    worker_id: int,
    manager_ip: str,
    manager_port: int,
    learner_ip: str,
    model_port: int,
    stop_event,
    heartbeat,
    initial_params=None,
    seed: int = 0,
    inference_port: int | list[int] | None = None,
) -> None:
    """mp.Process target (reference ``worker_run``, ``main.py:155-162``)."""
    Worker(
        cfg,
        worker_id,
        manager_ip,
        manager_port,
        learner_ip,
        model_port,
        stop_event,
        heartbeat,
        initial_params,
        seed,
        inference_port=inference_port,
    ).run()
