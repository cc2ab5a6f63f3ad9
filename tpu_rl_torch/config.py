"""Typed configuration — the port's own copy of ``tpu_rl.config``
(``Config``, ``WorkerMachine``, ``MachinesConfig``, ``default_result_dirs``).

``Config`` holds the fields the serving, training, durability and
distributed-runtime slices read, with ``tpu_rl``'s names, defaults and
asserts, so an existing params file loads unchanged. Keys the port does not
know yet are kept in ``extra``: a full ``tpu_rl`` params file still loads.
Those of them that would make ``tpu_rl`` do something the port does not do
yet (arm chaos, run the autopilot) are refused at a value other than
their default (:data:`LATER_SLICES`, :class:`NotPortedError`), so that a
run never silently does less than asked. The multi-GPU keys
(``mesh_data``, ``mesh_seq``, ``multihost``, ``sebulba_split``,
``sebulba_queue``), the inference fleet's (``inference_replicas``,
``inference_mesh_data``) and the population's (``pop_spec``, ``pop_seed``)
are fields, with ``tpu_rl``'s asserts.

One deliberate divergence (ROADMAP C 7): ``learner_device="auto"`` means
the card, and a learner without one raises; ``tpu_rl`` probes its
accelerator and quietly degrades the learner to the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable

# Algorithms that train from a replay (tpu_rl.config.OFF_POLICY_ALGOS).
OFF_POLICY_ALGOS = frozenset({"SAC", "SAC-Continuous"})


# Config fields that shape the train state or the meaning of its numbers:
# the resume compatibility surface hashed by
# tpu_rl_torch.checkpoint.resume_fingerprint (tpu_rl.config
# .FINGERPRINT_FIELDS, copied in its order). Runtime knobs are left out:
# changing them must never strand a checkpoint.
FINGERPRINT_FIELDS = (
    "env", "algo", "model", "hidden_size", "n_heads", "n_layers", "seq_len", "attention_impl",
    "obs_shape", "action_space", "is_continuous", "compute_dtype", "need_conv", "height",
    "width", "is_gray",
)


def is_off_policy(algo: str) -> bool:
    return algo in OFF_POLICY_ALGOS

# Keys of a tpu_rl params file that the port keeps in ``extra`` but refuses
# away from their default: (key, is it set?, the slice of the port that
# brings it). Defaults as in tpu_rl.config.Config.
LATER_SLICES: tuple[tuple[str, Callable[[Any], bool], str], ...] = (
    ("chaos_spec", lambda v: v is not None, "serving and operations slice (A 9: chaos)"),
    ("autopilot_spec", lambda v: v is not None,
     "serving and operations slice (A 9: autopilot)"),
)


class NotPortedError(NotImplementedError, ValueError):
    """A key of a plane the port does not run yet, set away from its
    default. Also a ``ValueError``: the type ``tpu_rl`` raises for a spec
    string it cannot parse, so a params file that ``tpu_rl`` refuses is
    refused here with a type its callers already catch."""


@dataclass
class Config:
    # experiment
    env: str = "CartPole-v1"
    algo: str = "PPO"
    # Checkpoint directory of the colocated loop (None = no checkpoints).
    model_dir: str | None = None
    # Run artifacts: telemetry.json, learn.jsonl, goodput.jsonl,
    # learner_resume.jsonl, slo.json, history/ and profiler traces (prof/).
    result_dir: str | None = None
    # observation preprocessing (tpu_rl's unused conv flags; fingerprinted)
    need_conv: bool = False
    height: int = 84
    width: int = 84
    is_gray: bool = False
    # model
    hidden_size: int = 64
    # Policy backbone: "lstm" or "transformer" (on-policy algos only).
    model: str = "lstm"
    n_heads: int = 4
    n_layers: int = 2
    # Attention of the transformer: "full" (materialized scores), "blockwise"
    # (tiles with the online softmax), "flash" (kernel B4), or the
    # sequence-parallel "ring" / "ulysses" over the mesh's seq group.
    attention_impl: str = "full"
    # Acting context (KV-cache length) of the transformer; 0 = seq_len.
    act_ctx: int = 0
    seq_len: int = 5
    # Reset the LSTM carry at in-sequence episode seams (tpu_rl default).
    reset_carry_on_first: bool = True
    # R2D2-style zero-init of the recurrent carry at training-window starts
    # (types.maybe_zero_carry); False = the stored carry, as the reference.
    zero_window_carry: bool = False
    # Compute dtype of the train step ("float32" or "bfloat16": params stay
    # f32, the products run in bf16 with f32 sums).
    compute_dtype: str = "float32"
    # Number of envs one worker steps per tick (one batched act per tick).
    worker_num_envs: int = 1
    # Dynamic-batch flush knobs of the inference service: a batch is
    # dispatched when `inference_batch` rows are pending OR the oldest
    # pending request is `inference_flush_us` microseconds old.
    inference_batch: int = 64
    inference_flush_us: int = 1000
    # Serving precision of the actor params: "f32", "bf16" or "int8"
    # (models/quant.py; widened to f32 inside each act step).
    inference_dtype: str = "f32"
    # Padded-batch bucket ladder: 0 = one fixed pad_rows shape; > 0 =
    # power-of-two buckets from this floor up to pad_rows.
    inference_buckets: int = 0
    # Act-step kernel: "xla" = the unfused module forward (family.act);
    # "pallas" = the fused act kernel (tpu_rl_torch.ops.fused_act), the name
    # kept so tpu_rl params files load.
    act_kernel: str = "xla"
    # rollout
    time_horizon: int = 500
    # Hold each policy action for k underlying env steps, summing rewards
    # (runtime/env.EnvAdapter.step); 1 = no repeat.
    action_repeat: int = 1
    reward_scale: float = 0.1
    batch_size: int = 128
    buffer_size: int = 10240
    # Data-parallel mesh size of the learner (1 = one device): one rank per
    # device on torch.distributed, each training on batch_size / mesh_data
    # rows of the global batch.
    mesh_data: int = 1
    # Sequence-parallel mesh size (long-context training; needs
    # model="transformer" and attention_impl "ring"/"ulysses").
    mesh_seq: int = 1
    # Multi-host learner: {"coordinator": "ip:port", "num_processes": N,
    # "process_id": i}; the ranks of every host join one process group at
    # tcp://coordinator (parallel.multihost).
    multihost: dict | None = None
    # returns / losses
    gamma: float = 0.99
    lmbda: float = 0.95
    eps_clip: float = 0.1
    policy_loss_coef: float = 1.0
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.00005
    # SAC: initial temperature, Polyak rate, temperature floor (0 = none),
    # the temperature's Adam lr (None = lr), the target entropy (None = the
    # rule of algos/sac.py) and the reference's own alpha rule (audit only).
    alpha: float = 0.2
    tau: float = 0.005
    alpha_min: float = 0.0
    alpha_lr: float | None = None
    target_entropy: float | None = None
    sac_reference_alpha: bool = False
    # V-trace clips (IMPALA) and the optional [v_min, v_max] clamp of the
    # values and targets (None = no clamp).
    rho_bar: float = 0.8
    rho_min: float = 0.1
    c_bar: float = 1.0
    value_target_clip: tuple[float, float] | None = None
    # V-MPO: initial Lagrange multipliers and the dual coefficients.
    v_mpo_lagrange_multiplier_init: float = 5.0
    coef_eta: float = 0.01
    coef_alpha_upper: float = 0.01
    coef_alpha_below: float = 0.005
    # Lower bound of the Gaussian policy's std (PPO-Continuous); 0 = none.
    std_floor: float = 0.0
    # optimization
    K_epoch: int = 1
    lr: float = 0.0001
    max_grad_norm: float = 40.0
    # Two-phase entropy/lr anneal of the distributed learner: after the
    # switch point ({"at": absolute update index} or {"frac": fraction of
    # max_updates}) training continues with {"coef": entropy_coef, "lr":
    # lr (optional)}.
    entropy_anneal: dict | None = None
    # Distributed learner early stop: the fleet's 50-game mean reward (stat
    # mailbox, window full) reaching this ends the learner cleanly.
    stop_at_reward: float | None = None
    # torch.profiler capture of ~profile_steps updates once profile_start
    # updates of this run have completed (None = no capture).
    profile_dir: str | None = None
    profile_start: int = 10
    profile_steps: int = 5
    # Skip an update whose loss or global grad-norm is not finite, keeping
    # params and optimizer state; counted in the "nonfinite-updates" metric.
    update_guard: bool = True
    # The train step also returns the learning-dynamics "diag" dict.
    learn_diag: bool = True
    # Updates between two host reads of the run's metrics.
    loss_log_interval: int = 50
    # ---- telemetry plane (tpu_rl_torch.obs); on iff telemetry_enabled ----
    # HTTP port of /metrics, /healthz, /slo, /prof, /goodput and /query;
    # 0 = no server, no socket.
    telemetry_port: int = 0
    # Seconds between two writes of result_dir/telemetry.json (and history
    # rows).
    telemetry_interval_s: float = 5.0
    # A source silent longer than this is reported dead by /healthz.
    telemetry_stale_s: float = 30.0
    # Declarative SLO rules evaluated each telemetry tick
    # (tpu_rl_torch/obs/slo.py grammar); served at /slo and written to
    # result_dir/slo.json at close. None = no engine.
    slo_spec: str | None = None
    # ColocatedLoop.run raises SloFailedError at its end (the process exits
    # non-zero) when the final SLO verdict fails a rule.
    slo_fail_run: bool = False
    # Run-history store (tpu_rl_torch.obs.history): its directory (None =
    # result_dir/history), the chunk rotation period and the retention
    # horizon, in seconds.
    history_dir: str | None = None
    history_chunk_s: float = 60.0
    history_retention_s: float = 3600.0
    # Checkpoints (checkpoint.py): updates between two saves, committed
    # checkpoints kept, the device snapshot written on a background thread
    # (False = a blocking save), and resume despite a fingerprint mismatch.
    model_save_interval: int = 100
    ckpt_keep: int = 5
    ckpt_async: bool = True
    resume_force: bool = False
    # "distributed" (workers, the reference topology) or "colocated" (envs
    # stepped on the device inside the training loop; runtime/colocated.py).
    env_mode: str = "distributed"
    # Env batch of the colocated loop; 0 = batch_size (the env batch IS the
    # train batch).
    colocated_envs: int = 0
    # Sebulba split (runtime/sebulba.py): this many of the host's cards act,
    # the rest train, fed through a bounded queue of batches on the card
    # (0 = off: the colocated loop). Needs env_mode="colocated"; the split
    # must leave both groups non-empty (checked where the cards are counted).
    sebulba_split: int = 0
    # Batch slots between the two groups (2 = double buffering): bounds the
    # learner's staging memory and the policy lag (at most depth + 1).
    sebulba_queue: int = 2
    # ---- distributed runtime (runtime/{runner,worker,manager,storage,
    # learner_service}.py) ----
    # Updates per learner dispatch: K consumed batches, K sequential
    # updates (tpu_rl's chained scan, here a loop); 1 = one per batch.
    learner_chain: int = 1
    # Depth of the learner's prefetch queue (data/prefetch.py); 0 = the
    # synchronous feed and a synchronous model publish.
    learner_prefetch: int = 2
    # Off-policy cap on updates per received transition (None = no gate).
    max_update_data_ratio: float | None = None
    # "auto": the learner trains on the card (and raises without one);
    # "cpu": the plain path on the CPU (tests).
    learner_device: str = "auto"
    # Worker throttle per tick, seconds (0 = none).
    worker_step_sleep: float = 0.05
    # RolloutAssembler idle-trajectory drop window, seconds.
    rollout_lag_sec: float = 0.5
    # "raw": the manager forwards rollout frames verbatim after a header
    # check; "decode": it decodes and re-encodes each (the A/B baseline).
    relay_mode: str = "raw"
    # Data-hop fabric of the fan-in: "tcp", "shm" (same-host rings) or
    # "auto" (shm where the peer address is loopback). The model broadcast
    # and the acting channel stay TCP.
    transport: str = "tcp"
    # "local": workers act on their own host cores; "remote": through the
    # learner's InferenceService (B3 under act_kernel="pallas").
    act_mode: str = "local"
    # Remote-acting fault path: retries after a timeout, then local acting
    # on the last broadcast params, re-probing every inference_reprobe_s
    # seconds (doubling up to inference_reprobe_max_s; 0 = never).
    inference_timeout_ms: int = 2000
    inference_retries: int = 2
    inference_reprobe_s: float = 5.0
    inference_reprobe_max_s: float = 60.0
    # Inference fleet (tpu_rl_torch.fleet): replicas serving the acting
    # plane. 1 = the learner's one service; N > 1: replica 0 in the learner,
    # replicas 1..N-1 standalone processes fed by the model broadcast, and
    # workers act through the FleetClient.
    inference_replicas: int = 1
    # First port of the replica range [base, base + replicas) (0 =
    # learner_port + 2).
    inference_base_port: int = 0
    # FleetClient: resend the same request to a second replica after this
    # many ms without a reply (0 = only at the timeout: plain failover).
    inference_hedge_ms: int = 0
    # Devices one replica spans: each runs B3 on its share of a flush's rows.
    inference_mesh_data: int = 1
    # Supervisor: silence before a child is restarted, the grace after a
    # (re)start, the poll period, and the sliding-window restart budget
    # with its backoff.
    heartbeat_timeout_s: float = 60.0
    startup_grace_s: float = 180.0
    supervise_poll_s: float = 2.0
    max_restarts: int = 3
    restart_window_s: float = 300.0
    restart_backoff_s: float = 1.0
    restart_backoff_max_s: float = 30.0
    # The idle learner re-publishes its weights this often, so late joiners
    # converge (0 = only on updates).
    rebroadcast_idle_s: float = 2.0
    # Storage's membership lease: a worker silent this long is evicted.
    membership_lease_s: float = 15.0
    # Learner divergence watchdog (heal/watchdog.py) and its rollback budget.
    watchdog_enabled: bool = False
    watchdog_window: int = 32
    watchdog_z: float = 6.0
    watchdog_sustain: int = 3
    watchdog_nonfinite: int = 3
    watchdog_diag: bool = False
    max_rollbacks: int = 3
    rollback_window_s: float = 600.0
    # Storage ingress validation (heal/ingress.py) and worker quarantine.
    ingress_validate: bool = False
    ingress_abs_max: float = 1e6
    quarantine_strikes: int = 3
    quarantine_clear_s: float = 2.0
    # TraceRecorder ring capacity, and every Nth worker tick sampled into
    # the fleet trace (0 = off).
    trace_capacity: int = 4096
    trace_sample_n: int = 0
    # Population plane (tpu_rl_torch.population): the PBT search space and
    # schedule (population/spec.py grammar, parse-checked at load), and the
    # seed every member's seed, draw and mutation derive from.
    pop_spec: str | None = None
    pop_seed: int = 0
    # runtime-derived (filled by the runner, not the JSON)
    obs_shape: tuple[int, ...] = (4,)
    action_space: int = 2
    is_continuous: bool = False
    # Keys of a tpu_rl params file this port does not read yet.
    extra: dict[str, Any] = field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def from_json(cls, path: str | os.PathLike, **overrides: Any) -> "Config":
        with open(path) as f:
            raw = json.load(f)
        return cls.from_dict({**raw, **overrides})

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)} - {"extra"}
        kwargs = {k: v for k, v in raw.items() if k in names}
        for k in ("obs_shape", "value_target_clip"):
            if isinstance(kwargs.get(k), list):
                kwargs[k] = tuple(kwargs[k])
        cfg = cls(**kwargs, extra={k: v for k, v in raw.items() if k not in names})
        cfg.validate()
        return cfg

    def validate(self) -> None:
        for key, is_set, slice_name in LATER_SLICES:
            value = self.extra.get(key)
            if value is not None and is_set(value):
                raise NotPortedError(
                    f"{key}={value!r}: the port does not do this yet; it comes with the "
                    f"{slice_name} of the port"
                )
        assert self.seq_len >= 2, "seq_len must be >= 2 (losses bootstrap from t+1)"
        assert self.batch_size >= 1
        assert self.buffer_size >= self.batch_size
        assert 0.0 <= self.gamma <= 1.0
        assert 0.0 <= self.lmbda <= 1.0
        assert self.height >= 1 and self.width >= 1, (self.height, self.width)
        assert self.hidden_size >= 1, self.hidden_size
        assert self.n_heads >= 1 and self.n_layers >= 1, (self.n_heads, self.n_layers)
        assert self.act_ctx >= 0, self.act_ctx
        assert self.time_horizon >= 1, self.time_horizon
        assert self.reward_scale != 0.0, "reward_scale 0 zeroes every reward"
        assert self.eps_clip > 0, self.eps_clip
        assert self.alpha > 0, self.alpha
        assert 0.0 < self.tau <= 1.0, self.tau
        assert self.alpha_min >= 0, self.alpha_min
        assert self.alpha_lr is None or self.alpha_lr > 0, self.alpha_lr
        assert 0.0 < self.rho_min <= self.rho_bar, (self.rho_min, self.rho_bar)
        assert self.c_bar > 0, self.c_bar
        assert self.coef_eta > 0, self.coef_eta
        assert self.std_floor >= 0.0, (
            f"std_floor must be >= 0 (got {self.std_floor}): a negative floor "
            "makes the Gaussian std negative and log-probs NaN"
        )
        if self.sac_reference_alpha and self.target_entropy is not None:
            raise ValueError(
                "sac_reference_alpha=True pins target_entropy to the "
                "reference's +action_space rule; unset target_entropy "
                f"(got {self.target_entropy})"
            )
        if self.value_target_clip is not None:
            lo, hi = self.value_target_clip  # must be a (lo, hi) pair
            assert float(lo) < float(hi), self.value_target_clip
        assert self.K_epoch >= 1, self.K_epoch
        assert self.lr > 0, self.lr
        assert self.max_grad_norm > 0, self.max_grad_norm
        assert self.mesh_data >= 1, self.mesh_data
        if self.multihost and set(self.multihost) - {"coordinator", "num_processes", "process_id"}:
            raise ValueError(
                f"multihost takes tpu_rl's keys coordinator, num_processes and process_id, got "
                f"{sorted(self.multihost)}: a host runs one rank per card, counted from its cards"
            )
        assert self.loss_log_interval >= 1, self.loss_log_interval
        self._validate_runtime()
        if self.slo_spec:
            # a typo'd rule dies at load, not silently mid-run
            from tpu_rl_torch.obs.slo import parse_slo_spec

            parse_slo_spec(self.slo_spec)
        if self.pop_spec:
            # fail at load, with the searchable-field rule: a sampled field
            # must be numeric and outside FINGERPRINT_FIELDS
            from tpu_rl_torch.population.spec import PopSpec

            PopSpec.parse(self.pop_spec).check_searchable()
        assert self.pop_seed >= 0, self.pop_seed
        # the autopilot's knobs (its spec is refused above until it is ported)
        poll = self.extra.get("autopilot_poll_s", 1.0)
        assert poll > 0, poll
        drain = self.extra.get("autopilot_drain_s", 0.5)
        assert drain >= 0, drain
        assert 0 <= self.telemetry_port < 65536, self.telemetry_port
        assert self.telemetry_interval_s > 0, self.telemetry_interval_s
        assert self.telemetry_stale_s > 0, self.telemetry_stale_s
        assert self.history_chunk_s > 0, self.history_chunk_s
        assert self.history_retention_s >= self.history_chunk_s, (
            f"history_retention_s ({self.history_retention_s}) must cover at "
            f"least one chunk ({self.history_chunk_s}s) — a shorter horizon "
            "would GC every chunk at rotation time"
        )
        assert self.model_save_interval >= 1, self.model_save_interval
        assert self.ckpt_keep >= 1, (
            f"ckpt_keep must be >= 1 (got {self.ckpt_keep}): GC may never "
            "remove the newest committed checkpoint"
        )
        assert self.env_mode in ("distributed", "colocated"), self.env_mode
        assert self.colocated_envs >= 0, self.colocated_envs
        if self.env_mode == "colocated":
            assert not is_off_policy(self.algo), (
                f"env_mode='colocated' is on-policy only (each fused rollout "
                f"trains once, no replay); {self.algo} needs "
                f"env_mode='distributed'"
            )
            assert not self.need_conv, (
                "colocated mode has no image-env dynamics (tpu_rl_torch.envs)"
            )
            if self.multihost:
                # the env batch shards over the global data axis, so it
                # must at least divide by the process count
                nproc = int(self.multihost.get("num_processes", 1))
                envs = self.colocated_envs or self.batch_size
                assert nproc >= 1, self.multihost
                assert envs % nproc == 0, (
                    f"colocated env batch ({envs}) not divisible by "
                    f"multihost num_processes ({nproc}) — it shards over "
                    "the global data axis"
                )
        assert self.sebulba_split >= 0, self.sebulba_split
        assert self.sebulba_queue >= 1, self.sebulba_queue
        if self.sebulba_split:
            assert self.env_mode == "colocated", (
                "sebulba_split splits the colocated plane's device groups; "
                "set env_mode='colocated'"
            )
            assert self.multihost is None, (
                "sebulba_split is a per-host (single-process) split; "
                "multihost pod scaling uses the fused Anakin path"
            )
        assert self.action_repeat >= 1, self.action_repeat
        assert self.compute_dtype in (
            "float32",
            "bfloat16",
        ), f"compute_dtype must be float32 or bfloat16, got {self.compute_dtype!r}"
        assert self.model in ("lstm", "transformer"), self.model
        assert self.attention_impl in ("full", "blockwise", "flash", "ring", "ulysses")
        if self.mesh_seq > 1:
            assert self.model == "transformer", (
                "sequence parallelism (mesh_seq>1) requires model='transformer'"
            )
            assert self.attention_impl in ("ring", "ulysses")
            assert self.seq_len % self.mesh_seq == 0, (
                f"seq_len {self.seq_len} not divisible by mesh_seq {self.mesh_seq}"
            )
            if self.attention_impl == "ulysses":
                assert self.n_heads % self.mesh_seq == 0, (
                    f"ulysses needs n_heads ({self.n_heads}) divisible by "
                    f"mesh_seq ({self.mesh_seq})"
                )
        if self.model == "transformer":
            assert not is_off_policy(self.algo), (
                "transformer backbone supports the on-policy algorithms"
            )
        if self.is_continuous and not self.algo.endswith("-Continuous"):
            raise ValueError(
                f"algo {self.algo!r} is discrete-only but env {self.env!r} "
                "has a continuous action space; use PPO-Continuous or "
                "SAC-Continuous"
            )
        if self.zero_window_carry and self.algo.removesuffix(
            "-Continuous"
        ) in ("PPO", "V-MPO"):  # PPO-Continuous shares ppo.td_target_and_gae
            # tpu_rl's warning, word for word: measured there, zeroed
            # training carries fail GAE-based algorithms under async lag.
            import warnings

            warnings.warn(
                f"zero_window_carry=True with {self.algo}: GAE-based "
                "algorithms measurably fail under async lag with zeroed "
                "training carries (capped/flat fleet reward); use stored "
                "carries (zero_window_carry=False) for PPO/V-MPO — "
                "zero-init is the V-trace/IMPALA fix (CLUSTER_R5_PPO.md)",
            )
        assert self.worker_num_envs >= 1, self.worker_num_envs
        assert self.inference_batch >= 1, self.inference_batch
        assert self.inference_flush_us >= 0, self.inference_flush_us
        assert self.inference_dtype in ("f32", "bf16", "int8"), self.inference_dtype
        assert self.inference_buckets >= 0, self.inference_buckets
        assert self.act_kernel in ("xla", "pallas"), self.act_kernel
        if self.act_kernel == "pallas" and self.model == "transformer":
            # tpu_rl serves the transformer unfused (family.act); the port
            # refuses instead
            raise NotImplementedError(
                "act_kernel='pallas' with model='transformer': the fused act kernel "
                "covers the LSTM actor-critic only, and tpu_rl serves the transformer "
                "unfused (family.act); use act_kernel='xla'"
            )
        if self.act_kernel == "pallas" and self.compute_dtype == "bfloat16" and self.model == "lstm":
            # tpu_rl serves this unfused (family.act); the port refuses instead
            raise NotImplementedError(
                "act_kernel='pallas' with compute_dtype='bfloat16': the fused act kernel "
                "computes in f32 only, and tpu_rl serves a bf16-compute LSTM unfused "
                "(family.act); use act_kernel='xla'"
            )

    def _validate_runtime(self) -> None:
        """tpu_rl's asserts of the distributed runtime's keys, in its order."""
        replicas = self.inference_replicas
        assert self.profile_start >= 0, self.profile_start
        assert self.profile_steps >= 1, self.profile_steps
        assert self.worker_step_sleep >= 0, self.worker_step_sleep
        assert self.rollout_lag_sec > 0, self.rollout_lag_sec
        assert self.learner_device in ("auto", "cpu"), self.learner_device
        assert self.act_mode in ("local", "remote"), self.act_mode
        assert self.relay_mode in ("raw", "decode"), self.relay_mode
        assert self.transport in ("tcp", "shm", "auto"), self.transport
        assert self.inference_timeout_ms > 0, self.inference_timeout_ms
        assert self.inference_retries >= 0, self.inference_retries
        assert self.inference_reprobe_s >= 0, self.inference_reprobe_s
        assert self.inference_reprobe_max_s >= self.inference_reprobe_s, (
            f"inference_reprobe_max_s ({self.inference_reprobe_max_s}) must "
            f"be >= inference_reprobe_s ({self.inference_reprobe_s})"
        )
        assert self.inference_replicas >= 1, self.inference_replicas
        assert self.inference_hedge_ms >= 0, self.inference_hedge_ms
        assert self.inference_hedge_ms <= self.inference_timeout_ms, (
            f"inference_hedge_ms ({self.inference_hedge_ms}) past the "
            f"request timeout ({self.inference_timeout_ms} ms) can never fire"
        )
        assert self.inference_mesh_data >= 1, self.inference_mesh_data
        if self.inference_base_port:
            assert (
                0 < self.inference_base_port
                and self.inference_base_port + replicas <= 65536
            ), (
                f"inference replica ports [{self.inference_base_port}, "
                f"{self.inference_base_port + replicas}) fall outside the port space"
            )
            assert not (
                self.inference_base_port
                <= self.telemetry_port
                < self.inference_base_port + replicas
            ), (
                f"telemetry_port {self.telemetry_port} collides with the "
                f"inference replica port range [{self.inference_base_port}, "
                f"{self.inference_base_port + replicas})"
            )
        assert self.heartbeat_timeout_s > 0, self.heartbeat_timeout_s
        assert self.startup_grace_s >= 0, self.startup_grace_s
        assert self.supervise_poll_s > 0, self.supervise_poll_s
        assert self.max_restarts >= 0, self.max_restarts
        assert self.restart_window_s > 0, self.restart_window_s
        assert self.restart_backoff_s >= 0, self.restart_backoff_s
        assert self.restart_backoff_max_s >= 0, self.restart_backoff_max_s
        assert self.rebroadcast_idle_s >= 0, self.rebroadcast_idle_s
        assert self.membership_lease_s > 0, self.membership_lease_s
        assert self.watchdog_window >= 2, self.watchdog_window
        assert self.watchdog_z > 0, self.watchdog_z
        assert self.watchdog_sustain >= 1, self.watchdog_sustain
        assert self.watchdog_nonfinite >= 1, self.watchdog_nonfinite
        assert self.max_rollbacks >= 1, self.max_rollbacks
        assert self.rollback_window_s > 0, self.rollback_window_s
        assert self.ingress_abs_max > 0, self.ingress_abs_max
        assert self.quarantine_strikes >= 1, self.quarantine_strikes
        assert self.quarantine_clear_s >= 0, self.quarantine_clear_s
        if self.watchdog_enabled:
            assert self.update_guard, (
                "watchdog_enabled requires update_guard: the nonfinite "
                "trigger channel reads the in-jit guard counter"
            )
            assert self.ckpt_keep >= 2, (
                f"watchdog_enabled requires ckpt_keep >= 2 (got "
                f"{self.ckpt_keep}): rollback restores the previous "
                "committed checkpoint"
            )
        if self.watchdog_diag:
            assert self.watchdog_enabled, (
                "watchdog_diag extends the watchdog's signal set; enable "
                "watchdog_enabled (and its prerequisites) first"
            )
            assert self.learn_diag, (
                "watchdog_diag requires learn_diag: the approx-KL/ESS "
                "signals come from the learning-dynamics diagnostics"
            )
        assert self.trace_capacity >= 1, self.trace_capacity
        assert self.trace_sample_n >= 0, self.trace_sample_n
        assert self.learner_chain >= 1, self.learner_chain
        assert self.learner_prefetch >= 0, (
            f"learner_prefetch must be >= 0 (0 = synchronous feed), "
            f"got {self.learner_prefetch}"
        )
        if self.max_update_data_ratio is not None:
            assert self.max_update_data_ratio > 0, (
                f"max_update_data_ratio must be > 0 (updates per received "
                f"transition), got {self.max_update_data_ratio}"
            )
        if self.learner_chain > 1:
            assert self.mesh_seq == 1, (
                "learner_chain > 1 is not supported with sequence "
                "parallelism (mesh_seq > 1)"
            )
            assert self.multihost is None, (
                "learner_chain > 1 is not supported with a multihost learner"
            )
            assert self.sebulba_split == 0, (
                "learner_chain > 1 is not supported with a sebulba split"
            )
        if self.entropy_anneal is not None:
            a = self.entropy_anneal
            assert "coef" in a, "entropy_anneal needs 'coef' (final entropy_coef)"
            assert ("at" in a) or ("frac" in a), (
                "entropy_anneal needs a switch point: 'at' (absolute update "
                "index) or 'frac' (fraction of the run's update budget)"
            )
            if "frac" in a:
                assert 0.0 < float(a["frac"]) < 1.0, a["frac"]

    @property
    def telemetry_enabled(self) -> bool:
        """The gate of the telemetry plane: on iff the metrics have
        somewhere to go (an HTTP port or a result_dir). Off, nothing of the
        plane is built and the hot paths pay one ``is None`` check."""
        return self.telemetry_port > 0 or self.result_dir is not None

    @property
    def effective_act_ctx(self) -> int:
        return self.act_ctx or self.seq_len

    def replace(self, **kw: Any) -> "Config":
        new = dataclasses.replace(self, **kw)
        new.validate()
        return new

    def to_dict(self) -> dict[str, Any]:
        """The params-file shape ``from_dict`` loads: every field, and the
        ``extra`` keys beside them."""
        out = dataclasses.asdict(self)
        return {**out.pop("extra"), **out}

    def to_json(self, path: str | os.PathLike) -> None:
        """Write :meth:`to_dict` crash-atomically (tmp + ``os.replace``):
        the population controller rewrites a live member's config.json on
        exploit, and a member respawning meanwhile must read the old or the
        new file, never a torn one."""
        path = os.fspath(path)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)


@dataclass
class WorkerMachine:
    """One actor machine entry (reference ``utils/machines.json``)."""

    num_p: int = 2
    manager_ip: str = "127.0.0.1"
    ip: str = "127.0.0.1"
    port: int = 27165


@dataclass
class MachinesConfig:
    """Cluster topology (reference ``utils/machines.json``)."""

    learner_ip: str = "127.0.0.1"
    learner_port: int = 47165
    workers: list[WorkerMachine] = field(default_factory=lambda: [WorkerMachine()])

    @classmethod
    def from_json(cls, path: str | os.PathLike) -> "MachinesConfig":
        with open(path) as f:
            raw = json.load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "MachinesConfig":
        learner = raw.get("learner", {})
        workers = [WorkerMachine(**w) for w in raw.get("workers", [])]
        return cls(
            learner_ip=learner.get("ip", "127.0.0.1"),
            learner_port=int(learner.get("port", 47165)),
            workers=workers or [WorkerMachine()],
        )

    @property
    def model_port(self) -> int:
        """Model-broadcast port = learner_port + 1."""
        return self.learner_port + 1

    @property
    def inference_port(self) -> int:
        """Centralized-inference ROUTER port = learner_port + 2."""
        return self.learner_port + 2

    def inference_ports(self, cfg: Config) -> list[int]:
        """Collision-checked ports of the inference replicas:
        ``inference_replicas`` consecutive ports from ``cfg.inference_base_port``
        (or ``learner_port + 2`` when unset)."""
        from tpu_rl_torch.runtime.portplan import plan_range, reserved_ports

        base = cfg.inference_base_port or self.inference_port
        return plan_range(
            base,
            cfg.inference_replicas,
            reserved_ports(self, cfg),
            "inference replica",
        )


def default_result_dirs(base: str = "results") -> tuple[str, str]:
    """Timestamped result/model dirs (reference ``utils/utils.py:79-81``)."""
    import datetime

    ts = datetime.datetime.now().strftime("%d%m%Y-%H_%M_%S")
    result_dir = os.path.join(base, ts)
    model_dir = os.path.join(result_dir, "models")
    return result_dir, model_dir
