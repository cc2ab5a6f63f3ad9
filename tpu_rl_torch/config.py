"""Typed configuration — the port's own copy of ``tpu_rl.config.Config``.

It holds the fields the serving, training and durability slices read, with
``tpu_rl``'s names and defaults, so an existing params file loads unchanged.
Keys the port does not know yet are kept in ``extra``: a full ``tpu_rl``
params file still loads. Those of them that would make ``tpu_rl`` do
something the port does not do yet (build a mesh, arm chaos, run replicas)
are refused at a value other than their default
(:data:`LATER_SLICES`), so that a run never silently does less than asked.
"""

from __future__ import annotations

import dataclasses
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
    ("mesh_data", lambda v: v > 1, "multi-GPU slice"),
    ("mesh_seq", lambda v: v > 1, "multi-GPU slice"),
    ("multihost", lambda v: v is not None, "multi-GPU slice"),
    ("chaos_spec", lambda v: v is not None, "fleet and operations slice"),
    ("inference_replicas", lambda v: v > 1, "fleet slice"),
    ("inference_mesh_data", lambda v: v > 1, "fleet slice"),
)


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
    # (tiles with the online softmax) or "flash" (kernel B4). tpu_rl's
    # "ring" and "ulysses" come later.
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
    # runtime-derived (filled by the runner, not the JSON)
    obs_shape: tuple[int, ...] = (4,)
    action_space: int = 2
    is_continuous: bool = False
    # Keys of a tpu_rl params file this port does not read yet.
    extra: dict[str, Any] = field(default_factory=dict, compare=False, repr=False)

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
                raise NotImplementedError(
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
        assert self.loss_log_interval >= 1, self.loss_log_interval
        if self.slo_spec:
            # a typo'd rule dies at load, not silently mid-run
            from tpu_rl_torch.obs.slo import parse_slo_spec

            parse_slo_spec(self.slo_spec)
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
        assert self.action_repeat >= 1, self.action_repeat
        assert self.compute_dtype in (
            "float32",
            "bfloat16",
        ), f"compute_dtype must be float32 or bfloat16, got {self.compute_dtype!r}"
        assert self.model in ("lstm", "transformer"), self.model
        assert self.attention_impl in ("full", "blockwise", "flash", "ring", "ulysses")
        if self.attention_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention_impl={self.attention_impl!r}: ring and Ulysses attention "
                "on torch.distributed come with the multi-GPU sequence-parallel slice "
                "of the port"
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
