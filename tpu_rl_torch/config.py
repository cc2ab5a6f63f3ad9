"""Typed configuration — the port's own copy of ``tpu_rl.config.Config``.

It holds the fields the serving and training slices read, with ``tpu_rl``'s
names and defaults, so an existing params file loads unchanged. Keys the
port does not know yet are kept in ``extra`` and otherwise ignored: a full
``tpu_rl`` params file still loads.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Config:
    # experiment
    env: str = "CartPole-v1"
    algo: str = "PPO"
    # model
    hidden_size: int = 64
    # Policy backbone: "lstm" or "transformer" (on-policy algos only).
    model: str = "lstm"
    n_heads: int = 4
    n_layers: int = 2
    # Attention of the transformer: "full" (materialized scores) or "flash"
    # (kernel B4). tpu_rl's "blockwise", "ring" and "ulysses" come later.
    attention_impl: str = "full"
    # Acting context (KV-cache length) of the transformer; 0 = seq_len.
    act_ctx: int = 0
    seq_len: int = 5
    # Reset the LSTM carry at in-sequence episode seams (tpu_rl default).
    reset_carry_on_first: bool = True
    # Compute dtype of the train step ("float32" or "bfloat16"; bfloat16 for
    # the transformer only in this port so far).
    compute_dtype: str = "float32"
    # Number of envs one worker steps per tick (one batched act per tick).
    worker_num_envs: int = 1
    # Dynamic-batch flush knobs of the inference service: a batch is
    # dispatched when `inference_batch` rows are pending OR the oldest
    # pending request is `inference_flush_us` microseconds old.
    inference_batch: int = 64
    inference_flush_us: int = 1000
    # Serving precision of the actor params ("f32" only in this port so far).
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
        if isinstance(kwargs.get("obs_shape"), list):
            kwargs["obs_shape"] = tuple(kwargs["obs_shape"])
        cfg = cls(**kwargs, extra={k: v for k, v in raw.items() if k not in names})
        cfg.validate()
        return cfg

    def validate(self) -> None:
        assert self.seq_len >= 2, "seq_len must be >= 2 (losses bootstrap from t+1)"
        assert self.batch_size >= 1
        assert self.buffer_size >= self.batch_size
        assert 0.0 <= self.gamma <= 1.0
        assert 0.0 <= self.lmbda <= 1.0
        assert self.hidden_size >= 1, self.hidden_size
        assert self.n_heads >= 1 and self.n_layers >= 1, (self.n_heads, self.n_layers)
        assert self.act_ctx >= 0, self.act_ctx
        assert self.time_horizon >= 1, self.time_horizon
        assert self.reward_scale != 0.0, "reward_scale 0 zeroes every reward"
        assert self.eps_clip > 0, self.eps_clip
        assert self.K_epoch >= 1, self.K_epoch
        assert self.lr > 0, self.lr
        assert self.max_grad_norm > 0, self.max_grad_norm
        assert self.loss_log_interval >= 1, self.loss_log_interval
        assert self.env_mode in ("distributed", "colocated"), self.env_mode
        assert self.colocated_envs >= 0, self.colocated_envs
        assert self.compute_dtype in (
            "float32",
            "bfloat16",
        ), f"compute_dtype must be float32 or bfloat16, got {self.compute_dtype!r}"
        assert self.model in ("lstm", "transformer"), self.model
        assert self.attention_impl in ("full", "blockwise", "flash", "ring", "ulysses")
        if self.attention_impl == "blockwise":
            raise NotImplementedError(
                "attention_impl='blockwise': blockwise attention comes with the "
                "blockwise-attention slice of the port"
            )
        if self.attention_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention_impl={self.attention_impl!r}: ring and Ulysses attention "
                "on torch.distributed come with the multi-GPU sequence-parallel slice "
                "of the port"
            )
        if self.model == "transformer":
            assert self.algo not in ("SAC", "SAC-Continuous"), (
                "transformer backbone supports the on-policy algorithms"
            )
        assert self.worker_num_envs >= 1, self.worker_num_envs
        assert self.inference_batch >= 1, self.inference_batch
        assert self.inference_flush_us >= 0, self.inference_flush_us
        assert self.inference_dtype in ("f32", "bf16", "int8"), self.inference_dtype
        assert self.inference_buckets >= 0, self.inference_buckets
        assert self.act_kernel in ("xla", "pallas"), self.act_kernel
        if self.inference_dtype != "f32":
            raise NotImplementedError(
                f"inference_dtype={self.inference_dtype!r}: bf16/int8 serving "
                "(models/quant.py) comes with the quantized-serving slice of "
                "the port; this slice serves f32 only"
            )

    @property
    def effective_act_ctx(self) -> int:
        return self.act_ctx or self.seq_len

    def replace(self, **kw: Any) -> "Config":
        new = dataclasses.replace(self, **kw)
        new.validate()
        return new
