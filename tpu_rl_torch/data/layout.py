"""Canonical per-step field layout of a trajectory batch — the port of
``tpu_rl.data.layout``.

One place that knows the feature width of every ``BATCH_FIELDS`` entry,
derived from the config, shared by the assembler, the shared-memory stores
and the learner's sampler.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpu_rl_torch.config import Config
from tpu_rl_torch.types import BATCH_FIELDS


@dataclass(frozen=True)
class BatchLayout:
    """Feature width per field for one (obs/action-space, algo) combination.

    All fields are float32 and shaped ``(seq, width)`` per trajectory —
    including discrete actions, stored as a float index in a width-1 column.
    """

    obs: int
    act: int
    rew: int
    logits: int
    log_prob: int
    is_fir: int
    hx: int
    cx: int
    seq_len: int

    @classmethod
    def from_config(cls, cfg: Config) -> "BatchLayout":
        from tpu_rl_torch.types import field_widths

        obs_dim = int(np.prod(cfg.obs_shape))
        hx_w = cx_w = None
        if cfg.model == "transformer":
            # Transformer training ignores the carry, so the batch stores
            # 1-float placeholders (ModelFamily.stored_carry_widths).
            hx_w, cx_w = 1, 1
        widths = field_widths(
            obs_dim,
            int(cfg.action_space),
            cfg.hidden_size,
            cfg.is_continuous,
            hx_width=hx_w,
            cx_width=cx_w,
        )
        return cls(seq_len=cfg.seq_len, **widths)

    def width(self, field: str) -> int:
        return getattr(self, field)

    @property
    def fields(self) -> tuple[str, ...]:
        return BATCH_FIELDS

    @property
    def step_floats(self) -> int:
        """Total float32 count of one env step across all fields."""
        return sum(self.width(f) for f in BATCH_FIELDS)

    @property
    def traj_floats(self) -> int:
        """Total float32 count of one seq_len trajectory across all fields."""
        return self.seq_len * self.step_floats

    def validate_step(self, step: dict) -> None:
        """Assert a worker step dict matches this layout (shape errors fail
        here, at the producer, instead of corrupting the shm ring)."""
        for f in BATCH_FIELDS:
            arr = np.asarray(step[f])
            if arr.shape != (self.width(f),):
                raise ValueError(
                    f"step field {f!r}: expected shape ({self.width(f)},), "
                    f"got {arr.shape}"
                )

    def validate_tick(self, payload: dict, n_envs: int) -> None:
        """Assert a whole-tick RolloutBatch payload matches this layout:
        every batch field ``(n_envs, width)`` — the columnar counterpart of
        :meth:`validate_step` for ``RolloutAssembler.push_tick``."""
        for f in BATCH_FIELDS:
            arr = np.asarray(payload[f])
            if arr.shape != (n_envs, self.width(f)):
                raise ValueError(
                    f"tick field {f!r}: expected shape "
                    f"({n_envs}, {self.width(f)}), got {arr.shape}"
                )
        done = np.asarray(payload["done"])
        if done.shape != (n_envs,):
            raise ValueError(
                f"tick done: expected shape ({n_envs},), got {done.shape}"
            )
