"""Core data types — the port of ``tpu_rl.types``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import torch

from tpu_rl_torch import resolve_device

# The eight per-step fields of a training batch, in canonical order.
BATCH_FIELDS = ("obs", "act", "rew", "logits", "log_prob", "is_fir", "hx", "cx")


def field_widths(
    obs_dim: int,
    action_space: int,
    hidden: int,
    continuous: bool,
    hx_width: int | None = None,
    cx_width: int | None = None,
) -> dict[str, int]:
    """Feature width of every batch field. Discrete actions and log-probs are
    width-1 float columns; ``hx_width``/``cx_width`` override the LSTM
    carry width."""
    wide = action_space if continuous else 1
    return dict(
        obs=obs_dim,
        act=wide,
        rew=1,
        logits=action_space,
        log_prob=wide,
        is_fir=1,
        hx=hidden if hx_width is None else hx_width,
        cx=hidden if cx_width is None else cx_width,
    )


@dataclass
class Batch:
    """A training batch of fixed-length trajectory windows, batch-major
    ``(B, S, w)`` float32 tensors.

    obs      : (B, S, *obs_shape)
    act      : (B, S, 1) discrete action index as float
    rew      : (B, S, 1) scaled reward
    logits   : (B, S, A) behaviour-policy log-softmax logits
    log_prob : (B, S, 1) behaviour log-prob
    is_fir   : (B, S, 1) 1.0 at episode-first steps
    hx, cx   : (B, S, H) pre-step LSTM states; training uses [:, 0]
               ((B, S, 1) zero placeholders for the transformer)
    """

    obs: torch.Tensor
    act: torch.Tensor
    rew: torch.Tensor
    logits: torch.Tensor
    log_prob: torch.Tensor
    is_fir: torch.Tensor
    hx: torch.Tensor
    cx: torch.Tensor

    @classmethod
    def from_mapping(
        cls, m: Mapping[str, Any], device: str | torch.device = "cuda"
    ) -> "Batch":
        """Float32 copies of ``m``'s fields (numpy arrays or tensors) on
        ``device``: the card unless the caller passes ``device="cpu"``, as
        ``tpu_rl``'s ``jnp.asarray`` puts a batch on the accelerator."""
        dev = resolve_device(device)
        return cls(**{
            k: torch.as_tensor(m[k]).to(device=dev, dtype=torch.float32, copy=True)
            for k in BATCH_FIELDS
        })
