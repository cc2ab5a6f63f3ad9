"""Distribution math as plain functions on tensors, with explicit generators —
the port of ``tpu_rl.ops.distributions``. Conventions kept:

- "logits" stored in trajectories are **log-softmax** values;
- Normal log-probs are **per dimension** (not summed);
- the tanh-squash correction is ``log(1 - tanh(x)^2 + 1e-7)`` per dimension.

Sampling takes an optional ``torch.Generator``; the noise can also be handed
in (``gumbel=`` / ``noise=``) so that a test can feed this module and the JAX
one the same draws: JAX's threefry and torch's Philox give different bits
from the same seed.
"""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------- categorical
def gumbel_noise(
    shape: tuple[int, ...], like: torch.Tensor, generator: torch.Generator | None = None
) -> torch.Tensor:
    """Standard Gumbel draws, ``-log(E)`` with ``E ~ Exp(1)``."""
    e = torch.empty(shape, dtype=like.dtype, device=like.device)
    return -torch.log(e.exponential_(generator=generator))


def categorical_sample(
    logits: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    gumbel: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sample action indices from (unnormalized or log-softmax) logits by
    Gumbel-max, ``argmax(logits + g)`` — what ``jax.random.categorical``
    does."""
    if gumbel is None:
        gumbel = gumbel_noise(logits.shape, logits, generator)
    return torch.argmax(logits + gumbel, dim=-1)


def categorical_log_prob(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """log pi(a) for integer ``actions`` (...,) given logits (..., A)."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, actions.long()[..., None])[..., 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def categorical_kl(logits_p: torch.Tensor, logits_q: torch.Tensor) -> torch.Tensor:
    """KL(p || q) over the last axis."""
    logp = torch.log_softmax(logits_p, dim=-1)
    logq = torch.log_softmax(logits_q, dim=-1)
    return torch.sum(torch.exp(logp) * (logp - logq), dim=-1)


# ------------------------------------------------------------------- gaussian
def normal_sample(
    mu: torch.Tensor,
    std: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    if noise is None:
        noise = torch.empty_like(mu).normal_(generator=generator)
    return mu + std * noise


def normal_log_prob(mu: torch.Tensor, std: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-dimension Normal log-density."""
    return -0.5 * (torch.square(x - mu) / (std * std) + 2.0 * torch.log(std) + _LOG_2PI)


def normal_entropy(std: torch.Tensor) -> torch.Tensor:
    """Per-dimension Normal entropy."""
    return 0.5 * (1.0 + _LOG_2PI) + torch.log(std)


# ---------------------------------------------------------------- tanh-normal
def tanh_normal_sample(
    mu: torch.Tensor,
    std: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    noise: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reparameterized tanh-squashed Gaussian sample and per-dim log-prob:
    ``a = tanh(x), x ~ N(mu, std)``;
    ``log_prob = logN(x) - log(1 - a^2 + 1e-7)``."""
    x = normal_sample(mu, std, generator, noise=noise)
    action = torch.tanh(x)
    log_prob = normal_log_prob(mu, std, x) - torch.log(1.0 - torch.square(action) + 1e-7)
    return action, log_prob
