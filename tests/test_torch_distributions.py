"""The port's distribution math against tpu_rl.ops.distributions on the same
numpy inputs, atol 1e-6. Sampling is compared through shared noise: the
Gumbel / normal draws JAX makes from a key are handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_rl.ops import distributions as JD
from tpu_rl_torch.ops import distributions as TD

ATOL = 1e-6


@pytest.fixture
def logits_pair(rng):
    a = rng.normal(size=(16, 5)).astype(np.float32)
    b = rng.normal(size=(16, 5)).astype(np.float32)
    return a, b


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("normalized", [False, True])
def test_categorical_sample_shared_gumbel(logits_pair, normalized):
    logits = logits_pair[0]
    if normalized:
        logits = np.array(jax.nn.log_softmax(logits, axis=-1))
    for seed in range(5):
        key = jax.random.key(seed)
        want = JD.categorical_sample(key, jnp.asarray(logits))
        g = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
        got = TD.categorical_sample(torch.from_numpy(logits), gumbel=torch.from_numpy(g))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_categorical_sample_own_noise_is_a_gumbel_max():
    logits = torch.log(torch.tensor([[0.7, 0.2, 0.1]])).expand(20000, 3).contiguous()
    gen = torch.Generator().manual_seed(0)
    a = TD.categorical_sample(logits, gen)
    freq = torch.bincount(a, minlength=3).float() / a.numel()
    np.testing.assert_allclose(freq.numpy(), [0.7, 0.2, 0.1], atol=0.015)


def test_categorical_log_prob_entropy_kl(logits_pair, rng):
    a, b = logits_pair
    actions = rng.integers(0, a.shape[1], size=a.shape[0])
    _close(
        TD.categorical_log_prob(torch.from_numpy(a), torch.from_numpy(actions)),
        JD.categorical_log_prob(jnp.asarray(a), jnp.asarray(actions)),
    )
    _close(TD.categorical_entropy(torch.from_numpy(a)), JD.categorical_entropy(jnp.asarray(a)))
    _close(
        TD.categorical_kl(torch.from_numpy(a), torch.from_numpy(b)),
        JD.categorical_kl(jnp.asarray(a), jnp.asarray(b)),
    )


def test_normal_family(rng):
    mu = rng.normal(size=(8, 3)).astype(np.float32)
    std = rng.uniform(0.2, 2.0, size=(8, 3)).astype(np.float32)
    x = rng.normal(size=(8, 3)).astype(np.float32)
    t = [torch.from_numpy(v) for v in (mu, std, x)]
    _close(TD.normal_log_prob(*t), JD.normal_log_prob(mu, std, x))
    _close(TD.normal_entropy(t[1]), JD.normal_entropy(std))
    key = jax.random.key(4)
    noise = np.array(jax.random.normal(key, mu.shape, jnp.float32))
    _close(
        TD.normal_sample(t[0], t[1], noise=torch.from_numpy(noise)),
        JD.normal_sample(key, mu, std),
    )
    a_t, lp_t = TD.tanh_normal_sample(t[0], t[1], noise=torch.from_numpy(noise))
    a_j, lp_j = JD.tanh_normal_sample(key, mu, std)
    _close(a_t, a_j)
    # The squash correction log(1 - tanh(x)^2 + 1e-7) turns a one-ulp
    # difference between the two frameworks' tanh into a relative error of
    # ~1e-4 where |x| > 3 (1 - a^2 ~ 1e-4 there), so it is held relatively.
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-4, atol=ATOL)
