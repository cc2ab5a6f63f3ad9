"""V-MPO in the port against ``tpu_rl`` on the CPU: ``top_half_mask``
(exact ties keep more than k, as ``tpu_rl`` does), and one whole V-MPO
train step from one bridged state, with ``tpu_rl``'s per-epoch KL-bound
draws passed to the port (``coef_alpha_u``: threefry and Philox cannot
match). Tolerances: loss rtol 1e-5; every other metric, params, the duals
and RMSprop nu 1e-5."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ppo import (
    _assert_metrics_close,
    _assert_states_close,
    _jax_step,
    setup_algo_step,
)
from tpu_rl.algos.vmpo import top_half_mask as jax_top_half_mask
from tpu_rl_torch.algos.vmpo import top_half_mask

KEY = 7


def _draws(k_epoch: int) -> torch.Tensor:
    """The unit uniforms behind tpu_rl's per-epoch KL bound:
    ``uniform(fold_in(key, e), (), minval, maxval)`` scales the same draw."""
    key = jax.random.key(KEY)
    return torch.tensor([float(jax.random.uniform(jax.random.fold_in(key, e), ()))
                         for e in range(k_epoch)], dtype=torch.float32)


def _both_steps(k_epoch, corrupt=None, **kw):
    jstate, jstep, jbatch, state, step, batch = setup_algo_step("V-MPO", k_epoch, corrupt, **kw)
    jnew, jmetrics = _jax_step(jstep, jstate, jbatch, jax.random.key(KEY))
    new, metrics = step(state, batch, coef_alpha_u=_draws(k_epoch))
    return state, new, metrics, jax.device_get(jnew), jax.device_get(jmetrics)


def test_top_half_mask_matches_and_keeps_ties():
    rng = np.random.default_rng(0)
    adv = rng.normal(size=(9, 6, 1)).astype(np.float32)
    for k in (1, 5, 9):
        got = top_half_mask(torch.from_numpy(adv), k).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_top_half_mask(jnp.asarray(adv), k)))
        assert (got.sum(axis=0) == k).all()
    # exact ties at the k-th value: every tied entry is kept, more than k
    tied = np.array([3.0, 1.0, 1.0, 1.0, 0.5, -2.0], np.float32).reshape(6, 1, 1)
    got = top_half_mask(torch.from_numpy(tied), 3).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_top_half_mask(jnp.asarray(tied), 3)))
    assert got.sum() == 4 > 3
    np.testing.assert_array_equal(got[:, 0, 0], [1, 1, 1, 1, 0, 0])


@pytest.mark.parametrize("k_epoch", [1, 2])
def test_train_step_matches_tpu_rl(k_epoch):
    """One V-MPO train step (B8 S5 H16, learn_diag on): loss and its four
    parts, eta, alpha and the KL, the diag rows and scalars, the actor's
    params, the duals ``log_eta``/``log_alpha`` and RMSprop nu of both."""
    state, new, metrics, jnew, jmetrics = _both_steps(k_epoch)
    _assert_metrics_close(metrics, jmetrics)
    _assert_states_close(new, jnew)
    assert float(metrics["nonfinite-updates"]) == 0.0
    for k in ("log_eta", "log_alpha"):  # the duals moved, each on its own
        assert float(new.params["duals"][k]) != float(state.params["duals"][k])
    assert {"eta", "vmpo-alpha"} <= set(metrics["diag"]["scalars"])


def test_eta_floor_projected_like_tpu_rl():
    """From ``log_eta`` at the floor (advantages / eta in the thousands) the
    temperature's gradient pushes it below: both packages project it back
    to ``log 1e-6``."""
    jstate, jstep, jbatch, state, step, batch = setup_algo_step("V-MPO", 2)
    floor = np.float32(np.log(np.float32(1e-6)))
    jstate = jstate.replace(params={**jstate.params, "log_eta": np.asarray(floor)})
    state.params["duals"]["log_eta"] = torch.tensor(floor)
    jnew, jmetrics = _jax_step(jstep, jstate, jbatch, jax.random.key(KEY))
    new, metrics = step(state, batch, coef_alpha_u=_draws(2))
    _assert_metrics_close(metrics, jax.device_get(jmetrics))
    _assert_states_close(new, jax.device_get(jnew))
    assert float(new.params["duals"]["log_eta"]) == float(floor)


def test_nonfinite_update_is_skipped_like_tpu_rl():
    """A NaN observation makes the loss NaN: the actor, both duals and nu
    stay (the floor is not applied to a skipped update), and
    ``nonfinite-updates`` counts 1, in both packages."""
    def corrupt(b):
        b["obs"][2, 1, 0] = np.nan

    state, new, metrics, jnew, jmetrics = _both_steps(1, corrupt)
    assert float(metrics["nonfinite-updates"]) == float(jmetrics["nonfinite-updates"]) == 1.0
    for group in ("actor", "duals"):
        for name, t in state.params[group].items():
            torch.testing.assert_close(new.params[group][name], t, rtol=0, atol=0)
    _assert_states_close(new, jnew)


def test_kl_bound_is_drawn_per_epoch_from_the_generator():
    """Without ``coef_alpha_u`` the draws come from ``generator``: the same
    seed gives the same step, and the bound lies in
    [coef_alpha_below, coef_alpha_upper]."""
    from tpu_rl_torch.algos.vmpo import log_uniform

    _js, _jst, _jb, state, step, batch = setup_algo_step("V-MPO", 2)
    a = step(state, batch, torch.Generator().manual_seed(3))[1]
    b = step(state, batch, torch.Generator().manual_seed(3))[1]
    assert float(a["loss"]) == float(b["loss"])
    u = torch.tensor([0.0, 0.5, 0.9999999])
    bound = log_uniform(u, 0.005, 0.01)
    assert float(bound.min()) >= 0.005 * (1 - 1e-6) and float(bound.max()) <= 0.01 * (1 + 1e-6)
    np.testing.assert_allclose(float(bound[1]), math.sqrt(0.005 * 0.01), rtol=1e-6)
