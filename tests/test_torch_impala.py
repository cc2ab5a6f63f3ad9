"""IMPALA in the port against ``tpu_rl`` on the CPU: V-trace (with and
without ``value_target_clip``), ``polyak_update``, and one whole IMPALA
train step from one bridged state (``tpu_rl``'s LSTM unroll through its
Pallas kernels in interpret mode, the port's through the plain versions).
Tolerances: V-trace 1e-6 absolute (``tests/test_returns.py``); the train
step's loss rtol 1e-5, every other metric, params and RMSprop nu 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ppo import (
    _assert_metrics_close,
    _assert_states_close,
    _close,
    _jax_step,
    setup_algo_step,
)
from tpu_rl.ops.returns import vtrace as jax_vtrace
from tpu_rl.ops.target import polyak_update as jax_polyak
from tpu_rl_torch.ops.returns import vtrace
from tpu_rl_torch.ops.target import polyak_update


def _vtrace_inputs(B, S, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: (scale * rng.normal(size=shape)).astype(np.float32)  # noqa: E731
    is_fir = (rng.random((B, S, 1)) < 0.25).astype(np.float32)
    return dict(
        behav_log_probs=f(B, S, 1, scale=0.5) - 0.7,
        target_log_probs=f(B, S, 1, scale=0.5) - 0.7,
        is_fir=is_fir,
        rewards=f(B, S, 1),
        values=f(B, S, 1, scale=3.0),
    )


@pytest.mark.parametrize("shape", [(8, 5), (3, 16), (16, 2)])
@pytest.mark.parametrize("clip", [None, (-1.0, 2.5), (0.0, None)], ids=["none", "both", "lo"])
@pytest.mark.parametrize("rho", [(0.8, 0.1, 1.0), (1.0, 0.5, 0.9)], ids=["reference", "wide"])
def test_vtrace_matches(shape, clip, rho):
    x = _vtrace_inputs(*shape, seed=sum(shape))
    v_min, v_max = clip or (None, None)
    rho_bar, rho_min, c_bar = rho
    kw = dict(gamma=0.99, rho_bar=rho_bar, rho_min=rho_min, c_bar=c_bar, v_min=v_min, v_max=v_max)
    want = jax_vtrace(**{k: jnp.asarray(v) for k, v in x.items()}, **kw)
    got = vtrace(**{k: torch.from_numpy(v) for k, v in x.items()}, **kw)
    for g, w, what in zip(got, want, ("rho", "advantages", "values_target"), strict=True):
        assert tuple(g.shape) == w.shape, what
        _close(g, w, what, atol=1e-6)
    if clip is not None:  # the clamp reached the targets
        vt = got[2].numpy()
        assert vt.min() >= (v_min if v_min is not None else -np.inf)
        assert vt.max() <= (v_max if v_max is not None else np.inf)


def test_polyak_update_matches_and_never_aliases():
    rng = np.random.default_rng(5)
    src = {"q1.w": rng.normal(size=(4, 3)).astype(np.float32), "q2.b": rng.normal(size=3).astype(np.float32)}
    tgt = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in src.items()}
    want = jax_polyak({k: jnp.asarray(v) for k, v in src.items()},
                      {k: jnp.asarray(v) for k, v in tgt.items()}, 0.05)
    s = {k: torch.from_numpy(v) for k, v in src.items()}
    t = {k: torch.from_numpy(v.copy()) for k, v in tgt.items()}
    got = polyak_update(s, t, 0.05)
    for k in src:
        _close(got[k], want[k], k, atol=1e-7)
        assert got[k].data_ptr() not in (s[k].data_ptr(), t[k].data_ptr())
        np.testing.assert_array_equal(t[k].numpy(), tgt[k])  # the old target is untouched
    # tau = 1 copies the source into a new tensor
    one = polyak_update(s, t, 1.0)
    for k in src:
        np.testing.assert_array_equal(one[k].numpy(), src[k])


@pytest.mark.parametrize("k_epoch", [1, 2])
@pytest.mark.parametrize("clip", [None, [0.0, 0.05]], ids=["noclip", "value_target_clip"])
def test_train_step_matches_tpu_rl(k_epoch, clip):
    """One IMPALA train step (B8 S5 H16, learn_diag on): loss, every metric
    incl. the saturation ones and the diag rows (the unclipped ratio's
    ``rho-clip``/``c-clip``) and scalars, params and RMSprop nu."""
    jstate, jstep, jbatch, state, step, batch = setup_algo_step(
        "IMPALA", k_epoch, value_target_clip=clip
    )
    jnew, jmetrics = _jax_step(jstep, jstate, jbatch)
    new, metrics = step(state, batch)
    _assert_metrics_close(metrics, jax.device_get(jmetrics))
    _assert_states_close(new, jax.device_get(jnew))
    assert float(metrics["nonfinite-updates"]) == 0.0
    for k in ("max-abs-logit", "mean-value", "max-abs-advantage", "mean-advantage"):
        assert k in metrics
    assert {"rho-clip", "c-clip"} <= set(metrics["diag"]["rows"])


def test_nonfinite_update_is_skipped_like_tpu_rl():
    """A NaN reward makes the V-trace targets and the loss NaN: params and
    nu stay, ``nonfinite-updates`` counts 1, in both packages."""
    def corrupt(b):
        b["rew"][1, 2, 0] = np.nan

    jstate, jstep, jbatch, state, step, batch = setup_algo_step("IMPALA", 1, corrupt)
    jnew, jmetrics = _jax_step(jstep, jstate, jbatch)
    new, metrics = step(state, batch)
    assert float(metrics["nonfinite-updates"]) == float(jmetrics["nonfinite-updates"]) == 1.0
    assert not np.isfinite(float(metrics["loss"]))
    for name, t in state.params["actor"].items():
        torch.testing.assert_close(new.params["actor"][name], t, rtol=0, atol=0)
    _assert_states_close(new, jax.device_get(jnew))
