"""The port's colocated loop (``tpu_rl_torch.runtime.colocated``) on the
CPU: a short run returns ``tpu_rl``'s summary keys with finite values, the
rollout keeps the worker's tick semantics, and one ``program`` step fed
``tpu_rl``'s params and rollout batch matches ``tpu_rl``'s standalone train
step (as ``tests/test_colocated.py`` pins the fused update in ``tpu_rl``),
at the train-step tolerances of ``tests/test_torch_ppo.py``."""

import math

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_bridge import with_random_biases
from tests.test_torch_ppo import _assert_metrics_close, _assert_states_close
from tpu_rl.config import Config as JaxConfig
from tpu_rl.models import cells as jax_cells
from tpu_rl.runtime.colocated import ColocatedLoop as JaxColocatedLoop
from tpu_rl.runtime.colocated import act_params as jax_act_params
from tpu_rl.runtime.colocated import resolve_colocated_config as jax_resolve
from tpu_rl.types import BATCH_FIELDS
from tpu_rl_torch.bridge import train_state_from_flax
from tpu_rl_torch.config import Config
from tpu_rl_torch.runtime.colocated import ColocatedLoop, resolve_colocated_config
from tpu_rl_torch.types import Batch

SUMMARY_KEYS = (
    "updates", "env_steps", "episodes", "mean_return_overall", "mean_return_recent",
    "mean_return_best_window", "elapsed_s", "transitions_per_s",
)


def _kw(**kw):
    base = dict(
        env="CartPole-v1", env_mode="colocated", algo="PPO", batch_size=8, buffer_size=8,
        seq_len=5, hidden_size=16, time_horizon=100, loss_log_interval=10**9,
    )
    base.update(kw)
    return base


def test_cpu_run_returns_finite_summary():
    loop = ColocatedLoop(Config(**_kw(loss_log_interval=1, time_horizon=3)), seed=0,
                         max_updates=3, device="cpu")
    out = loop.run(log=False)
    assert out["updates"] == 3
    assert out["env_steps"] == 3 * 8 * 5
    assert out["episodes"] > 0  # horizon 3 inside 15 ticks: every env ends episodes
    for k in SUMMARY_KEYS:
        assert math.isfinite(out[k]), (k, out[k])
    assert out["transitions_per_s"] > 0
    assert "colocated-iteration-elapsed-mean-sec" in out["scalars"]
    assert int(loop.state.step) == 3


def test_rollout_window_tick_semantics():
    """is_fir=1 on every env's first row and on every post-done row; the
    stored carry is the pre-step carry (zeros on a fresh episode's first
    row); the reward carries reward_scale."""
    loop = ColocatedLoop(Config(**_kw(batch_size=2, time_horizon=3)), device="cpu")
    carry = loop.init_carry(torch.Generator().manual_seed(0))
    params = {"actor": loop.state.params["actor"]}
    _carry, batch, done, ep_ret = loop.rollout(params, carry, torch.Generator().manual_seed(1))
    is_fir = batch.is_fir[..., 0].numpy()
    assert np.all(is_fir[:, 0] == 1.0)
    np.testing.assert_array_equal(is_fir[:, 1:], done[:, :-1].numpy().astype(np.float32))
    assert done[:, 2].all()  # horizon 3: done at t=2
    np.testing.assert_array_equal(batch.hx[:, 0].numpy(), 0.0)
    np.testing.assert_array_equal(batch.cx[:, 0].numpy(), 0.0)
    np.testing.assert_allclose(batch.rew.numpy(), loop.cfg.reward_scale)
    np.testing.assert_array_equal(ep_ret[:, 2].numpy(), 3.0)  # raw return of a 3-step episode
    for f in BATCH_FIELDS:
        assert getattr(batch, f).shape[:2] == (2, 5), f


def test_resolve_colocated_config_matches():
    kw = _kw(colocated_envs=16)
    got = resolve_colocated_config(Config(**kw))
    want = jax_resolve(JaxConfig(**kw))
    for k in ("batch_size", "buffer_size", "obs_shape", "action_space", "is_continuous"):
        assert getattr(got, k) == getattr(want, k), k
    with pytest.raises(ValueError, match="env_mode='colocated'"):
        ColocatedLoop(Config(**_kw(env_mode="distributed")), device="cpu")


def test_program_step_matches_tpu_rl_standalone_train_step(monkeypatch):
    """tpu_rl's colocated rollout gives one batch; tpu_rl's standalone train
    step on it is the reference. The port's ``program``, from the same
    (bridged) train state and fed that same rollout, must match it in loss,
    metrics, params and nu, and count the rollout's episodes."""
    jloop = JaxColocatedLoop(JaxConfig(**_kw(time_horizon=4)))
    jstate = jloop.state.replace(params={"actor": with_random_biases(jloop.state.params["actor"], 5)})
    k_roll, k_train = jax.random.split(jax.random.PRNGKey(42))
    jcarry = jloop.init_carry(jax.random.PRNGKey(7))
    _c, jbatch, jdone, jret = jloop.rollout(jax_act_params(jstate), jcarry, k_roll)
    jax_cells.set_pallas_mode("interpret")
    try:
        jnew, jmetrics = jax.jit(jloop._train_step)(jstate, jbatch, k_train)
    finally:
        jax_cells.set_pallas_mode("auto")

    loop = ColocatedLoop(Config(**_kw(time_horizon=4)), device="cpu")
    state = train_state_from_flax(jax.device_get(jstate))
    batch = Batch.from_mapping({f: np.array(getattr(jbatch, f)) for f in BATCH_FIELDS}, device="cpu")
    done = torch.from_numpy(np.array(jdone))
    ep_ret = torch.from_numpy(np.array(jret))
    monkeypatch.setattr(loop, "rollout", lambda params, carry, generator=None: (carry, batch, done, ep_ret))
    new, _carry, stats, metrics = loop.program(state, loop.init_carry(), loop.init_stats())
    _assert_metrics_close(metrics, jax.device_get(jmetrics))
    _assert_states_close(new, jax.device_get(jnew))
    assert int(stats["episodes"]) == int(np.asarray(jdone).sum()) > 0
    np.testing.assert_allclose(float(stats["ret_sum"]), float(np.asarray(jret).sum()), rtol=1e-6)
