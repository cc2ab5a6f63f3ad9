"""The port's device envs (``tpu_rl_torch.envs``) against ``tpu_rl.envs`` on
the CPU: CartPole's and Pendulum's steps state for state over seeded action
sequences (atol 1e-5, termination flags equal), and ``make_vec_env``'s auto-reset on
termination and at the horizon with the same ``done``, ``t`` and reward.
Reset draws come from different generators (threefry vs Philox/mt19937),
so reset states are injected from numpy on both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_rl.envs import CARTPOLE as JAX_CARTPOLE
from tpu_rl.envs import make_vec_env as jax_make_vec_env
from tpu_rl.envs import PENDULUM as JAX_PENDULUM
from tpu_rl.envs.cartpole import step as jax_step
from tpu_rl.envs.pendulum import step as jax_pendulum_step
from tpu_rl_torch.envs import CARTPOLE, PENDULUM, get_spec, make_vec_env
from tpu_rl_torch.envs.cartpole import step
from tpu_rl_torch.envs.pendulum import step as pendulum_step

ATOL = 1e-5


def test_cartpole_step_matches_state_for_state():
    rng = np.random.default_rng(0)
    n, steps = 16, 50
    s = rng.uniform(-0.05, 0.05, size=(n, 4)).astype(np.float32)
    actions = rng.integers(0, 2, size=(steps, n, 1)).astype(np.float32)
    v_step = jax.jit(jax.vmap(jax_step, in_axes=(0, 0, None)))
    js, ts = jnp.asarray(s), torch.from_numpy(s.copy())
    n_done = 0
    for t in range(steps):
        js, jobs, jrew, jdone = v_step(js, jnp.asarray(actions[t]), jax.random.key(0))
        ts, obs, rew, done = step(ts, torch.from_numpy(actions[t]))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0, err_msg=f"step {t}")
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        n_done += int(done.sum())
    assert n_done > 0  # the sequence reaches the termination thresholds


@pytest.mark.parametrize("horizon", [10, 500], ids=["truncates", "terminates"])
def test_vec_env_autoreset_matches(horizon):
    """Both vec envs from the same start states, with every reset giving
    the same injected state: equal done, t and reward at every step, and
    states that agree at 1e-5, through terminations and truncations."""
    rng = np.random.default_rng(1)
    n, steps = 8, 60
    start = rng.uniform(-0.05, 0.05, size=(n, 4)).astype(np.float32)
    fresh = np.array([0.01, -0.02, 0.03, -0.04], np.float32)
    actions = rng.integers(0, 2, size=(steps, n, 1)).astype(np.float32)

    jspec = dataclasses.replace(JAX_CARTPOLE, reset=lambda key: (jnp.asarray(fresh), jnp.asarray(fresh)))
    spec = dataclasses.replace(
        CARTPOLE,
        reset=lambda k, generator, device: (
            torch.from_numpy(np.tile(fresh, (k, 1))), torch.from_numpy(np.tile(fresh, (k, 1)))
        ),
    )
    _jr, jv_step = jax_make_vec_env(jspec, n, horizon)
    _r, v_step = make_vec_env(spec, n, horizon)
    jv_step = jax.jit(jv_step)
    jstate = {"phys": jnp.asarray(start), "t": jnp.zeros((n,), jnp.int32)}
    state = {"phys": torch.from_numpy(start.copy()), "t": torch.zeros((n,), dtype=torch.int32)}
    dones = 0
    for t in range(steps):
        jstate, jobs, jrew, jdone = jv_step(jstate, jnp.asarray(actions[t]), jax.random.key(t))
        state, obs, rew, done = v_step(state, torch.from_numpy(actions[t]), None)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone), err_msg=f"done at {t}")
        np.testing.assert_array_equal(state["t"].numpy(), np.asarray(jstate["t"]), err_msg=f"t at {t}")
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_allclose(state["phys"].numpy(), np.asarray(jstate["phys"]), atol=ATOL, rtol=0)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=ATOL, rtol=0)
        dones += int(done.sum())
        if done.any():
            np.testing.assert_array_equal(obs.numpy()[done.numpy()], np.tile(fresh, (int(done.sum()), 1)))
    assert dones > 0
    if horizon == 10:
        assert int(state["t"].max()) < horizon


def test_reset_draws_from_the_generator():
    v_reset, _ = make_vec_env(CARTPOLE, 64, 500)
    s1, o1 = v_reset(torch.Generator().manual_seed(3), torch.device("cpu"))
    s2, _ = v_reset(torch.Generator().manual_seed(3), torch.device("cpu"))
    torch.testing.assert_close(s1["phys"], s2["phys"], rtol=0, atol=0)
    assert s1["phys"].shape == (64, 4) and s1["t"].dtype == torch.int32
    assert float(s1["phys"].abs().max()) <= 0.05 and float(s1["phys"].std()) > 0.01
    torch.testing.assert_close(o1, s1["phys"], rtol=0, atol=0)
    assert o1.data_ptr() != s1["phys"].data_ptr()


def test_spec_registry():
    """Both envs of tpu_rl's colocated mode are served (Pendulum since the
    continuous algorithms landed), with tpu_rl's spaces; others raise."""
    assert get_spec("CartPole-v1") is CARTPOLE
    assert (CARTPOLE.obs_shape, CARTPOLE.action_space) == (JAX_CARTPOLE.obs_shape, JAX_CARTPOLE.action_space)
    assert get_spec("Pendulum-v1") is PENDULUM
    assert (PENDULUM.obs_shape, PENDULUM.action_space, PENDULUM.is_continuous) == (
        JAX_PENDULUM.obs_shape, JAX_PENDULUM.action_space, JAX_PENDULUM.is_continuous)
    with pytest.raises(ValueError, match="no device dynamics"):
        get_spec("Acrobot-v1")


def test_pendulum_step_matches_state_for_state():
    """Pendulum under seeded torques beyond the clip, both sides stepped
    from the same state at every step (the pendulum spins, and f32 rounding
    of a growing angle would otherwise compound): the semi-implicit step,
    the torque and speed clips, the cost from the pre-step state (through
    ``_angle_normalize`` of angles past ±pi) and the observation, at 1e-5
    over 60 steps; it never terminates."""
    rng = np.random.default_rng(2)
    n, steps = 16, 60
    s = np.stack([rng.uniform(-3 * np.pi, 3 * np.pi, n), rng.uniform(-8, 8, n)], -1).astype(np.float32)
    actions = rng.normal(scale=3.0, size=(steps, n, 1)).astype(np.float32)
    v_step = jax.jit(jax.vmap(jax_pendulum_step, in_axes=(0, 0, None)))
    js, ts = jnp.asarray(s), torch.from_numpy(s.copy())
    for t in range(steps):
        js, jobs, jrew, jdone = v_step(js, jnp.asarray(actions[t]), jax.random.key(0))
        ts, obs, rew, done = pendulum_step(ts, torch.from_numpy(actions[t]))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0, err_msg=f"step {t}")
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=ATOL, rtol=0)
        np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        ts = torch.from_numpy(np.array(js))
    assert float(np.abs(ts[:, 1].numpy()).max()) <= 8.0


def test_pendulum_reset_draws_from_the_generator():
    v_reset, _ = make_vec_env(PENDULUM, 256, 200)
    s1, o1 = v_reset(torch.Generator().manual_seed(3), torch.device("cpu"))
    s2, _ = v_reset(torch.Generator().manual_seed(3), torch.device("cpu"))
    torch.testing.assert_close(s1["phys"], s2["phys"], rtol=0, atol=0)
    theta, theta_dot = s1["phys"].unbind(-1)
    assert float(theta.abs().max()) <= np.pi and float(theta.std()) > 1.0
    assert float(theta_dot.abs().max()) <= 1.0
    torch.testing.assert_close(o1, torch.stack([theta.cos(), theta.sin(), theta_dot], -1))
