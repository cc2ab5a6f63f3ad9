"""The port's gymnasium adapter against ``tpu_rl``'s on the CPU:
``probe_spaces`` (gymnasium and colocated), ``EnvAdapter`` obs, reward and
done sequences from one seed under a fixed action script at
``action_repeat`` 1 and 8, and ``_conv_preprocess`` on a seeded image, gray
and colour. Everything is held bit for bit (the same numpy arithmetic)."""

import numpy as np
import pytest

from tpu_rl.config import Config as JaxConfig
from tpu_rl.runtime.env import EnvAdapter as JaxEnvAdapter
from tpu_rl.runtime.env import probe_spaces as jax_probe_spaces
from tpu_rl_torch.config import Config
from tpu_rl_torch.runtime.env import EnvAdapter, probe_spaces

ENVS = ["CartPole-v1", "Pendulum-v1", "MountainCarContinuous-v0"]


def _spaces(cfg):
    return cfg.obs_shape, cfg.action_space, cfg.is_continuous


@pytest.mark.parametrize("env", ENVS)
def test_probe_spaces_matches(env):
    algo = "SAC" if env == "CartPole-v1" else "SAC-Continuous"
    got = probe_spaces(Config.from_dict({"env": env, "algo": algo}))
    want = jax_probe_spaces(JaxConfig.from_dict({"env": env, "algo": algo}))
    assert _spaces(got) == _spaces(want)
    assert isinstance(got.obs_shape, tuple) and isinstance(got.action_space, int)


@pytest.mark.parametrize("env", ["CartPole-v1", "Pendulum-v1"])
def test_probe_spaces_colocated_reads_the_device_spec(env):
    """Colocated mode reads the port's own device env spec (no gym.make)."""
    algo = "PPO" if env == "CartPole-v1" else "PPO-Continuous"
    raw = {"env": env, "algo": algo, "env_mode": "colocated"}
    assert _spaces(probe_spaces(Config.from_dict(raw))) == _spaces(
        jax_probe_spaces(JaxConfig.from_dict(raw)))


def test_probe_spaces_conv_shape_matches():
    """need_conv: the preprocessed (height x width x channels) flat width."""
    for gray in (False, True):
        raw = {"env": "CartPole-v1", "algo": "SAC", "need_conv": True, "height": 7,
               "width": 5, "is_gray": gray}
        got, want = probe_spaces(Config.from_dict(raw)), jax_probe_spaces(JaxConfig.from_dict(raw))
        assert _spaces(got) == _spaces(want) == ((35,), 2, False)


def _script(env, n, seed):
    """A fixed action script of policy-side float vectors."""
    rng = np.random.default_rng(seed)
    if env == "CartPole-v1":
        return [np.array([float(rng.integers(0, 2))], np.float32) for _ in range(n)]
    return [rng.uniform(-1.0, 1.0, size=(1,)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("repeat", [1, 8])
@pytest.mark.parametrize("env", ENVS)
def test_env_adapter_sequences_match(env, repeat):
    """Obs, reward and done from one seed under one action script, with
    resets at done and a seeded first reset, bit for bit."""
    algo = "SAC" if env == "CartPole-v1" else "SAC-Continuous"
    raw = {"env": env, "algo": algo, "action_repeat": repeat}
    ours = EnvAdapter(probe_spaces(Config.from_dict(raw)), seed=3)
    ref = JaxEnvAdapter(jax_probe_spaces(JaxConfig.from_dict(raw)), seed=3)
    o1, o2 = ours.reset(), ref.reset()
    np.testing.assert_array_equal(o1, o2)
    assert o1.dtype == np.float32
    dones = 0
    for a in _script(env, 300, 7):
        (o1, r1, d1), (o2, r2, d2) = ours.step(a), ref.step(a)
        np.testing.assert_array_equal(o1, o2)
        assert (r1, d1) == (r2, d2) and isinstance(r1, float)
        if d1:
            dones += 1
            np.testing.assert_array_equal(ours.reset(), ref.reset())
    ours.close()
    ref.close()
    if env == "CartPole-v1":
        assert dones > 0  # resets were exercised


@pytest.mark.parametrize("gray", [False, True], ids=["colour", "gray"])
def test_conv_preprocess_matches(gray):
    """The nearest-neighbour resize (+ grayscale) on a seeded (64,48,3)
    uint8 image, and on a 2-D frame."""
    raw = {"env": "CartPole-v1", "algo": "SAC", "need_conv": True, "height": 21,
           "width": 17, "is_gray": gray}
    ours = EnvAdapter.__new__(EnvAdapter)
    ours.cfg = Config.from_dict(raw)
    ref = JaxEnvAdapter.__new__(JaxEnvAdapter)
    ref.cfg = JaxConfig.from_dict(raw)
    img = np.random.default_rng(5).integers(0, 256, size=(64, 48, 3), dtype=np.uint8)
    for frame in (img, img[..., 0]):
        arr = np.asarray(frame, np.float32)
        got, want = ours._conv_preprocess(arr), ref._conv_preprocess(arr)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(ours._preprocess(frame), ref._preprocess(frame))
