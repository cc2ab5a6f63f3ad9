"""The port's act step against tpu_rl's on the CPU, with bridged weights and
the same numpy inputs: ``fused_act_step_plain`` against the Pallas kernel in
interpret mode, and the port's ``family.act`` / fused act against tpu_rl's.
Tolerance atol 1e-5 on logits, h2, c2 and log_prob (tpu_rl's own kernel
parity bar, tests/test_pallas_act.py); actions must be equal under shared
Gumbel noise. Plus the ``make_act_fn`` dispatch cases."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import small_config
from tests.test_torch_bridge import with_random_biases
from tpu_rl.models import cells as jax_cells
from tpu_rl.models.families import build_family as jax_build_family
from tpu_rl.ops.pallas_act import fused_act_step as jax_fused_act_step
from tpu_rl.ops.pallas_act import make_fused_act as jax_make_fused_act
from tpu_rl_torch.bridge import flax_to_state_dict
from tpu_rl_torch.config import Config
from tpu_rl_torch.models.families import build_family
from tpu_rl_torch.models.quant import make_act_fn
from tpu_rl_torch.ops.fused_act import fused_act_step, fused_act_step_plain, make_fused_act

ATOL = 1e-5

# (hidden, obs_dim, actions, batch): tpu_rl's own kernel-parity shape
# (tests/test_pallas_act.py) and the serving width at its smallest bucket.
SHAPES = [(32, 6, 3, 16), (256, 4, 2, 8)]


def _setup(hidden, obs_dim, actions, batch, seed=0):
    jcfg = small_config(hidden_size=hidden, obs_shape=(obs_dim,), action_space=actions)
    jfam = jax_build_family(jcfg)
    jparams = jfam.init_params(jax.random.key(seed), seq_len=jcfg.seq_len)
    jparams = {**jparams, "actor": with_random_biases(jparams["actor"], seed + 2)}
    cfg = Config.from_dict(
        {"hidden_size": hidden, "obs_shape": (obs_dim,), "action_space": actions}
    )
    fam = build_family(cfg, device="cpu")
    params = {"actor": flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jparams["actor"]))}
    rng = np.random.default_rng(seed + 1)
    obs = rng.normal(size=(batch, obs_dim)).astype(np.float32)
    h = rng.normal(size=(batch, hidden)).astype(np.float32)
    c = rng.normal(size=(batch, hidden)).astype(np.float32)
    return jcfg, jfam, jparams, cfg, fam, params, (obs, h, c)


def _close(t, j, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0, err_msg=what)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape):
    *_, jparams, _cfg, _fam, params, (obs, h, c) = _setup(*shape)
    want = jax_fused_act_step(jparams["actor"], obs, h, c, interpret=True)
    got = fused_act_step_plain(params["actor"], *_t(obs, h, c))
    for g, w, name in zip(got, want, ("logits", "h2", "c2"), strict=True):
        _close(g, w, name)
    np.testing.assert_allclose(np.exp(got[0].numpy()).sum(-1), 1.0, atol=ATOL)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("shape", SHAPES)
def test_act_matches_tpu_rl(shape, kernel):
    """The port's act (unfused module forward, or the fused path's CPU plain
    version) against tpu_rl's act, with tpu_rl's Gumbel draws handed over."""
    jcfg, jfam, jparams, cfg, fam, params, (obs, h, c) = _setup(*shape)
    key = jax.random.key(11)
    if kernel == "pallas":
        jax_cells.set_pallas_mode("interpret")
        try:
            want = jax_make_fused_act(jfam)(jparams, obs, h, c, key)
        finally:
            jax_cells.set_pallas_mode("auto")
    else:
        want = jfam.act(jparams, jnp.asarray(obs), jnp.asarray(h), jnp.asarray(c), key)
    gumbel = np.array(jax.random.gumbel(key, (obs.shape[0], fam.n_actions), jnp.float32))
    act = make_act_fn(cfg.replace(act_kernel=kernel), fam)
    a, logits, log_prob, h2, c2 = act(params, *_t(obs, h, c), gumbel=torch.from_numpy(gumbel))
    a_w, logits_w, lp_w, h2_w, c2_w = want
    for g, w, name in ((logits, logits_w, "logits"), (log_prob, lp_w, "log_prob"),
                       (h2, h2_w, "h2"), (c2, c2_w, "c2")):
        _close(g, w, name)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_w))
    assert a.shape == (obs.shape[0], 1) and a.dtype == torch.float32
    assert log_prob.shape == (obs.shape[0], 1)
    # log_prob is the log-softmax logit of the sampled action (renormalized
    # once more by categorical_log_prob, hence a float32 ulp of slack)
    np.testing.assert_allclose(
        log_prob.numpy()[:, 0], logits.numpy()[np.arange(len(a)), a.numpy()[:, 0].astype(int)],
        atol=1e-6, rtol=0,
    )


def test_fused_act_samples_with_a_generator():
    *_, cfg, fam, params, (obs, h, c) = _setup(32, 6, 3, 16)
    act = make_fused_act(fam)
    runs = [act(params, *_t(obs, h, c), torch.Generator().manual_seed(5)) for _ in range(2)]
    for x, y in zip(*runs, strict=True):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises; the
    plain version is never taken for it."""
    *_, params, (obs, h, c) = _setup(32, 6, 3, 16)
    meta = {k: v.to("meta") for k, v in params["actor"].items()}
    with pytest.raises(ValueError, match="unsupported device"):
        fused_act_step(meta, *(torch.from_numpy(x).to("meta") for x in (obs, h, c)))


class TestDispatch:
    def test_make_act_fn_xla_is_family_act(self):
        *_, cfg, fam, _params, _x = _setup(32, 6, 3, 16)
        assert make_act_fn(cfg, fam) is fam.act

    def test_make_act_fn_pallas_wraps(self):
        *_, cfg, fam, _params, _x = _setup(32, 6, 3, 16)
        assert make_act_fn(cfg.replace(act_kernel="pallas"), fam) is not fam.act

    def test_out_of_scope_family_falls_back(self):
        """The fallback this test is named for is gone: for a family the
        fused kernel does not cover, ``act_kernel="pallas"`` raises instead
        of quietly serving ``family.act``."""
        *_, cfg, fam, _params, _x = _setup(32, 6, 3, 16)
        other = replace(fam, actor=torch.nn.Linear(6, 3))
        with pytest.raises(NotImplementedError, match="other-algorithms slice"):
            make_fused_act(other)
        with pytest.raises(NotImplementedError, match="other-algorithms slice"):
            make_act_fn(cfg.replace(act_kernel="pallas"), other)
        assert make_act_fn(cfg, other) is other.act

    def test_cpu_pallas_path_equals_unfused(self):
        """On CPU tensors the fused path is the plain version: the same
        numbers as the module forward, the same sampled actions."""
        *_, cfg, fam, params, (obs, h, c) = _setup(32, 6, 3, 16)
        act = make_act_fn(cfg.replace(act_kernel="pallas"), fam)
        got = act(params, *_t(obs, h, c), torch.Generator().manual_seed(5))
        want = fam.act(params, *_t(obs, h, c), torch.Generator().manual_seed(5))
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
