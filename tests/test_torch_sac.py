"""SAC, discrete and continuous, in the port against ``tpu_rl`` on the CPU:
Adam against ``optax.adam``, the three target-entropy rules, the twin
critics' forward (an odd H, where the continuous critic's LSTM input is
``2*(H//2) = H-1`` wide), and one whole SAC train step from one bridged
``SACState``, with ``tpu_rl``'s per-epoch actor and TD-target noise passed
to the port (threefry and Philox cannot match). Tolerances: loss rtol
1e-5; every other metric and the params 1e-5; the Adam moments 3e-5 (a
gradient feeds them directly)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.conftest import small_config
from tests.test_torch_bridge import with_random_biases
from tests.test_torch_ppo import (
    SPACES,
    _assert_metrics_close,
    _batch_np,
    _close,
    _jax_step,
    assert_tree_close,
    setup_algo_step,
)
from tpu_rl.algos.base import adam as jax_adam
from tpu_rl.algos.registry import get_algo as jax_get_algo
from tpu_rl_torch.algos.base import Adam
from tpu_rl_torch.algos.registry import get_algo
from tpu_rl_torch.algos.sac import target_entropy_for
from tpu_rl_torch.bridge import flax_to_state_dict
from tpu_rl_torch.config import Config

KEY = 9
MOMENT_ATOL = 3e-5


def _noise(batch_np, k_epoch):
    """tpu_rl's draws: per epoch ``k_pol, k_cri = split(fold_in(key, e))``,
    each a unit normal of the actions' shape."""
    shape = batch_np.act.shape
    out = []
    for e in range(k_epoch):
        k_pol, k_cri = jax.random.split(jax.random.fold_in(jax.random.key(KEY), e))
        out.append(tuple(torch.tensor(np.asarray(jax.random.normal(k, shape, jnp.float32)))
                         for k in (k_pol, k_cri)))
    return out


def _adam_of(opt_state):
    return next(s for s in opt_state if hasattr(s, "mu"))


def assert_sac_states_close(state, jstate):
    assert int(state.step) == int(jstate.step)
    for what in ("actor_params", "critic_params", "target_critic_params"):
        assert_tree_close(getattr(state, what), getattr(jstate, what), what)
    _close(state.log_alpha, jstate.log_alpha, "log_alpha")
    for what in ("actor_opt", "critic_opt", "alpha_opt"):
        got, want = getattr(state, what), _adam_of(getattr(jstate, what))
        assert int(got["count"]) == int(want.count), what
        for m in ("mu", "nu"):
            if what == "alpha_opt":
                _close(got[m], getattr(want, m), f"{what} {m}", atol=MOMENT_ATOL)
            else:
                assert_tree_close(got[m], getattr(want, m), f"{what} {m}", atol=MOMENT_ATOL)


def _both_steps(algo, k_epoch, corrupt=None, **kw):
    jstate, jstep, jbatch, state, step, batch = setup_algo_step(algo, k_epoch, corrupt, **kw)
    jnew, jmetrics = _jax_step(jstep, jstate, jbatch, jax.random.key(KEY))
    noise = _noise(jbatch, k_epoch) if algo == "SAC-Continuous" else None
    new, metrics = step(state, batch, noise=noise)
    return state, new, metrics, jax.device_get(jnew), jax.device_get(jmetrics)


def test_adam_matches_optax_over_steps():
    rng = np.random.default_rng(4)
    p = {"w": rng.normal(size=(5, 3)).astype(np.float32), "b": np.float32(0.3)}
    opt_j = jax_adam(small_config(lr=3e-4))
    st_j = opt_j.init(p)
    opt = Adam(3e-4)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    st = opt.init(tp)
    for i in range(6):
        g = {"w": rng.normal(size=(5, 3)).astype(np.float32), "b": np.float32(rng.normal())}
        if i == 3:  # a tiny gradient: the update's ratio is held too
            g = {k: (1e-7 * np.asarray(v)).astype(np.float32) for k, v in g.items()}
        upd, st_j = opt_j.update(g, st_j, p)
        p = optax.apply_updates(p, upd)
        tp, st = opt.apply({k: torch.tensor(v) for k, v in g.items()}, st, tp)
        for k in p:
            _close(tp[k], p[k], f"params {k} step {i}", atol=1e-6)
            _close(st["mu"][k], st_j[0].mu[k], f"mu {k}", atol=1e-7, rtol=1e-5)
            _close(st["nu"][k], st_j[0].nu[k], f"nu {k}", atol=1e-9, rtol=1e-5)
        assert int(st["count"]) == int(st_j[0].count) == i + 1


@pytest.mark.parametrize("algo", ["SAC", "SAC-Continuous"])
@pytest.mark.parametrize("mode", ["reference", "explicit", "default"])
def test_target_entropy_modes_match(algo, mode):
    """The three rules of tpu_rl's sac.py: +action_space under
    sac_reference_alpha, cfg.target_entropy, else -dim(A) (continuous) or
    0.98 log|A| (discrete); held through the alpha loss of one step."""
    kw = {"reference": dict(sac_reference_alpha=True), "explicit": dict(target_entropy=-0.37),
          "default": {}}[mode]
    n = 3 if algo == "SAC" else 2
    cfg = Config.from_dict(dict(algo=algo, action_space=n, **kw))
    want = {"reference": float(n), "explicit": -0.37,
            "default": -float(n) if algo == "SAC-Continuous" else 0.98 * float(jnp.log(n))}[mode]
    np.testing.assert_allclose(target_entropy_for(cfg, algo == "SAC-Continuous"), want, rtol=1e-7)
    _s, new, metrics, jnew, jmetrics = _both_steps(algo, 1, **kw)
    _close(metrics["loss_alpha"], jmetrics["loss_alpha"], "loss_alpha")
    _close(new.log_alpha, jnew.log_alpha, "log_alpha")
    if mode == "reference":  # the reference's rule: alpha decays
        assert float(metrics["loss_alpha"]) > 0
    with pytest.raises(ValueError, match="sac_reference_alpha"):
        Config.from_dict(dict(algo=algo, sac_reference_alpha=True, target_entropy=1.0))


@pytest.mark.parametrize("algo", ["SAC", "SAC-Continuous"])
@pytest.mark.parametrize("hidden", [16, 17])
def test_twin_critics_forward_match(algo, hidden):
    """q1 and q2 of the twin critic with bridged weights (seeded nonzero
    biases); at H=17 the continuous critic's streams are 8 + 8 wide into a
    17-unit LSTM."""
    obs_shape, n = SPACES[algo]
    kw = dict(algo=algo, hidden_size=hidden, obs_shape=obs_shape, action_space=n)
    jfam = jax_get_algo(algo).build(small_config(**kw), jax.random.key(0))[0]
    jparams = with_random_biases(jfam.init_params(jax.random.key(3), seq_len=5)["critic"], 4)
    fam = get_algo(algo).build(Config.from_dict(kw), device="cpu")[0]
    params = flax_to_state_dict(jax.device_get(jparams))
    assert set(params) == set(fam.init_params()["critic"])
    b = _batch_np(small_config(**kw), 5, fam.continuous)
    carry = (torch.from_numpy(b["hx"][:, 0]), torch.from_numpy(b["cx"][:, 0]))
    jcarry = (b["hx"][:, 0], b["cx"][:, 0])
    if algo == "SAC":
        want = jfam.critic_unroll(jparams, b["obs"], jcarry, b["is_fir"])
        got = fam.critic_unroll(params, torch.from_numpy(b["obs"]), carry,
                                torch.from_numpy(b["is_fir"]))
    else:
        want = jfam.critic_unroll(jparams, b["obs"], b["act"], jcarry, b["is_fir"])
        got = fam.critic_unroll(params, torch.from_numpy(b["obs"]), torch.from_numpy(b["act"]),
                                carry, torch.from_numpy(b["is_fir"]))
        assert params["q1.cell.x_proj.weight"].shape == (4 * hidden, 2 * (hidden // 2))
    for g, w, q in zip(got, want, ("q1", "q2"), strict=True):
        _close(g, w, f"{algo} {q}")


@pytest.mark.parametrize("k_epoch", [1, 2])
@pytest.mark.parametrize("algo,hidden", [("SAC", 16), ("SAC-Continuous", 17)])
def test_train_step_matches_tpu_rl(algo, hidden, k_epoch):
    """One SAC train step from one bridged SACState (B8 S5): loss,
    policy/value/alpha losses, alpha, grad-norm, the diag rows (ent, kl, w,
    tq) and scalars (per-module grad norms over actor and critic, update
    and param norms), the actor, both critics, the Polyak target,
    log_alpha and the three Adam states."""
    state, new, metrics, jnew, jmetrics = _both_steps(algo, k_epoch, hidden=hidden)
    _assert_metrics_close(metrics, jmetrics)
    assert_sac_states_close(new, jnew)
    assert float(metrics["nonfinite-updates"]) == 0.0
    # the target moved by tau toward the updated critic, a tensor of its own
    name = "q1.q.bias" if algo == "SAC" else "q2.q.bias"
    assert not torch.equal(new.target_critic_params[name], state.target_critic_params[name])
    assert new.target_critic_params[name].data_ptr() != new.critic_params[name].data_ptr()


@pytest.mark.parametrize("algo", ["SAC", "SAC-Continuous"])
def test_nonfinite_update_is_skipped_like_tpu_rl(algo):
    """A NaN reward makes the TD target and the critic's loss NaN: the
    critic, its Adam state and the target stay; the actor and alpha
    updates (finite) go through; ``nonfinite-updates`` counts 1 — in both
    packages."""
    def corrupt(b):
        b["rew"][3, 1, 0] = np.nan

    state, new, metrics, jnew, jmetrics = _both_steps(algo, 1, corrupt)
    assert float(metrics["nonfinite-updates"]) == float(jmetrics["nonfinite-updates"]) == 1.0
    for what in ("critic_params", "target_critic_params"):
        for name, t in getattr(state, what).items():
            torch.testing.assert_close(getattr(new, what)[name], t, rtol=0, atol=0)
    assert int(new.critic_opt["count"]) == int(state.critic_opt["count"])
    assert int(new.actor_opt["count"]) == int(state.actor_opt["count"]) + 1
    assert_sac_states_close(new, jnew)
