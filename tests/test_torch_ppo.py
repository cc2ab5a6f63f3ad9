"""The port's training math against ``tpu_rl``'s on the CPU, from the same
numpy inputs: GAE, smooth-L1, the global-norm clip, the update guard,
RMSprop against optax, the TrainState bridge, and one whole PPO train step
from one state (``tpu_rl``'s LSTM unroll through its Pallas kernels in
interpret mode, the port's through its plain versions). Tolerances: loss
rtol 1e-5 (``tests/test_pallas_lstm.py``), params and RMSprop ``nu`` atol
1e-5, every other metric atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.conftest import small_config
from tests.test_torch_bridge import with_random_biases
from tpu_rl.algos.base import rmsprop as jax_rmsprop
from tpu_rl.algos.registry import get_algo as jax_get_algo
from tpu_rl.heal.guards import guarded as jax_guarded
from tpu_rl.models import cells as jax_cells
from tpu_rl.obs import learn as jax_learn
from tpu_rl.ops.losses import clip_subtree_by_global_norm as jax_clip
from tpu_rl.ops.losses import smooth_l1 as jax_smooth_l1
from tpu_rl.ops.returns import gae as jax_gae
from tpu_rl.types import BATCH_FIELDS as JAX_BATCH_FIELDS
from tpu_rl.types import Batch as JaxBatch
from tpu_rl.types import field_widths as jax_field_widths
from tpu_rl_torch.algos.base import RMSprop
from tpu_rl_torch.algos.registry import get_algo
from tpu_rl_torch.models.families import ALGOS
from tpu_rl_torch.bridge import flax_to_state_dict, sac_state_from_flax, train_state_from_flax
from tpu_rl_torch.config import Config
from tpu_rl_torch.heal.guards import guarded, update_ok
from tpu_rl_torch.obs import learn
from tpu_rl_torch.ops.losses import clip_subtree_by_global_norm, smooth_l1
from tpu_rl_torch.ops.returns import gae
from tpu_rl_torch.types import BATCH_FIELDS, Batch, field_widths

ATOL = 1e-5


def _close(got, want, what, atol=ATOL, rtol=0.0):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol, err_msg=what)


# ----------------------------------------------------------- small pieces
@pytest.mark.parametrize("shape", [(8, 4, 1), (3, 9, 2), (4, 2047, 1)])
def test_gae_matches(shape):
    d = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    _close(gae(torch.from_numpy(d), 0.99, 0.95), jax_gae(jnp.asarray(d), 0.99, 0.95), "gae")


def test_smooth_l1_matches():
    rng = np.random.default_rng(1)
    pred, target = (rng.normal(scale=2.0, size=(16, 4, 1)).astype(np.float32) for _ in range(2))
    _close(smooth_l1(*map(torch.from_numpy, (pred, target))), jax_smooth_l1(pred, target), "smooth_l1")


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clipped", "unclipped"])
def test_clip_by_global_norm_matches(max_norm):
    rng = np.random.default_rng(2)
    tree = {
        "actor": {"a": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=5).astype(np.float32)},
        "log_eta": {"x": rng.normal(size=()).astype(np.float32)},
    }
    want, wn = jax_clip(tree, max_norm)
    got, gn = clip_subtree_by_global_norm(
        {k: {n: torch.from_numpy(v) for n, v in g.items()} for k, g in tree.items()}, max_norm
    )
    _close(gn, wn, "norm")
    for k in tree:
        for n in tree[k]:
            _close(got[k][n], want[k][n], f"{k}/{n}")


@pytest.mark.parametrize("bad", [None, "loss", "gnorm"])
def test_guard_matches(bad):
    loss = torch.tensor(float("nan") if bad == "loss" else 1.0)
    gnorm = torch.tensor(float("inf") if bad == "gnorm" else 2.0)
    ok = update_ok(loss, gnorm)
    assert bool(ok) is (bad is None)
    old = ({"p": torch.zeros(3)}, {"nu": {"p": torch.ones(3)}})
    new = ({"p": torch.full((3,), float("nan"))}, {"nu": {"p": torch.full((3,), 5.0)}})
    got = guarded(ok, lambda: new, old)
    want = jax_guarded(jnp.asarray(bool(ok)), lambda: jax.tree.map(lambda t: jnp.asarray(t.numpy()), new),
                       jax.tree.map(lambda t: jnp.asarray(t.numpy()), old))
    np.testing.assert_array_equal(got[0]["p"].numpy(), np.asarray(want[0]["p"]))
    np.testing.assert_array_equal(got[1]["nu"]["p"].numpy(), np.asarray(want[1]["nu"]["p"]))


def test_learn_helpers_match():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 4, 1)).astype(np.float32)
    _close(learn.rows_mean(torch.from_numpy(x)), jax_learn.rows_mean(jnp.asarray(x)), "rows_mean")
    jtree = {"actor": {"params": {
        "body": {"kernel": rng.normal(size=(4, 8)).astype(np.float32), "bias": rng.normal(size=8).astype(np.float32)},
        "cell": {"x_proj": {"kernel": rng.normal(size=(8, 32)).astype(np.float32),
                            "bias": rng.normal(size=32).astype(np.float32)},
                 "recurrent_kernel": rng.normal(size=(8, 32)).astype(np.float32)},
        "logits": {"kernel": rng.normal(size=(8, 2)).astype(np.float32), "bias": rng.normal(size=2).astype(np.float32)},
    }}}
    tree = {"actor": flax_to_state_dict(jtree["actor"])}
    want = jax_learn.module_grad_norms(jtree)
    got = learn.module_grad_norms(tree)
    assert set(got) == set(want) == {"torso", "cell", "heads"}
    for k in want:
        _close(got[k], want[k], k)
    _close(learn.tree_norm(tree), jax_learn.tree_norm(jtree), "tree_norm")
    shifted = {"actor": {k: v + 0.5 for k, v in tree["actor"].items()}}
    jshift = jax.tree.map(lambda a: a + 0.5, jtree)
    _close(learn.tree_delta_norm(shifted, tree), jax_learn.tree_delta_norm(jshift, jtree), "delta")


def test_rmsprop_matches_optax_over_steps():
    rng = np.random.default_rng(4)
    p = {"actor": {"w": rng.normal(size=(5, 3)).astype(np.float32)}}
    opt_j = jax_rmsprop(small_config(lr=3e-4))
    st_j = opt_j.init(p)
    opt = RMSprop(3e-4)
    tp = {"actor": {"w": torch.from_numpy(p["actor"]["w"].copy())}}
    st = opt.init(tp)
    for _ in range(3):
        g = {"actor": {"w": rng.normal(size=(5, 3)).astype(np.float32)}}
        upd, st_j = opt_j.update(g, st_j, p)
        p = optax.apply_updates(p, upd)
        tp, st = opt.apply({"actor": {"w": torch.from_numpy(g["actor"]["w"])}}, st, tp)
    _close(tp["actor"]["w"], p["actor"]["w"], "params", atol=1e-6)
    _close(st["nu"]["actor"]["w"], st_j[0].nu["actor"]["w"], "nu", atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("name", [*ALGOS, "DQN"])
def test_other_algos_wait_for_their_slice(name):
    """Every algorithm of tpu_rl's registry builds on the CPU and its train
    step runs (the slice that brought the other five has landed); an
    unknown name still raises ValueError."""
    if name not in ALGOS:
        with pytest.raises(ValueError, match="unknown algo"):
            get_algo(name)
        return
    obs_shape, n = SPACES[name]
    cfg = Config.from_dict(dict(algo=name, hidden_size=16, batch_size=8, buffer_size=32,
                                obs_shape=list(obs_shape), action_space=n))
    family, state, step = get_algo(name).build(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert family.algo == name and family.separate == (name.startswith("SAC"))
    batch = Batch.from_mapping(_batch_np(cfg, 3, family.continuous), device="cpu")
    new, metrics = step(state, batch, torch.Generator().manual_seed(1))
    assert int(new.step) == 1 and np.isfinite(float(metrics["loss"]))


# ------------------------------------------------------ one whole train step
def _batch_np(cfg, seed, continuous=False):
    """A seeded batch at ``cfg``'s shape: a categorical one (behaviour
    log-softmax logits, action indices, their log-probs perturbed), or for a
    Gaussian policy actions in (-1, 1), per-dimension log-probs and zero
    logits; ~20% episode firsts, carries at 0.5 scale."""
    rng = np.random.default_rng(seed)
    B, S, H = cfg.batch_size, cfg.seq_len, cfg.hidden_size
    A, D = int(cfg.action_space), int(cfg.obs_shape[0])
    if continuous:
        act = np.tanh(rng.normal(size=(B, S, A))).astype(np.float32)
        logits = np.zeros((B, S, A), np.float32)
        log_prob = (-1.0 + 0.3 * rng.normal(size=(B, S, A))).astype(np.float32)
    else:
        logits = rng.normal(size=(B, S, A)).astype(np.float32)
        logits = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        act = rng.integers(0, A, size=(B, S, 1)).astype(np.float32)
        log_prob = np.take_along_axis(logits, act.astype(np.int64), -1)
        log_prob = (log_prob + 0.1 * rng.normal(size=log_prob.shape)).astype(np.float32)
    is_fir = (rng.random((B, S, 1)) < 0.2).astype(np.float32)
    is_fir[:3, 0] = 1.0
    return {
        "obs": rng.normal(size=(B, S, D)).astype(np.float32),
        "act": act,
        "rew": (0.1 * rng.normal(size=(B, S, 1))).astype(np.float32),
        "logits": logits,
        "log_prob": log_prob,
        "is_fir": is_fir,
        "hx": (0.5 * rng.normal(size=(B, S, H))).astype(np.float32),
        "cx": (0.5 * rng.normal(size=(B, S, H))).astype(np.float32),
    }


def _jax_step(train_step, state, batch, key=None):
    jax_cells.set_pallas_mode("interpret")
    try:
        return jax.jit(train_step)(state, batch, jax.random.key(1) if key is None else key)
    finally:
        jax_cells.set_pallas_mode("auto")


# The small shapes of the parity tests: CartPole's (4,)/2 for the discrete
# algorithms, Pendulum's (3,)/1 for PPO-Continuous, bench.py's (2,)/1 for
# SAC-Continuous.
SPACES = {"PPO": ((4,), 2), "IMPALA": ((4,), 2), "V-MPO": ((4,), 2), "SAC": ((4,), 2),
          "PPO-Continuous": ((3,), 1), "SAC-Continuous": ((2,), 1)}


def setup_algo_step(algo, k_epoch, corrupt=None, hidden=16, **kw):
    """tpu_rl's state for ``algo`` after one warm-up step (so the optimizer
    moments are not zero), with perturbed biases, bridged into the port;
    one fresh batch for both (``corrupt(batch_np)`` may edit it). Returns
    (jax state, jax step, jax batch, port state, port step, port batch)."""
    obs_shape, n = SPACES[algo]
    raw = dict(algo=algo, hidden_size=hidden, batch_size=8, buffer_size=32, time_horizon=32,
               seq_len=5, obs_shape=obs_shape, action_space=n, K_epoch=k_epoch, learn_diag=True,
               update_guard=True, **kw)
    jcfg = small_config(**raw)
    jfam, jstate, jstep = jax_get_algo(algo).build(jcfg, jax.random.key(0))
    if jfam.separate:
        jstate = jstate.replace(
            actor_params=with_random_biases(jstate.actor_params, 11),
            critic_params=with_random_biases(jstate.critic_params, 12),
            target_critic_params=with_random_biases(jstate.target_critic_params, 13),
        )
    else:
        jstate = jstate.replace(params={**jstate.params,
                                        "actor": with_random_biases(jstate.params["actor"], 11)})
    warm = JaxBatch.from_mapping(_batch_np(jcfg, 20, jfam.continuous))
    jstate, _ = _jax_step(jstep, jstate, warm, jax.random.key(2))
    jstate = jax.device_get(jstate)
    cfg = Config.from_dict(raw)
    _f, _s, step = get_algo(algo).build(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch_np = _batch_np(jcfg, 21, jfam.continuous)
    if corrupt is not None:
        corrupt(batch_np)
    state = sac_state_from_flax(jstate) if jfam.separate else train_state_from_flax(jstate)
    return (jstate, jstep, JaxBatch.from_mapping(batch_np), state, step,
            Batch.from_mapping(batch_np, device="cpu"))


def _setup_step(k_epoch, nan_logp=False):
    def corrupt(b):
        b["log_prob"][0, 0, 0] = np.nan

    return setup_algo_step("PPO", k_epoch, corrupt if nan_logp else None)


def assert_tree_close(got_sd, want_tree, what, atol=ATOL):
    """A port state_dict against a flax tree, leaf for leaf by path."""
    from tpu_rl_torch.bridge import state_dict_to_flax

    got = jax.tree_util.tree_flatten_with_path(state_dict_to_flax(got_sd))[0]
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert [p for p, _ in got] == [p for p, _ in want], what
    for (path, g), (_, w) in zip(got, want, strict=True):
        _close(g, w, f"{what} {jax.tree_util.keystr(path)}", atol=atol)


def _assert_states_close(state, jstate):
    """A port TrainState against tpu_rl's: step, params and RMSprop nu,
    V-MPO's duals included."""
    assert int(state.step) == int(jstate.step)
    jnu = next(s.nu for s in jstate.opt_state if hasattr(s, "nu"))
    assert_tree_close(state.params["actor"], jstate.params["actor"], "params")
    assert_tree_close(state.opt_state["nu"]["actor"], jnu["actor"], "nu")
    assert set(state.params) == {"actor"} | ({"duals"} if "log_eta" in jstate.params else set())
    for k in state.params.get("duals", {}):
        _close(state.params["duals"][k], jstate.params[k], f"params {k}")
        _close(state.opt_state["nu"]["duals"][k], jnu[k], f"nu {k}")


def _assert_metrics_close(metrics, jmetrics):
    assert set(metrics) == set(jmetrics)
    for k, w in jmetrics.items():
        if k == "diag":
            continue
        if k == "loss":
            _close(metrics[k], w, k, atol=0.0, rtol=1e-5)
        else:
            _close(metrics[k], w, k)
    diag, jdiag = metrics["diag"], jmetrics["diag"]
    for part in ("rows", "scalars"):
        assert set(diag[part]) == set(jdiag[part]), part
        for k, w in jdiag[part].items():
            _close(diag[part][k], w, f"diag {part} {k}")


@pytest.mark.parametrize("k_epoch", [1, 2])
def test_train_step_matches_tpu_rl(k_epoch):
    """One PPO train step from one TrainState and one Batch (B8 S5 H16,
    learn_diag on): loss, every metric incl. the diag rows and scalars,
    params and RMSprop nu."""
    jstate, jstep, jbatch, state, step, batch = _setup_step(k_epoch)
    jnew, jmetrics = _jax_step(jstep, jstate, jbatch)
    new, metrics = step(state, batch)
    _assert_metrics_close(metrics, jax.device_get(jmetrics))
    _assert_states_close(new, jax.device_get(jnew))
    assert float(metrics["nonfinite-updates"]) == 0.0


def test_nonfinite_update_is_skipped_like_tpu_rl():
    """A NaN behaviour log-prob makes the loss NaN: params and nu stay as
    they were, and ``nonfinite-updates`` counts 1, in both packages."""
    jstate, jstep, jbatch, state, step, batch = _setup_step(1, nan_logp=True)
    jnew, jmetrics = _jax_step(jstep, jstate, jbatch)
    new, metrics = step(state, batch)
    assert float(metrics["nonfinite-updates"]) == float(jmetrics["nonfinite-updates"]) == 1.0
    assert not np.isfinite(float(metrics["loss"]))
    for old, cur in ((state.params, new.params), (state.opt_state["nu"], new.opt_state["nu"])):
        for name in old["actor"]:
            torch.testing.assert_close(cur["actor"][name], old["actor"][name], rtol=0, atol=0)
    _assert_states_close(new, jax.device_get(jnew))


def test_train_state_bridge_carries_step_params_and_nu():
    jstate, *_rest, state, _step, _batch = _setup_step(1)
    nu = next(s.nu for s in jstate.opt_state if hasattr(s, "nu"))
    k = nu["actor"]["params"]["cell"]["x_proj"]["kernel"]
    assert np.abs(k).max() > 0  # the warm-up step made nu nonzero
    np.testing.assert_array_equal(state.opt_state["nu"]["actor"]["cell.x_proj.weight"].numpy(), k.T)
    assert int(state.step) == 1
    assert set(state.params["actor"]) == set(state.opt_state["nu"]["actor"])


@pytest.mark.parametrize("continuous", [False, True])
def test_batch_fields_and_widths_match(continuous):
    assert BATCH_FIELDS == JAX_BATCH_FIELDS == tuple(Batch.__dataclass_fields__)
    args = (4, 3, 16, continuous)
    assert field_widths(*args) == jax_field_widths(*args)
    assert field_widths(*args, hx_width=5, cx_width=6) == jax_field_widths(*args, hx_width=5, cx_width=6)


# --------------------------------------------------------- PPO-Continuous
def test_continuous_policy_outputs_match_tpu_rl():
    """``policy_outputs``' Gaussian branch: per-dimension log-probs (B,S,A),
    the mean entropy over A (B,S,1), the value and zero logits."""
    from tpu_rl.algos.ppo import policy_outputs as jax_policy_outputs
    from tpu_rl_torch.algos.ppo import policy_outputs

    jstate, _js, jbatch, state, _s, batch = setup_algo_step("PPO-Continuous", 1, hidden=17)
    jfam = jax_get_algo("PPO-Continuous").build(
        small_config(algo="PPO-Continuous", hidden_size=17, obs_shape=(3,), action_space=1),
        jax.random.key(0))[0]
    fam = get_algo("PPO-Continuous").build(
        Config.from_dict(dict(algo="PPO-Continuous", hidden_size=17, obs_shape=[3], action_space=1)),
        device="cpu")[0]
    want = jax_policy_outputs(jfam, jstate.params, jbatch)
    got = policy_outputs(fam, state.params, batch)
    for g, w, what in zip(got, want, ("log_probs", "entropy", "value", "logits"), strict=True):
        assert g.shape == w.shape, what
        _close(g, w, what)
    assert got[0].shape == (8, 5, 1) and not got[3].any()


@pytest.mark.parametrize("k_epoch", [1, 2])
def test_continuous_train_step_matches_tpu_rl(k_epoch):
    """One PPO-Continuous train step (Pendulum's (3,)/1, B8 S5 H16): the
    ratio, clip and diag rows broadcast over the action dimension; loss,
    metrics, params and RMSprop nu at the tolerances above."""
    jstate, jstep, jbatch, state, step, batch = setup_algo_step("PPO-Continuous", k_epoch)
    jnew, jmetrics = _jax_step(jstep, jstate, jbatch)
    new, metrics = step(state, batch)
    _assert_metrics_close(metrics, jax.device_get(jmetrics))
    _assert_states_close(new, jax.device_get(jnew))
    assert float(metrics["nonfinite-updates"]) == 0.0


def test_continuous_nonfinite_update_is_skipped_like_tpu_rl():
    def corrupt(b):
        b["act"][0, 0, 0] = np.nan

    jstate, jstep, jbatch, state, step, batch = setup_algo_step("PPO-Continuous", 1, corrupt)
    jnew, jmetrics = _jax_step(jstep, jstate, jbatch)
    new, metrics = step(state, batch)
    assert float(metrics["nonfinite-updates"]) == float(jmetrics["nonfinite-updates"]) == 1.0
    for name, t in state.params["actor"].items():
        torch.testing.assert_close(new.params["actor"][name], t, rtol=0, atol=0)
    _assert_states_close(new, jax.device_get(jnew))


@pytest.mark.parametrize("algo", ["PPO-Continuous", "SAC-Continuous", "SAC"])
def test_other_families_act_matches_tpu_rl(algo):
    """``family.act`` with tpu_rl's own draw passed in (a unit normal for
    the Gaussian policies, a Gumbel for SAC's categorical actor) and
    ``act_greedy``: the action, behaviour logits, log-prob and carry, at
    1e-5, from bridged weights with nonzero biases."""
    obs_shape, n = SPACES[algo]
    jcfg = small_config(algo=algo, hidden_size=16, obs_shape=obs_shape, action_space=n)
    jfam = jax_get_algo(algo).build(jcfg, jax.random.key(0))[0]
    jparams = {"actor": with_random_biases(jfam.init_params(jax.random.key(3))["actor"], 4)}
    fam = get_algo(algo).build(Config.from_dict(dict(algo=algo, hidden_size=16,
                                                     obs_shape=list(obs_shape), action_space=n)),
                               device="cpu")[0]
    params = {"actor": flax_to_state_dict(jax.device_get(jparams["actor"]))}
    rng = np.random.default_rng(6)
    obs = rng.normal(size=(5, obs_shape[0])).astype(np.float32)
    h, c = (0.5 * rng.normal(size=(5, 16))).astype(np.float32), (0.5 * rng.normal(size=(5, 16))).astype(np.float32)
    key = jax.random.key(8)
    want = jfam.act(jparams, obs, h, c, key)
    shape = (5, n)
    if fam.continuous:
        draw = {"noise": torch.tensor(np.asarray(jax.random.normal(key, shape, jnp.float32)))}
    else:
        draw = {"gumbel": torch.tensor(np.asarray(jax.random.gumbel(key, shape, jnp.float32)))}
    got = fam.act(params, *map(torch.from_numpy, (obs, h, c)), **draw)
    for g, w, what in zip(got, want, ("action", "logits", "log_prob", "h", "c"), strict=True):
        assert tuple(g.shape) == w.shape, what
        _close(g, w, what)
    if fam.continuous:
        for g, w in zip(fam.act_greedy(params, *map(torch.from_numpy, (obs, h, c))),
                        jfam.act_greedy(jparams, obs, h, c), strict=True):
            _close(g, w, "greedy")
    else:
        assert fam.act_greedy is None and jfam.act_greedy is None
