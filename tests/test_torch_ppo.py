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
from tpu_rl_torch.bridge import flax_to_state_dict, train_state_from_flax
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


def test_other_algos_wait_for_their_slice():
    for name in ("IMPALA", "V-MPO", "SAC", "SAC-Continuous", "PPO-Continuous"):
        with pytest.raises(NotImplementedError, match="other-algorithms slice"):
            get_algo(name)
    with pytest.raises(ValueError, match="unknown algo"):
        get_algo("DQN")


# ------------------------------------------------------ one whole train step
def _batch_np(cfg, seed):
    rng = np.random.default_rng(seed)
    B, S, H = cfg.batch_size, cfg.seq_len, cfg.hidden_size
    logits = rng.normal(size=(B, S, 2)).astype(np.float32)
    logits = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    act = rng.integers(0, 2, size=(B, S, 1)).astype(np.float32)
    log_prob = np.take_along_axis(logits, act.astype(np.int64), -1)
    log_prob = (log_prob + 0.1 * rng.normal(size=log_prob.shape)).astype(np.float32)
    is_fir = (rng.random((B, S, 1)) < 0.2).astype(np.float32)
    is_fir[:3, 0] = 1.0
    return {
        "obs": rng.normal(size=(B, S, 4)).astype(np.float32),
        "act": act,
        "rew": (0.1 * rng.normal(size=(B, S, 1))).astype(np.float32),
        "logits": logits,
        "log_prob": log_prob,
        "is_fir": is_fir,
        "hx": (0.5 * rng.normal(size=(B, S, H))).astype(np.float32),
        "cx": (0.5 * rng.normal(size=(B, S, H))).astype(np.float32),
    }


def _jax_step(train_step, state, batch):
    jax_cells.set_pallas_mode("interpret")
    try:
        return jax.jit(train_step)(state, batch, jax.random.key(1))
    finally:
        jax_cells.set_pallas_mode("auto")


def _setup_step(k_epoch, nan_logp=False):
    """tpu_rl's state after one warm-up step (so ``nu`` is not zero), with
    perturbed biases, bridged into the port; one fresh batch for both."""
    jcfg = small_config(K_epoch=k_epoch, learn_diag=True, update_guard=True)
    _fam, jstate, jstep = jax_get_algo("PPO").build(jcfg, jax.random.key(0))
    jstate = jstate.replace(params={"actor": with_random_biases(jstate.params["actor"], 11)})
    jstate, _ = _jax_step(jstep, jstate, JaxBatch.from_mapping(_batch_np(jcfg, 20)))
    jstate = jax.device_get(jstate)
    cfg = Config.from_dict({"hidden_size": 16, "batch_size": 8, "buffer_size": 32, "time_horizon": 32,
                            "K_epoch": k_epoch, "learn_diag": True, "update_guard": True})
    _f, _s, step = get_algo("PPO").build(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch_np = _batch_np(jcfg, 21)
    if nan_logp:
        batch_np["log_prob"][0, 0, 0] = np.nan
    return jstate, jstep, JaxBatch.from_mapping(batch_np), train_state_from_flax(jstate), step, Batch.from_mapping(batch_np, device="cpu")


def _assert_states_close(state, jstate):
    from tpu_rl_torch.bridge import state_dict_to_flax

    assert int(state.step) == int(jstate.step)
    for got_tree, want_tree, what in (
        (state.params["actor"], jstate.params["actor"], "params"),
        (state.opt_state["nu"]["actor"], next(s.nu for s in jstate.opt_state if hasattr(s, "nu"))["actor"], "nu"),
    ):
        got = jax.tree_util.tree_flatten_with_path(state_dict_to_flax(got_tree))[0]
        want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want, strict=True):
            _close(g, w, f"{what} {jax.tree_util.keystr(path)}")


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
