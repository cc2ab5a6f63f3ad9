"""bf16 compute for LSTM training in the port against ``tpu_rl`` on the CPU,
from the same numpy inputs and bridged weights: ``mixed_dot`` (forward and
both gradients), the mixed-precision cell (one act step and the unroll,
with resets), the actor's unroll, and one whole IMPALA and PPO train step
at K_epoch 1 (the other algorithms: one bf16 step each, finite, with f32
params and no B1/B2 call). ``tpu_rl`` runs bf16 compute through its scan, never its
f32 kernel (``tpu_rl/models/cells.py:179-185``), so its side runs with the
Pallas mode off. Both sides take the same bf16 operands and sum in f32;
only the order of the f32 sums differs.

Tolerances: ``mixed_dot`` 1e-5; every forward value 1e-5; gradients that
stay f32 (the recurrent kernel's, dh0, dc0) 3e-5
(``tests/test_pallas_lstm.py:45,68``); the train step's loss rtol 1e-5 and
its metrics, params and RMSprop ``nu`` 1e-5. Two kinds of value are
downstream of a bf16 rounding and are held to bf16 bars instead:

- a bf16 Dense's input and weight gradients are bf16 products, rounded to
  bf16 from cotangents that may each flip by one bf16 ulp between the two
  sides: one bf16 ulp of the element, ``2**-7·|ref| + 2**-16·max|ref|``
  (``PERF.md`` §2);
- a bf16 Dense's bias gradient: ``tpu_rl``'s autodiff sums the bias
  cotangent in bf16 (``lax.reduce_sum`` in the operand's dtype, which XLA
  on the CPU accumulates in bf16: 2-6 ulps off the exact sum here), the
  port in f32, as the card's reductions do. It is held at ``tpu_rl``'s own
  bar for bf16 gradients (rtol 5e-2, atol 0.2,
  ``tests/test_models.py:224-226``), and after a train step the two bf16
  biases (``body.bias``, ``cell.x_proj.bias``) at 5% of the reference's
  largest step on that tensor (its bf16 rtol applied to the update).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import small_config
from tests.test_torch_bridge import with_random_biases
from tests.test_torch_ppo import _assert_metrics_close, _batch_np
from tpu_rl.algos.registry import get_algo as jax_get_algo
from tpu_rl.models import cells as jax_cells
from tpu_rl.models.families import build_family as jax_build_family
from tpu_rl.ops.pallas_lstm import mixed_dot as jax_mixed_dot
from tpu_rl.types import Batch as JaxBatch
from tpu_rl_torch.algos.registry import get_algo
from tpu_rl_torch.bridge import flax_to_state_dict, train_state_from_flax
from tpu_rl_torch.config import Config
from tpu_rl_torch.models.cells import LSTMCell
from tpu_rl_torch.models.families import build_family
from tpu_rl_torch.ops import lstm as L
from tpu_rl_torch.ops.fused_act import make_fused_act
from tpu_rl_torch.types import Batch

FWD_ATOL, GRAD_ATOL, DOT_ATOL = 1e-5, 3e-5, 1e-5
BF16_GRAD_TOL = dict(rtol=5e-2, atol=0.2)
BF16_BIASES = ("body.bias", "cell.x_proj.bias")


def _t(*arrays, grad=False):
    return [torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad) for a in arrays]


def _close(got, want, what, atol, rtol=0.0):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol, err_msg=what)


def _bf16_ulp_close(got, want, what):
    """One bf16 ulp of each element, plus a floor for the f32 sums' order
    near zero (``PERF.md`` §2)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    bar = 2.0**-7 * np.abs(want) + 2.0**-16 * np.abs(want).max()
    worst = float((np.abs(got - want) / bar).max())
    assert worst <= 1.0, f"{what}: {worst:.3f} of the bf16 element bar"


@pytest.fixture
def scan_mode():
    """tpu_rl's bf16 path: the scan (interpret mode would send bf16 to the
    f32 kernel, which tpu_rl never does off that mode)."""
    jax_cells.set_pallas_mode("off")
    yield
    jax_cells.set_pallas_mode("auto")


# ------------------------------------------------------------- mixed_dot
@pytest.mark.parametrize("shape", [(16, 32, 64), (5, 64, 256)])
def test_mixed_dot_matches_tpu_rl_forward_and_gradients(shape):
    """Value and both gradients of ``sum(mixed_dot(a, b) * w)`` at 1e-5;
    f32 results; the residuals saved already cast to bf16."""
    M, K, N = shape
    rng = np.random.default_rng(sum(shape))
    a, b, w = (rng.standard_normal(s).astype(np.float32) * 0.5 for s in ((M, K), (K, N), (M, N)))

    def jloss(a, b):
        return (jax_mixed_dot(a, b) * w).sum()

    jv = jax_mixed_dot(jnp.asarray(a), jnp.asarray(b))
    jga, jgb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = _t(a, b, grad=True)
    out = L.mixed_dot(ta, tb)
    assert out.dtype == torch.float32
    (out * torch.from_numpy(w)).sum().backward()
    _close(out, jv, "forward", DOT_ATOL)
    _close(ta.grad, jga, "da", DOT_ATOL)
    _close(tb.grad, jgb, "db", DOT_ATOL)
    assert ta.grad.dtype == tb.grad.dtype == torch.float32
    # the f32 result is not rounded to bf16: it equals the product of the
    # widened bf16 operands, not its bf16 rounding
    exact = ta.detach().bfloat16().double() @ tb.detach().bfloat16().double()
    assert float((out.detach().double() - exact).abs().max()) < 1e-5
    assert float((out.detach().bfloat16().double() - exact).abs().max()) > 1e-4


def test_mixed_dot_rejects_non_matrix_operands():
    """2-D operands only, as tpu_rl's (its backward transposes with .T)."""
    a2, b2 = torch.ones((4, 8), requires_grad=True), torch.ones((8, 3))
    out = L.mixed_dot(a2, b2)
    assert out.shape == (4, 3) and out.dtype == torch.float32
    out.sum().backward()
    assert a2.grad.shape == a2.shape
    with pytest.raises(ValueError, match="2-D"):
        L.mixed_dot(torch.ones((2, 4, 8)), b2)
    with pytest.raises(ValueError, match="2-D"):
        L.mixed_dot(a2, torch.ones(8))
    with pytest.raises(ValueError, match="2-D"):
        jax_mixed_dot(jnp.ones((2, 4, 8)), jnp.ones((8, 3)))


# ------------------------------------------------------------------ cell
def _cell_setup(B, S, D, H, seed=0):
    jcell = jax_cells.LSTMCell(H, dtype=jnp.bfloat16)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    jparams = jcell.init(jax.random.key(seed), (jnp.zeros((B, H)), jnp.zeros((B, H))), x[:, 0])
    jparams = with_random_biases(jax.tree_util.tree_map(np.asarray, jparams), seed + 3)
    cell = LSTMCell(D, H, dtype=torch.bfloat16)
    cell.load_state_dict(flax_to_state_dict(jparams))
    firsts = (rng.random((B, S, 1)) < 0.25).astype(np.float32)
    firsts[:2, 0] = 1.0
    h0 = rng.normal(size=(B, H)).astype(np.float32)
    c0 = rng.normal(size=(B, H)).astype(np.float32)
    return jcell, jparams, cell, (x, firsts, h0, c0)


@pytest.mark.parametrize("B,S,D,H", [(8, 5, 16, 16), (12, 7, 8, 32)])
def test_cell_step_and_unroll_match_tpu_rl(scan_mode, B, S, D, H):
    """One act step and the unroll with a resetting keep: outputs and final
    carry at 1e-5; the unroll's gradients in h0, c0 and the recurrent
    kernel at 3e-5, in x and x_proj at the bf16 bars of the module
    docstring. The bf16 unroll never launches B1/B2."""
    jcell, jparams, cell, (x, firsts, h0, c0) = _cell_setup(B, S, D, H)
    (jh, jc), _ = jcell.apply(jparams, (h0, c0), x[:, 0])
    (h, c), _ = cell((*_t(h0, c0),), *_t(x[:, 0]))
    _close(h, jh, "step h", FWD_ATOL)
    _close(c, jc, "step c", FWD_ATOL)

    def jloss(p, x, h0, c0):
        (hN, cN), hs = jcell.apply(p, x, (h0, c0), firsts, True, method="unroll")
        return (hs * jnp.cos(hs)).sum() + hN.sum() + 0.5 * cN.sum(), (hs, hN, cN)

    (_, (jhs, jhN, jcN)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        jparams, x, h0, c0)
    tx, th0, tc0 = _t(x, h0, c0, grad=True)
    f0, b0 = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
    (hN, cN), hs = cell.unroll(tx, (th0, tc0), *_t(firsts), True)
    ((hs * torch.cos(hs)).sum() + hN.sum() + 0.5 * cN.sum()).backward()
    assert (L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES) == (f0, b0)
    assert hs.dtype == hN.dtype == torch.float32
    for got, want, name in ((hs, jhs, "hs"), (hN, jhN, "h"), (cN, jcN, "c")):
        _close(got, want, name, FWD_ATOL)
    jgp, jgx, jgh, jgc = jgrads
    _bf16_ulp_close(tx.grad, jgx, "dx")  # the input of the bf16 x_proj
    _close(th0.grad, jgh, "dh0", GRAD_ATOL)
    _close(tc0.grad, jgc, "dc0", GRAD_ATOL)
    want_p = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgp))
    _close(cell.recurrent_kernel.grad, want_p["recurrent_kernel"], "drecurrent_kernel", GRAD_ATOL)
    _bf16_ulp_close(cell.x_proj.weight.grad, want_p["x_proj.weight"], "dx_proj.weight")
    _close(cell.x_proj.bias.grad, want_p["x_proj.bias"], "dx_proj.bias", **BF16_GRAD_TOL)


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("reset", [True, False])
def test_actor_unroll_and_act_match_tpu_rl(scan_mode, reset):
    """DiscreteActorCritic under bf16 compute: the unroll's logits, value
    and final carry, and one act step, at 1e-5 against tpu_rl's."""
    B, S, H = 8, 5, 16
    jcfg = small_config(hidden_size=H, compute_dtype="bfloat16", reset_carry_on_first=reset)
    jfam = jax_build_family(jcfg)
    jparams = jfam.init_params(jax.random.key(0), seq_len=S)
    jactor = with_random_biases(jax.tree_util.tree_map(np.asarray, jparams["actor"]), 5)
    fam = build_family(Config.from_dict({"hidden_size": H, "compute_dtype": "bfloat16",
                                         "reset_carry_on_first": reset}), device="cpu")
    actor = flax_to_state_dict(jactor)
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(B, S, 4)).astype(np.float32)
    firsts = (rng.random((B, S, 1)) < 0.2).astype(np.float32)
    firsts[:2, 0] = 1.0
    h0, c0 = (rng.normal(size=(B, H)).astype(np.float32) for _ in range(2))
    lw, vw, (hw, cw) = jfam.actor_unroll(jactor, obs, (h0, c0), firsts)
    lg, v, (hN, cN) = fam.actor_unroll(actor, *_t(obs), (*_t(h0, c0),), *_t(firsts))
    for got, want, name in ((lg, lw, "logits"), (v, vw, "value"), (hN, hw, "h"), (cN, cw, "c")):
        assert got.dtype == torch.float32
        _close(got, want, name, FWD_ATOL)
    gumbel = rng.gumbel(size=(B, 2)).astype(np.float32)
    # tpu_rl's act draws its own Gumbel noise: hold the distribution and carry
    ja = jfam.act({"actor": jactor}, obs[:, 0], h0, c0, jax.random.key(0))
    a = fam.act({"actor": actor}, *_t(obs[:, 0], h0, c0), gumbel=torch.from_numpy(gumbel))
    for i, name in ((1, "logits"), (3, "h2"), (4, "c2")):
        _close(a[i], ja[i], name, FWD_ATOL)


def test_one_f32_tree_serves_both_dtypes(scan_mode):
    """tests/test_models.py:154-196 for the port: bf16 is a compute
    property, not a storage one. The f32 init tree loads into the bf16
    family unchanged, its outputs are f32 and track the f32 family's to
    bf16 tolerance (atol/rtol 0.05, tpu_rl's bar), and a bf16 IMPALA train
    step keeps f32 params and finite metrics."""
    cfg32 = Config.from_dict(dict(algo="IMPALA", hidden_size=32, batch_size=8, buffer_size=32))
    cfg16 = cfg32.replace(compute_dtype="bfloat16")
    fam32, fam16 = build_family(cfg32, device="cpu"), build_family(cfg16, device="cpu")
    params = fam32.init_params(torch.Generator().manual_seed(0))
    assert all(t.dtype == torch.float32 for t in params["actor"].values())
    assert set(fam16.init_params(torch.Generator().manual_seed(0))["actor"]) == set(params["actor"])
    rng = np.random.default_rng(0)
    obs = torch.from_numpy(rng.normal(size=(4, 5, 4)).astype(np.float32))
    firsts = torch.zeros((4, 5, 1))
    carry0 = (torch.zeros((4, 32)), torch.zeros((4, 32)))
    lo32, v32, _ = fam32.actor_unroll(params["actor"], obs, carry0, firsts)
    lo16, v16, _ = fam16.actor_unroll(params["actor"], obs, carry0, firsts)
    assert lo16.dtype == v16.dtype == torch.float32
    np.testing.assert_allclose(lo16.detach().numpy(), lo32.detach().numpy(), atol=0.05, rtol=0.05)
    assert not torch.equal(lo16, lo32)  # the products really ran in bf16
    _f, state, step = get_algo("IMPALA").build(cfg16, torch.Generator().manual_seed(0), device="cpu")
    batch = Batch.from_mapping(_batch_np(cfg16, 3), device="cpu")
    state, metrics = step(state, batch)
    assert all(t.dtype == torch.float32 for t in state.params["actor"].values())
    for k, v in metrics.items():
        if k != "diag":
            assert bool(torch.isfinite(v).all()), k


# ------------------------------------------------------------ train step
def _jax_bf16_step(train_step, state, batch, key):
    jax_cells.set_pallas_mode("off")
    try:
        return jax.jit(train_step)(state, batch, key)
    finally:
        jax_cells.set_pallas_mode("auto")


@pytest.mark.parametrize("algo", ["PPO", "IMPALA"])
def test_bf16_train_step_matches_tpu_rl(algo):
    """One whole train step under bf16 compute at K_epoch 1 (B8 S5 H16,
    learn_diag on), from tpu_rl's state after one warm-up step (so RMSprop's
    nu is not zero) with perturbed biases, bridged: loss (rtol 1e-5), every
    metric incl. the diag rows, params and nu (1e-5). No B1/B2 call."""
    raw = dict(algo=algo, hidden_size=16, batch_size=8, buffer_size=32, time_horizon=32,
               seq_len=5, obs_shape=(4,), action_space=2, K_epoch=1, learn_diag=True,
               update_guard=True, compute_dtype="bfloat16")
    jcfg = small_config(**raw)
    _jf, jstate, jstep = jax_get_algo(algo).build(jcfg, jax.random.key(0))
    jstate = jstate.replace(params={**jstate.params,
                                    "actor": with_random_biases(jstate.params["actor"], 11)})
    warm = JaxBatch.from_mapping(_batch_np(jcfg, 20))
    jstate, _ = _jax_bf16_step(jstep, jstate, warm, jax.random.key(2))
    jstate = jax.device_get(jstate)
    batch_np = _batch_np(jcfg, 21)
    jnew, jmetrics = _jax_bf16_step(jstep, jstate, JaxBatch.from_mapping(batch_np), jax.random.key(1))
    _f, _s, step = get_algo(algo).build(Config.from_dict(raw), torch.Generator().manual_seed(0),
                                        device="cpu")
    f0, b0 = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
    new, metrics = step(train_state_from_flax(jstate), Batch.from_mapping(batch_np, device="cpu"))
    assert (L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES) == (f0, b0)
    _assert_metrics_close(metrics, jax.device_get(jmetrics))
    jnew = jax.device_get(jnew)
    assert int(new.step) == int(jnew.step)
    want, old = (flax_to_state_dict(s.params["actor"]) for s in (jnew, jstate))
    assert set(new.params["actor"]) == set(want)
    for k, w in want.items():
        atol = 0.05 * float((w - old[k]).abs().max()) if k in BF16_BIASES else 1e-5
        _close(new.params["actor"][k], w, f"params {k}", atol)
    jnu = flax_to_state_dict(next(s.nu for s in jnew.opt_state if hasattr(s, "nu"))["actor"])
    for k, w in jnu.items():
        _close(new.opt_state["nu"]["actor"][k], w, f"nu {k}", 1e-5)
    assert float(metrics["nonfinite-updates"]) == 0.0


@pytest.mark.parametrize("algo", ["V-MPO", "PPO-Continuous", "SAC", "SAC-Continuous"])
def test_other_algorithms_train_under_bf16(algo):
    """The other families take the compute dtype too (the SAC critics'
    torsos and cells included): one train step keeps f32 params, gives
    finite metrics and calls neither B1 nor B2."""
    from tests.test_torch_ppo import SPACES

    obs_shape, n = SPACES[algo]
    cfg = Config.from_dict(dict(algo=algo, hidden_size=16, batch_size=8, buffer_size=32,
                                obs_shape=obs_shape, action_space=n, compute_dtype="bfloat16",
                                is_continuous=algo.endswith("Continuous")))
    fam, state, step = get_algo(algo).build(cfg, torch.Generator().manual_seed(0), device="cpu")
    modules = [fam.actor] + ([fam.critic] if fam.critic is not None else [])
    cells = [m for mod in modules for m in mod.modules() if isinstance(m, LSTMCell)]
    assert cells and all(c.dtype == torch.bfloat16 for c in cells)
    f0, b0 = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
    batch = Batch.from_mapping(_batch_np(cfg, 1, fam.continuous), device="cpu")
    state, metrics = step(state, batch, generator=torch.Generator().manual_seed(1))
    assert (L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES) == (f0, b0)
    params = state.actor_params if fam.separate else state.params["actor"]
    assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all()) for t in params.values())
    for k, v in metrics.items():
        if k != "diag":
            assert bool(torch.isfinite(v).all()), k
    assert float(metrics["nonfinite-updates"]) == 0.0


# ---------------------------------------------------- the fused act kernel
def test_fused_act_refuses_bf16_compute():
    """tpu_rl serves a bf16-compute LSTM through family.act when
    act_kernel='pallas' (its make_fused_act returns None); the port refuses,
    in the config and in make_fused_act, naming the reason."""
    with pytest.raises(NotImplementedError, match="computes in f32 only"):
        Config.from_dict({"compute_dtype": "bfloat16", "act_kernel": "pallas"})
    cfg = Config.from_dict({"compute_dtype": "bfloat16", "act_kernel": "xla"})
    fam = build_family(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="computes in f32 only"):
        make_fused_act(fam)
    # the f32 LSTM still loads with 'pallas'; the transformer, which the
    # fused kernel does not cover, is refused whatever its dtype (ROADMAP C 5)
    assert Config.from_dict({"act_kernel": "pallas"}).act_kernel == "pallas"
    with pytest.raises(NotImplementedError, match="model='transformer'"):
        Config.from_dict({"act_kernel": "pallas", "compute_dtype": "bfloat16",
                          "model": "transformer"})
