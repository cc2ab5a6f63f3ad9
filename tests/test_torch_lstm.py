"""The port's LSTM unroll (``tpu_rl_torch.ops.lstm``) against ``tpu_rl``'s
Pallas kernels B1 and B2 in interpret mode, on the CPU, with the same numpy
inputs. The port's side runs its plain versions (the autograd Function on
CPU tensors). Tolerances are ``tpu_rl``'s own kernel parity bars
(``tests/test_pallas_lstm.py``): 1e-5 on the forward, 3e-5 on gradients.
Plus gradcheck of the plain pair in float64, the model's unroll against
``tpu_rl``'s with bridged weights, and the wrappers' refusal to fall back."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import small_config
from tests.test_torch_bridge import with_random_biases
from tpu_rl.models import cells as jax_cells
from tpu_rl.models.families import build_family as jax_build_family
from tpu_rl.ops import pallas_lstm as PL
from tpu_rl_torch.bridge import flax_to_state_dict
from tpu_rl_torch.config import Config
from tpu_rl_torch.models.families import build_family
from tpu_rl_torch.ops import lstm as L

FWD_ATOL = 1e-5
GRAD_ATOL = 3e-5

# (B, S, H): a one-tile batch, and a ragged one (12 = one 8-row tile + 4).
SHAPES = [(8, 5, 16), (12, 7, 32)]


def _inputs(B, S, H, keep_mode, seed=0):
    rng = np.random.default_rng(seed)
    xp = rng.normal(size=(B, S, 4 * H)).astype(np.float32)
    wh = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    h0 = rng.normal(size=(B, H)).astype(np.float32)
    c0 = rng.normal(size=(B, H)).astype(np.float32)
    if keep_mode == "resets":
        firsts = (rng.random((B, S)) < 0.2).astype(np.float32)
        firsts[:2, 0] = 1.0  # some rows start an episode at step 0
        keep = 1.0 - firsts
    else:  # reset_on_first=False: the carry is never cut
        keep = np.ones((B, S), np.float32)
    return xp, wh, h0, c0, keep


def _t(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("keep_mode", ["resets", "no_reset"])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_pallas_interpret(shape, keep_mode):
    xp, wh, h0, c0, keep = _inputs(*shape, keep_mode)
    hs_j, cs_j, acts_j = PL._pallas_forward(xp, wh, h0, c0, keep, True, save_acts=True)
    hs, cs = L.lstm_unroll(*_t(xp, wh, h0, c0, keep))
    _hs, _cs, acts = L.lstm_fwd(*_t(xp, wh, h0, c0, keep))
    for got, want, name in ((hs, hs_j, "hs"), (cs, cs_j, "cs"), (acts, acts_j, "acts")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL, rtol=0, err_msg=name)
    # the final carry the cell returns
    np.testing.assert_allclose(hs[:, -1].numpy(), np.asarray(hs_j)[:, -1], atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(cs[:, -1].numpy(), np.asarray(cs_j)[:, -1], atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("use_cs", [False, True], ids=["dcs-zero", "dcs-nonzero"])
@pytest.mark.parametrize("keep_mode", ["resets", "no_reset"])
@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_pallas_interpret(shape, keep_mode, use_cs):
    """jax.grad through tpu_rl's custom-VJP unroll (kernel B1 forward, B2
    backward, both interpreted) against the port's autograd Function, with
    respect to xp, wh, h0 and c0. With ``use_cs`` the loss reads cs too, so
    the backward's dcs input is nonzero."""
    B, S, H = shape
    xp, wh, h0, c0, keep = _inputs(*shape, keep_mode, seed=1)
    rng = np.random.default_rng(2)
    w_h = rng.normal(size=(B, S, H)).astype(np.float32)
    w_c = rng.normal(size=(B, S, H)).astype(np.float32) if use_cs else np.zeros((B, S, H), np.float32)

    def jax_loss(xp, wh, h0, c0):
        hs, cs = PL.lstm_unroll(xp, wh, h0, c0, keep, True)
        return jnp.sum(hs * w_h) + jnp.sum(cs * w_c)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(xp, wh, h0, c0)
    txp, twh, th0, tc0 = _t(xp, wh, h0, c0, grad=True)
    hs, cs = L.lstm_unroll(txp, twh, th0, tc0, torch.from_numpy(keep))
    loss = (hs * torch.from_numpy(w_h)).sum()
    if use_cs:
        loss = loss + (cs * torch.from_numpy(w_c)).sum()
    loss.backward()
    for t, w, name in zip((txp, twh, th0, tc0), want, ("dxp", "dwh", "dh0", "dc0"), strict=True):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_backward_plain_matches_pallas_backward_kernel():
    """lstm_bwd (the plain version on CPU tensors) against
    ``_pallas_backward`` called directly, with nonzero dhs and dcs."""
    B, S, H = 12, 7, 32
    xp, wh, h0, c0, keep = _inputs(B, S, H, "resets", seed=3)
    hs, cs, acts = (np.asarray(a) for a in PL._pallas_forward(xp, wh, h0, c0, keep, True, True))
    rng = np.random.default_rng(4)
    dhs, dcs = (rng.normal(size=(B, S, H)).astype(np.float32) for _ in range(2))
    want = PL._pallas_backward(wh, h0, c0, keep, hs, cs, acts, dhs, dcs, True)
    got = L.lstm_bwd(*_t(wh, h0, c0, keep, hs, cs, acts, dhs, dcs))
    for g, w, name in zip(got, want, ("dxp", "dh0", "dc0"), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_gradcheck_plain_pair_float64():
    rng = np.random.default_rng(5)
    B, S, H = 3, 4, 3
    xp, wh, h0, c0 = (
        torch.from_numpy(rng.normal(size=s)).requires_grad_()
        for s in ((B, S, 4 * H), (H, 4 * H), (B, H), (B, H))
    )
    keep = torch.from_numpy((rng.random((B, S)) > 0.3).astype(np.float64))
    keep[0, 0] = 0.0
    assert torch.autograd.gradcheck(L.lstm_unroll, (xp, wh, h0, c0, keep), atol=1e-6)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises; the
    plain version is never taken for it, and CPU calls count no launch."""
    f0, b0 = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
    xp, wh, h0, c0, keep = _inputs(8, 5, 16, "resets")
    meta = [torch.from_numpy(a).to("meta") for a in (xp, wh, h0, c0, keep)]
    with pytest.raises(ValueError, match="unsupported device"):
        L.lstm_fwd(*meta)
    hs = torch.zeros((8, 5, 16), device="meta")
    acts = torch.zeros((8, 5, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        L.lstm_bwd(meta[1], meta[2], meta[3], meta[4], hs, hs, acts, hs, hs)
    L.lstm_unroll(*_t(xp, wh, h0, c0, keep, grad=True))[0].sum().backward()
    assert (L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES) == (f0, b0)


# ------------------------------------------------------- the model's unroll
def _model_setup(hidden, B, S, reset, seed=0):
    jcfg = small_config(hidden_size=hidden, reset_carry_on_first=reset)
    jfam = jax_build_family(jcfg)
    jparams = jfam.init_params(jax.random.key(seed), seq_len=S)
    jparams = {"actor": with_random_biases(jax.tree_util.tree_map(np.asarray, jparams["actor"]), seed + 7)}
    cfg = Config.from_dict({"hidden_size": hidden, "reset_carry_on_first": reset})
    fam = build_family(cfg, device="cpu")
    params = {"actor": flax_to_state_dict(jparams["actor"])}
    rng = np.random.default_rng(seed + 1)
    obs = rng.normal(size=(B, S, 4)).astype(np.float32)
    firsts = (rng.random((B, S, 1)) < 0.2).astype(np.float32)
    firsts[:2, 0] = 1.0
    h0 = rng.normal(size=(B, hidden)).astype(np.float32)
    c0 = rng.normal(size=(B, hidden)).astype(np.float32)
    return jfam, jparams, fam, params, (obs, firsts, h0, c0)


@pytest.mark.parametrize("reset", [True, False])
@pytest.mark.parametrize("hidden,B,S", [(16, 8, 5), (32, 12, 7)])
def test_actor_unroll_matches_tpu_rl(hidden, B, S, reset):
    """``family.actor_unroll`` (DiscreteActorCritic.unroll through
    LSTMCell.unroll and the autograd Function) against tpu_rl's with the
    Pallas kernel interpreted: logits, value and the final carry at 1e-5."""
    jfam, jparams, fam, params, (obs, firsts, h0, c0) = _model_setup(hidden, B, S, reset)
    jax_cells.set_pallas_mode("interpret")
    try:
        want = jfam.actor_unroll(jparams["actor"], obs, (h0, c0), firsts)
    finally:
        jax_cells.set_pallas_mode("auto")
    logits, value, (hN, cN) = fam.actor_unroll(
        params["actor"], *_t(obs), (torch.from_numpy(h0), torch.from_numpy(c0)), *_t(firsts)
    )
    (lw, vw, (hw, cw)) = want
    for got, w, name in ((logits, lw, "logits"), (value, vw, "value"), (hN, hw, "h"), (cN, cw, "c")):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), atol=FWD_ATOL, rtol=0, err_msg=name)
    assert logits.shape == (B, S, 2) and value.shape == (B, S, 1)
