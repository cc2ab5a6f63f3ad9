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


# ------------------------------------------------- the CUDA kernels' launch plan
def _resident_fits(H):
    """Whether a resident block (one row) fits at any cluster size."""
    for c in range(1, L.MAX_CLUSTER + 1):
        U = -(-H // c)
        if -(-H // U) <= L.MAX_CLUSTER and max(L.resident_smem(H, 1, U, -(-H // U))) <= L.SMEM_LIMIT:
            return True
    return False


@pytest.mark.parametrize("H", [16, 50, 64, 100, 256, 1024])
@pytest.mark.parametrize("B", [1, 3, 8, 100, 128, 1024])
def test_lstm_launch_plan_fits_the_card(B, H):
    """Every unit once, cluster <= 16 (non-portable above 8), shared memory
    <= 227 KB for both kernels, the thread tile covering the block, rows
    covering the batch, and the regime switching where wh's slice no longer
    fits."""
    S = 5
    plan = L.lstm_launch_plan(B, S, H)
    units = [u for sl in plan.slices(H) for u in sl]
    assert units == list(range(H)), "every hidden unit exactly once"
    assert len(plan.slices(H)) == plan.cluster and all(len(sl) > 0 for sl in plan.slices(H))
    assert 1 <= plan.cluster <= L.MAX_CLUSTER
    assert plan.nonportable == (plan.cluster > L.MAX_CLUSTER_PORTABLE)
    assert max(plan.smem_fwd, plan.smem_bwd) <= L.SMEM_LIMIT
    assert plan.rows % plan.tm == 0 and plan.units % plan.tu == 0
    assert plan.row_tiles == -(-B // plan.rows)
    assert plan.resident == _resident_fits(H)
    if plan.resident:
        assert (plan.tm, plan.tu) in L.RESIDENT_TILES and plan.threads <= L.MAX_RESIDENT_THREADS
        assert plan.threads == (plan.rows // plan.tm) * (plan.units // plan.tu)
        assert (plan.smem_fwd, plan.smem_bwd) == L.resident_smem(H, plan.rows, plan.units, plan.cluster)
        assert plan.push == (plan.rows * H <= L.PUSH_MAX_FLOATS)
        assert plan.scratch_floats(H) == (0 if plan.push else
                                          2 * plan.row_tiles * plan.cluster * H * plan.rows)
    else:
        assert (plan.tm, plan.tu) == L.STREAMED_TILE and plan.rows in L.STREAMED_ROWS
        assert plan.threads == 32 * plan.units // plan.tu <= L.STREAMED_MAX_THREADS
        assert H % 4 == 0 and plan.units % 16 == 0 and 2 <= plan.stages <= 4
        sf, sb = L.streamed_stage(plan.rows, plan.units)
        assert plan.smem_fwd == 4 * max(plan.stages * sf, plan.rows * L.stream_ldw(plan.units))
        assert plan.smem_bwd == 4 * plan.stages * sb
        assert (plan.smem_fwd, plan.smem_bwd) == L.streamed_smem(plan.rows, plan.units, plan.stages)
        assert not plan.push
        assert plan.scratch_floats(H) == 2 * plan.row_tiles * plan.cluster * H * plan.rows
    assert plan.regime == ("streamed" if H == 1024 else "resident")


@pytest.mark.parametrize("B,S,H,plan", [
    # the training path, the learning run, a ragged batch: clusters of 8
    # slices of 8 units, 8-row tiles of one-row, one-unit threads
    (128, 5, 64, (8, 8, 8, 16, 1)), (32, 5, 64, (8, 8, 8, 4, 1)), (100, 5, 64, (8, 8, 8, 13, 1)),
    # resident at H=256: 4-row threads on the shortest tiles of one wave,
    # B2's partials through L2 (above PUSH_MAX_FLOATS)
    (256, 16, 256, (20, 32, 8, 13, 4)),
    # streamed: 80-row tiles, 13 clusters of 8 (an H100 holds 15)
    (1024, 16, 1024, (80, 128, 8, 13, 16)),
])
def test_lstm_launch_plan_at_the_checked_shapes(B, S, H, plan):
    """The plans the card's timings chose (lab/b12_lab.py plans):
    (rows, units, cluster, row tiles, rows a thread or an m-tile)."""
    p = L.lstm_launch_plan(B, S, H)
    assert (p.rows, p.units, p.cluster, p.row_tiles, p.tm) == plan
    assert p.row_tiles <= L.CLUSTERS_PER_CARD[8] * (1 if H >= 256 else 8)
    assert p.push == (H == 64) and p.stages == (0 if p.resident else 2)


@pytest.mark.parametrize("B,S,H", [(0, 5, 64), (8, 0, 64), (8, 5, 0), (8, 5, 2.5),
                                   (8, 5, 1026), (8, 5, 8192)])
def test_lstm_launch_plan_refuses_with_a_named_error(B, S, H):
    with pytest.raises(L.LstmPlanError):
        L.lstm_launch_plan(B, S, H)


# ----------------------------------- a torch emulation of the kernels' arithmetic
def _fma(a, b, c):
    """f32 fused multiply-add: the product exact in float64, one rounding
    to float32."""
    return (a.double() * b.double() + c.double()).float()


def _gates(z, c_used, H):
    sig = lambda v: 1.0 / (1.0 + torch.exp(-v))  # noqa: E731
    i, f, o = sig(z[:, :H]), sig(z[:, H:2 * H]), sig(z[:, 3 * H:])
    g = torch.tanh(z[:, 2 * H:3 * H])
    c2 = f * c_used + i * g
    return o * torch.tanh(c2), c2, torch.cat([i, f, g, o], -1)


def _round(x, bits):
    """x rounded to ``23 - bits`` mantissa bits, to nearest, ties away from
    zero, by integer add and mask as the kernels do."""
    i = x.contiguous().view(torch.int32)
    return ((i + (1 << (bits - 1))) & -(1 << bits)).view(torch.float32)


def _mma_split(acc, a, b):
    """``acc += a @ b`` over one 8-deep k step as the streamed kernels do it:
    x = hi + lo with hi x rounded to TF32; the cross terms hi*lo + lo*hi
    with every value rounded to bf16 (one BF16 mma), then hi*hi (one TF32
    mma), each summed exactly into a fresh f32 sum, which is then added to
    acc. The order inside one mma is the card's; it is taken exact here."""
    ah, bh = _round(a, 13), _round(b, 13)
    al, bl = a - ah, b - bh
    bf = lambda x: _round(x, 16).double()  # noqa: E731
    d = (bf(ah) @ bf(bl) + bf(al) @ bf(bh)).float()
    d = (d.double() + ah.double() @ bh.double()).float()
    return acc + d


def emulate_lstm_fwd(xp, wh, h0, c0, keep, plan):
    """``csrc/lstm_fwd.cu``'s arithmetic in its order. Resident: per step
    one FMA chain per gate column over k ascending, on h with keep[t]
    applied (as pushed). Streamed: split precision (``_mma_split``) over
    8-deep k steps ascending on h as read, keep[t] times the product. Then
    the gates."""
    B, S, G = xp.shape
    H = G // 4
    h, c = h0, c0
    hs, cs, acts = [], [], []
    for t in range(S):
        kp = keep[:, t, None]
        acc = torch.zeros(B, G)
        if plan.resident:
            hin = h * kp
            for k in range(H):
                acc = _fma(hin[:, k, None], wh[None, k, :], acc)
            z = xp[:, t] + acc
        else:
            for k in range(0, H, 8):
                acc = _mma_split(acc, h[:, k:k + 8], wh[k:k + 8])
            z = xp[:, t] + kp * acc
        h, c, a = _gates(z, c * kp, H)
        hs.append(h)
        cs.append(c)
        acts.append(a)
    return torch.stack(hs, 1), torch.stack(cs, 1), torch.stack(acts, 1)


def emulate_lstm_bwd(wh, h0, c0, keep, hs, cs, acts, dhs, dcs, plan):
    """``csrc/lstm_bwd.cu``'s arithmetic in its order: the gate gradients;
    each unit slice q's partial dh over its own gate columns in the block's
    order (gate-major, units ascending, a ragged slice padded with zeros):
    resident, one FMA chain per output; streamed, split precision over 8
    columns at a time; the slices' partials added in rank order, then keep[t]."""
    B, S, H = hs.shape
    U = plan.units
    dh = torch.zeros(B, H)
    dc = torch.zeros(B, H)
    dzs = [None] * S
    for t in reversed(range(S)):
        kp = keep[:, t, None]
        i, f, g, o = torch.chunk(acts[:, t], 4, dim=-1)
        cp = (cs[:, t - 1] if t > 0 else c0) * kp
        dh_t = dhs[:, t] + dh
        tc = torch.tanh(cs[:, t])
        dc_t = dcs[:, t] + dc + dh_t * o * (1.0 - tc * tc)
        dz = torch.cat([dc_t * g * i * (1.0 - i), dc_t * cp * f * (1.0 - f),
                        dc_t * i * (1.0 - g * g), dh_t * tc * o * (1.0 - o)], -1)
        total = None
        for sl in plan.slices(H):
            cols = [gate * H + u for gate in range(4) for u in range(sl.start, sl.start + U)]
            real = torch.tensor([u < sl.stop for gate in range(4) for u in range(sl.start, sl.start + U)])
            idx = torch.tensor([c if ok else 0 for c, ok in zip(cols, real.tolist())])
            dzq = dz[:, idx] * real
            whq = wh[:, idx] * real
            part = torch.zeros(B, H)
            if plan.resident:
                for c in range(4 * U):
                    part = _fma(dzq[:, c, None], whq[None, :, c], part)
            else:
                for c in range(0, 4 * U, 8):
                    part = _mma_split(part, dzq[:, c:c + 8], whq[:, c:c + 8].T)
            total = part if total is None else total + part
        dh = total * kp
        dc = dc_t * f * kp
        dzs[t] = dz
    return torch.stack(dzs, 1), dh, dc


# (B, S, H): the training path's H at 8-row tiles, H=50 (13 slices, the
# last of 2 units), a one-row tile, and the streamed regime (H=512).
EMULATED = [(16, 5, 64), (3, 5, 50), (12, 7, 32), (1, 3, 16), (3, 3, 512)]


@pytest.mark.parametrize("shape", EMULATED)
def test_kernel_emulation_matches_plain_and_pallas(shape):
    B, S, H = shape
    plan = L.lstm_launch_plan(B, S, H)
    assert plan.regime == ("streamed" if H == 512 else "resident")
    xp, wh, h0, c0, keep = _inputs(B, S, H, "resets", seed=6)
    keep[B // 2:, 0] = 0.0
    txp, twh, th0, tc0, tkeep = _t(xp, wh, h0, c0, keep)
    got = emulate_lstm_fwd(txp, twh, th0, tc0, tkeep, plan)
    plain = L.lstm_forward_plain(txp, twh, th0, tc0, tkeep)
    want = PL._pallas_forward(xp, wh, h0, c0, keep, True, save_acts=True)
    for g, p, w, name in zip(got, plain, want, ("hs", "cs", "acts"), strict=True):
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=FWD_ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FWD_ATOL, rtol=0, err_msg=name)

    hs, cs, acts = (np.asarray(a) for a in want)
    rng = np.random.default_rng(7)
    dhs, dcs = (rng.normal(size=(B, S, H)).astype(np.float32) for _ in range(2))
    args = _t(wh, h0, c0, keep, hs, cs, acts, dhs, dcs)
    got = emulate_lstm_bwd(*args, plan)
    dxp, _dwh, dh0, dc0 = L.lstm_backward_plain(*args)
    want = PL._pallas_backward(wh, h0, c0, keep, hs, cs, acts, dhs, dcs, True)
    for g, p, w, name in zip(got, (dxp, dh0, dc0), want, ("dxp", "dh0", "dc0"), strict=True):
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=GRAD_ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0, err_msg=name)


# ------------------------------------------- B1/B2 calls on each train path
def _count_kernel_calls(monkeypatch):
    """Count the calls of the kernel wrappers ``lstm_fwd``/``lstm_bwd`` (on
    the CPU they run the plain versions; on the card each call is one
    launch, counted by the wrappers themselves)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = L.lstm_fwd, L.lstm_bwd

    def count_fwd(*a):
        calls["fwd"] += 1
        return fwd(*a)

    def count_bwd(*a):
        calls["bwd"] += 1
        return bwd(*a)

    monkeypatch.setattr(L, "lstm_fwd", count_fwd)
    monkeypatch.setattr(L, "lstm_bwd", count_bwd)
    return calls


def test_unroll_without_grad_is_b1_alone(monkeypatch):
    """Under ``torch.no_grad()``, or with no input that requires a gradient,
    ``lstm_unroll`` is one B1 call that saves nothing: no graph, no B2; with
    a gradient it is one B1 and, on backward, one B2."""
    calls = _count_kernel_calls(monkeypatch)
    g = torch.Generator().manual_seed(0)
    xp, wh, h0, c0 = (torch.randn(s, generator=g) for s in ((3, 4, 32), (8, 32), (3, 8), (3, 8)))
    keep = torch.ones(3, 4)
    with torch.no_grad():
        hs, _cs = L.lstm_unroll(xp, wh.requires_grad_(), h0, c0, keep)
    assert hs.grad_fn is None and calls == {"fwd": 1, "bwd": 0}
    hs, _cs = L.lstm_unroll(xp, wh.detach(), h0, c0, keep)
    assert hs.grad_fn is None and calls == {"fwd": 2, "bwd": 0}
    hs, _cs = L.lstm_unroll(xp.requires_grad_(), wh.detach(), h0, c0, keep)
    (dxp,) = torch.autograd.grad(hs.sum(), [xp])
    assert calls == {"fwd": 3, "bwd": 1} and dxp.shape == xp.shape


# B1 / B2 calls per epoch of each algorithm's train step (chip_smoke.py
# asserts the same counts on the card): one unroll with its backward for the
# shared-torso algorithms; SAC's are listed in tpu_rl_torch/algos/sac.py.
LAUNCHES_PER_EPOCH = {"PPO": (1, 1), "IMPALA": (1, 1), "V-MPO": (1, 1), "PPO-Continuous": (1, 1),
                      "SAC": (8, 3), "SAC-Continuous": (8, 5)}


@pytest.mark.parametrize("algo", sorted(LAUNCHES_PER_EPOCH))
def test_kernel_calls_per_train_step(monkeypatch, algo):
    from tests.test_torch_ppo import SPACES, _batch_np
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.types import Batch

    obs_shape, n = SPACES[algo]
    cfg = Config.from_dict(dict(algo=algo, hidden_size=16, batch_size=8, buffer_size=32,
                                obs_shape=list(obs_shape), action_space=n, K_epoch=2))
    family, state, step = get_algo(algo).build(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = Batch.from_mapping(_batch_np(cfg, 0, family.continuous), device="cpu")
    calls = _count_kernel_calls(monkeypatch)
    step(state, batch, torch.Generator().manual_seed(1))
    fwd, bwd = LAUNCHES_PER_EPOCH[algo]
    assert calls == {"fwd": 2 * fwd, "bwd": 2 * bwd}
