"""The port's act step against tpu_rl's on the CPU, with bridged weights and
the same numpy inputs: ``fused_act_step_plain`` against the Pallas kernel in
interpret mode, and the port's ``family.act`` / fused act against tpu_rl's.
Tolerance atol 1e-5 on logits, h2, c2 and log_prob (tpu_rl's own kernel
parity bar, tests/test_pallas_act.py); actions must be equal under shared
Gumbel noise. Plus the ``make_act_fn`` dispatch cases, the CUDA kernel's
launch plan (``act_launch_plan``) at every shape tpu_rl's ``act_fits_vmem``
admits, and a torch emulation of the kernel's arithmetic (unit slices,
k-sliced f32 FMA chains in the kernel's order, the rank-ordered head)
against the plain version and the Pallas kernel."""

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
from tpu_rl.ops.pallas_act import act_fits_vmem
from tpu_rl.ops.pallas_act import make_fused_act as jax_make_fused_act
from tpu_rl_torch.bridge import flax_to_state_dict
from tpu_rl_torch.config import Config
from tpu_rl_torch.models.cells import lstm_gates
from tpu_rl_torch.models.families import build_family
from tpu_rl_torch.models.quant import make_act_fn
from tpu_rl_torch.ops import fused_act as FA
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
        with pytest.raises(NotImplementedError, match="covers only the discrete actor-critic"):
            make_fused_act(other)
        with pytest.raises(NotImplementedError, match="covers only the discrete actor-critic"):
            make_act_fn(cfg.replace(act_kernel="pallas"), other)
        assert make_act_fn(cfg, other) is other.act

    @pytest.mark.parametrize("algo", ["PPO-Continuous", "SAC", "SAC-Continuous"])
    def test_other_families_are_refused_as_tpu_rl_leaves_them_unfused(self, algo):
        """tpu_rl's make_fused_act returns None for every family but the
        discrete f32 actor-critic; the port raises for those families."""
        spaces = dict(obs_shape=(3,), action_space=1) if "Continuous" in algo else {}
        jfam = jax_build_family(small_config(algo=algo, **spaces))
        assert jax_make_fused_act(jfam) is None
        fam = build_family(Config(algo=algo, **spaces), device="cpu")
        with pytest.raises(NotImplementedError, match="covers only the discrete actor-critic"):
            make_fused_act(fam)

    def test_cpu_pallas_path_equals_unfused(self):
        """On CPU tensors the fused path is the plain version: the same
        numbers as the module forward, the same sampled actions."""
        *_, cfg, fam, params, (obs, h, c) = _setup(32, 6, 3, 16)
        act = make_act_fn(cfg.replace(act_kernel="pallas"), fam)
        got = act(params, *_t(obs, h, c), torch.Generator().manual_seed(5))
        want = fam.act(params, *_t(obs, h, c), torch.Generator().manual_seed(5))
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


# ------------------------------------------------ the CUDA kernel's launch plan
def _admitted(rows, D, H, A):
    return act_fits_vmem(rows, D, H, A)


def _check_plan(plan, B, H):
    units = [u for sl in plan.slices(H) for u in sl]
    assert units == list(range(H)), "every hidden unit exactly once"
    assert len(plan.slices(H)) == plan.cluster and all(len(sl) > 0 for sl in plan.slices(H))
    assert 1 <= plan.cluster <= FA.MAX_CLUSTER
    assert plan.nonportable == (plan.cluster > FA.MAX_CLUSTER_PORTABLE)
    assert plan.smem <= FA.SMEM_LIMIT and plan.threads <= FA.MAX_THREADS
    assert plan.threads % 32 == 0 and plan.stages >= 2
    assert plan.rows % plan.tm == 0 and plan.rows * plan.row_tiles >= B
    assert (plan.rows // plan.tm) * plan.units * plan.ksplit <= plan.threads
    assert FA.CHUNK % (4 * plan.ksplit) == 0
    if plan.tma:
        assert H % 4 == 0 and plan.units % 4 == 0


@pytest.mark.parametrize("D,A", [(1, 2), (4, 2), (64, 8), (17, 33)])
def test_act_launch_plan_fits_every_admitted_shape(D, A):
    """Every (rows <= 256, H) that tpu_rl's act_fits_vmem admits gets a plan
    the kernel can launch: units covered once, cluster <= 16 (non-portable
    above 8), shared memory <= 227 KB, <= 256 threads; and more blocks work
    than one per 8-row tile wherever H has 16 units to split."""
    n_h = 0
    for H in range(1, 1400):
        for rows in (1, 3, 8, 100, 256):
            if not _admitted(rows, D, H, A):
                continue
            n_h += 1
            plan = FA.act_launch_plan(rows, D, H, A)
            _check_plan(plan, rows, H)
            if H >= 16:
                assert plan.blocks > -(-rows // 8)
    assert n_h > 4000


@pytest.mark.parametrize("B,D,H,A", [(8, 4, 256, 2), (256, 4, 256, 2), (256, 64, 1024, 8)])
def test_act_launch_plan_at_the_checked_shapes(B, D, H, A):
    plan = FA.act_launch_plan(B, D, H, A)
    _check_plan(plan, B, H)
    if H == 256:  # the serving model: 16 slices of 16 units at 8 rows, 8 of 32 at 256
        assert (plan.cluster, plan.units, plan.blocks) == ((16, 16, 16) if B == 8 else (8, 32, 64))


@pytest.mark.parametrize("B,D,H,A", [(0, 4, 256, 2), (8, 0, 256, 2), (8, 4, 256, 0),
                                     (8, 4, 2.5, 2), (8, 4, 8192, 2)])
def test_act_launch_plan_refuses_with_a_named_error(B, D, H, A):
    with pytest.raises(FA.ActPlanError):
        FA.act_launch_plan(B, D, H, A)


# ----------------------------------- a torch emulation of the kernel's arithmetic
def _fma(a, b, c):
    """f32 fused multiply-add: the product exact in float64, one rounding
    to float32 (a double rounding may differ from fmaf by an ulp, rarely)."""
    return (a.double() * b.double() + c.double()).float()


def emulate_kernel(p, obs, h, c, plan):
    """``csrc/fused_act.cu``'s arithmetic on the CPU, in its order: the torso
    per (row, unit) over d ascending; per gate column, ``plan.ksplit`` FMA
    chains, chain s over k in [chunk*32 + s*kq, +kq) of every 32-deep chunk,
    added in chain order; (x Wx^T + bx) + h Wh; each unit slice's share of
    the logits as 32 lane chains (j = lane, lane + 32, ..) reduced by the
    xor-shuffle tree; the slices added in rank order, then the bias and a
    max-subtracted log-softmax summed over actions in order."""
    B, D = obs.shape
    H = h.shape[1]
    wb, bb = p["body.weight"], p["body.bias"]
    wx, bx = p["cell.x_proj.weight"], p["cell.x_proj.bias"]
    wh, wl, bl = p["cell.recurrent_kernel"], p["logits.weight"], p["logits.bias"]
    A = wl.shape[0]

    acc = torch.zeros(B, H)
    for d in range(D):
        acc = _fma(obs[:, d, None], wb[None, :, d], acc)
    x = torch.relu(acc + bb)

    kq = FA.CHUNK // plan.ksplit
    chains = [[k for k in range(H) if (k % FA.CHUNK) // kq == s] for s in range(plan.ksplit)]

    def product(v, w_of_k):
        total = None
        for ks in chains:
            z = torch.zeros(B, 4 * H)
            for k in ks:
                z = _fma(v[:, k, None], w_of_k(k)[None, :], z)
            total = z if total is None else total + z
        return total

    zx = product(x, lambda k: wx[:, k])
    zh = product(h, lambda k: wh[k, :])
    z = (zx + bx) + zh
    h2, c2 = lstm_gates(z, c)

    raw = None
    for sl in plan.slices(H):
        lanes = torch.zeros(32, B, A)
        for lane in range(32):
            for j in list(sl)[lane::32]:
                lanes[lane] = _fma(h2[:, j, None], wl[None, :, j], lanes[lane])
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[torch.arange(32) ^ off]
        raw = lanes[0] if raw is None else raw + lanes[0]
    raw = raw + bl
    m = raw.max(dim=-1, keepdim=True).values
    s = torch.zeros(B, 1)
    for a in range(A):
        s = s + torch.exp(raw[:, a:a + 1] - m)
    return raw - (m + torch.log(s)), h2, c2


# (hidden, obs_dim, actions, rows): the 8- and 256-row buckets of the serving
# model, ragged rows, the default model's H=64, H=100 (13 slices of 8, the
# last of 4 units) and H=50 (4-byte copies, the last slice of 2 units).
EMULATED = [(256, 4, 2, 8), (256, 4, 2, 256), (256, 4, 2, 1), (256, 4, 2, 3), (256, 4, 2, 100),
            (64, 4, 2, 8), (100, 4, 3, 8), (50, 6, 5, 3)]


@pytest.mark.parametrize("shape", EMULATED)
def test_kernel_emulation_matches_plain_and_pallas(shape):
    hidden, obs_dim, actions, batch = shape
    *_, jparams, _cfg, _fam, params, (obs, h, c) = _setup(hidden, obs_dim, actions, batch)
    plan = FA.act_launch_plan(batch, obs_dim, hidden, actions)
    if hidden == 100:
        assert hidden % plan.units != 0
    got = emulate_kernel(params["actor"], *_t(obs, h, c), plan)
    plain = fused_act_step_plain(params["actor"], *_t(obs, h, c))
    want = jax_fused_act_step(jparams["actor"], obs, h, c, interpret=True)
    for g, pl_, w, name in zip(got, plain, want, ("logits", "h2", "c2"), strict=True):
        np.testing.assert_allclose(g.numpy(), pl_.numpy(), atol=ATOL, rtol=0, err_msg=name)
        _close(g, w, name)
