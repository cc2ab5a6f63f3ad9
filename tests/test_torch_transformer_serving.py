"""The transformer's acting and serving in the port against ``tpu_rl`` on the
CPU, with ``tpu_rl``'s weights through the bridge (biases and LayerNorm
scales perturbed from their init):

- ``_act_transformer_window`` (the full-window recompute oracle) against
  ``tpu_rl``'s under shared Gumbel noise, past the window: logits at 1e-5
  (f32), equal actions; bf16 compute at ``tpu_rl``'s bf16 bar (rtol 0.05,
  atol 0.03, ``tests/test_transformer.py``);
- the port's KV-cached ``family.act`` against its window oracle over an
  episode as long as the context, at the same bars (the test
  ``tests/test_transformer.py`` holds ``tpu_rl``'s own to);
- one KV step's FLOPs under a twentieth of the window step's at ctx 256,
  counted by ``FlopCounterMode``;
- the served transformer (``InferenceService`` over a ``LocalRouter``)
  against ``tpu_rl``'s own ZMQ service on one scripted stream, at
  ``inference_dtype`` f32, bf16 and int8: logits at 1e-5 tick by tick,
  with caches emptied on ``first``, the ring wrapping past ``act_ctx`` and a
  param swap mid-stream; replies carry no carry and echo ``ver``;
- the carry table: each client's caches stay on the service's device, and
  only obs, first and the rows' table indices cross to it per flush;
- with telemetry on, each bucket's tracker charges the unfused act step
  its ``FlopCounterMode`` count;
- ``act_kernel="pallas"`` with the transformer refused by the config (a
  deliberate divergence: ``tpu_rl`` serves it unfused)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from tests.conftest import small_config
from tests.test_torch_colocated import free_port
from tests.test_torch_transformer import BF16_TOL, TF, _setup, perturbed
from tpu_rl.models.families import _act_transformer_window as jax_window
from tpu_rl.models.families import build_family as jax_build_family
from tpu_rl.runtime.inference_service import InferenceClient
from tpu_rl.runtime.inference_service import InferenceService as JaxInferenceService
from tpu_rl_torch.bridge import flax_to_state_dict
from tpu_rl_torch.config import Config
from tpu_rl_torch.models.families import _act_transformer_window, build_family
from tpu_rl_torch.runtime.inference_service import InferenceService
from tpu_rl_torch.runtime.local_router import LocalRouter

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _gumbel(key, shape):
    return torch.tensor(np.asarray(jax.random.gumbel(key, shape, jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_oracle_matches_tpu_rl(dtype):
    """12 steps at ctx 8: the window fills, then slides."""
    ctx = 8
    jcfg, jfam, jparams, cfg, fam, params = _setup(act_ctx=ctx, compute_dtype=dtype)
    jwin = jax.jit(partial(jax_window, jfam.actor, ctx, 4))
    jh, jc = jnp.zeros((1, ctx * 4)), jnp.zeros((1, 1))
    h, c = torch.zeros(1, ctx * 4), torch.zeros(1, 1)
    rng = np.random.default_rng(5)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for t in range(12):
        obs = rng.normal(size=(1, 4)).astype(np.float32)
        key = jax.random.key(30 + t)
        ja, jl, jlp, jh, jc = jwin(jparams, jnp.asarray(obs), jh, jc, key)
        a, logits, log_prob, h, c = _act_transformer_window(
            fam.actor, ctx, 4, params, torch.from_numpy(obs), h, c, gumbel=_gumbel(key, (1, 2)))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), err_msg=f"step {t}", **tol)
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        if dtype == "float32":
            np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
            np.testing.assert_allclose(log_prob.numpy(), np.asarray(jlp), atol=1e-6)
    assert float(c[0, 0]) == ctx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_act_matches_window_oracle(dtype):
    """The KV-cached act reproduces the window recompute at every step of an
    episode that fills the context, under the same Gumbel draws."""
    ctx = 8
    cfg = Config.from_dict({**TF, "act_ctx": ctx, "compute_dtype": dtype})
    fam = build_family(cfg, device="cpu")
    params = fam.init_params(torch.Generator().manual_seed(3))
    h_kv, c_kv = torch.zeros(1, fam.carry_widths[0]), torch.zeros(1, fam.carry_widths[1])
    h_w, c_w = torch.zeros(1, ctx * 4), torch.zeros(1, 1)
    g = torch.Generator().manual_seed(4)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for t in range(ctx):
        obs = torch.randn((1, 4), generator=g)
        gumbel = -torch.log(-torch.log(torch.rand((1, 2), generator=g)))
        a1, l1, _lp, h_kv, c_kv = fam.act(params, obs, h_kv, c_kv, gumbel=gumbel)
        a2, l2, _lp, h_w, c_w = _act_transformer_window(fam.actor, ctx, 4, params, obs, h_w,
                                                        c_w, gumbel=gumbel)
        np.testing.assert_allclose(l1.numpy(), l2.numpy(), err_msg=f"step {t}", **tol)
        if dtype == "float32":
            assert torch.equal(a1, a2), t


def test_kv_step_is_cheaper_than_the_window():
    """At ctx 256 one cached step costs under a twentieth of the window
    recompute's FLOPs (both counted as they run)."""
    ctx = 256
    cfg = Config.from_dict({**TF, "act_ctx": ctx})
    fam = build_family(cfg, device="cpu")
    params = fam.init_params(torch.Generator().manual_seed(0))
    obs = torch.zeros((1, 4))

    def flops(fn, h, c):
        with FlopCounterMode(display=False) as counter:
            fn(params, obs, h, c)
        return counter.get_total_flops()

    f_kv = flops(fam.act, torch.zeros(1, fam.carry_widths[0]), torch.zeros(1, fam.carry_widths[1]))
    f_win = flops(partial(_act_transformer_window, fam.actor, ctx, 4), torch.zeros(1, ctx * 4),
                  torch.zeros(1, 1))
    assert 0 < f_kv < f_win / 20, (f_kv, f_win)


# ------------------------------------------------------------ serving parity
CTX = 4
# Two clients, 2 envs each, 6 ticks; client 0's env 1 resets at tick 3; the
# other rows run on past act_ctx (4), so their caches' ring wraps. The
# params are swapped (version 5) after tick SWAP.
FIRSTS = [[np.ones(2, np.float32)] * 2] + [[np.zeros(2, np.float32)] * 2] * 2 + [
    [np.array([0.0, 1.0], np.float32), np.zeros(2, np.float32)]
] + [[np.zeros(2, np.float32)] * 2] * 2
SWAP = 3
SERVE = dict(TF, act_ctx=CTX, worker_num_envs=2, inference_batch=8, inference_flush_us=2000)


def _script_obs():
    rng = np.random.default_rng(11)
    return [[rng.standard_normal((2, 4)).astype(np.float32) for _ in range(2)] for _ in FIRSTS]


def _weights(seed):
    jcfg = small_config(**SERVE)
    jparams = jax_build_family(jcfg).init_params(jax.random.key(seed), seq_len=jcfg.seq_len)
    return {"actor": perturbed(jax.tree_util.tree_map(np.asarray, jparams["actor"]), seed + 1)}


def _drive(clients, swap):
    replies = []
    for t, (obs_t, first_t) in enumerate(zip(_script_obs(), FIRSTS, strict=True)):
        replies.append([cl.act(o, f) for cl, o, f in zip(clients, obs_t, first_t, strict=True)])
        if t == SWAP:
            swap()
    return replies


@pytest.fixture(scope="module", params=["f32", "bf16", "int8"])
def jax_served(request):
    """tpu_rl's own service over ZMQ serving the transformer on the
    scripted stream at ``inference_dtype``; its replies."""
    mode = request.param
    port = free_port()
    cfg = small_config(**SERVE, inference_dtype=mode, inference_timeout_ms=10_000,
                       inference_retries=0)
    svc = JaxInferenceService(cfg, jax_build_family(cfg), _weights(0), port=port).start()
    assert svc.wait_ready(120.0) and svc.error is None, svc.error
    clients = [InferenceClient(cfg, "127.0.0.1", port, wid=k) for k in range(2)]
    try:
        replies = _drive(clients, lambda: svc.set_params(_weights(7), version=5))
    finally:
        for cl in clients:
            cl.close()
        svc.close()
    return mode, replies


def test_served_transformer_matches_tpu_rl_service(jax_served):
    mode, want = jax_served
    cfg = Config.from_dict({**SERVE, "inference_dtype": mode})
    family = build_family(cfg, device="cpu")
    router = LocalRouter()
    bridge = lambda w: {"actor": flax_to_state_dict(w["actor"])}  # noqa: E731
    svc = InferenceService(cfg, family, bridge(_weights(0)), router, device="cpu").start()
    assert svc.wait_ready(60.0), svc.error
    clients = [router.client(f"w{k}".encode()) for k in range(2)]
    try:
        got = _drive(clients, lambda: svc.set_params(bridge(_weights(7)), version=5))
    finally:
        svc.close()
    assert svc.error is None, svc.error
    for t, (got_t, want_t) in enumerate(zip(got, want, strict=True)):
        for k, (g, w) in enumerate(zip(got_t, want_t, strict=True)):
            assert g is not None and w is not None, (t, k)
            assert set(g) == set(w) == {"seq", "act", "logits", "log_prob", "ver"}, (t, k)
            assert g["ver"] == w["ver"] == (5 if t > SWAP else -1)
            np.testing.assert_allclose(g["logits"], w["logits"], atol=1e-5, rtol=0,
                                       err_msg=f"tick {t} client {k}")
            for r in (g, w):
                idx = np.asarray(r["act"])[:, 0].astype(int)
                picked = np.asarray(r["logits"])[np.arange(2), idx]
                np.testing.assert_allclose(np.asarray(r["log_prob"])[:, 0], picked, atol=1e-6)
    # the caches live server-side, on the service's device: counters at the
    # script's end (client 0's env 1 restarted at tick 3)
    counts = [svc.clients[f"w{k}".encode()].c[:, -1] for k in range(2)]
    np.testing.assert_array_equal(counts[0], [len(FIRSTS), len(FIRSTS) - 3])
    np.testing.assert_array_equal(counts[1], [len(FIRSTS)] * 2)


def test_carry_stays_on_the_device_side():
    """Per flush only obs, first and each row's table index are copied to
    the service's device; the caches are gathered and scattered there. The
    table holds the padding row plus each client's rows."""
    cfg = Config.from_dict({**SERVE, "inference_buckets": 2})
    family = build_family(cfg, device="cpu")
    router = LocalRouter()
    svc = InferenceService(cfg, family, family.init_params(), router, device="cpu").start()
    assert svc.wait_ready(60.0), svc.error
    try:
        warm = svc.h2d_bytes
        assert warm == sum(4 * rows * (4 + 2) for rows in svc.buckets)
        client = router.client(b"w0")
        for t in range(3):
            reply = client.act(np.ones((2, 4), np.float32), np.full(2, float(t == 0), np.float32))
            assert "hx" not in reply and "cx" not in reply
        assert svc.n_batches == 3 and svc.h2d_bytes - warm == 3 * 4 * 2 * (4 + 2)
        hw, cw = family.carry_widths
        assert svc.carry_bytes >= 4 * 3 * (hw + cw)
        c = svc.clients[b"w0"].c
        assert c.shape == (2, cw) and (c[:, -1] == 3).all()
    finally:
        svc.close()


def test_serving_telemetry_counts_the_act_step():
    """With the plane on, each bucket's tracker charges its warm-up call the
    FLOPs that ``FlopCounterMode`` counts for ``family.act`` at the
    bucket's rows; no flush adds a signature."""
    import tempfile

    cfg = Config.from_dict({**SERVE, "inference_buckets": 2,
                            "result_dir": tempfile.mkdtemp(prefix="tf_serve_")})
    family = build_family(cfg, device="cpu")
    params = family.init_params()
    router = LocalRouter()
    svc = InferenceService(cfg, family, params, router, device="cpu").start()
    assert svc.wait_ready(60.0), svc.error
    try:
        for _ in range(2):
            router.client(b"w0").act(np.ones((2, 4), np.float32), np.zeros(2, np.float32))
        hw, cw = family.carry_widths
        for rows, tracker in svc.perf_buckets.items():
            with FlopCounterMode(display=False) as counter:
                family.act(params, torch.zeros(rows, 4), torch.zeros(rows, hw),
                           torch.zeros(rows, cw))
            assert tracker.flops_per_call == counter.get_total_flops() > 0, rows
        assert sorted(svc.perf_buckets) == svc.buckets == [2, 4, 8] and svc.recompiles == 0
    finally:
        svc.close()


def test_fused_act_refused_for_the_transformer():
    """tpu_rl takes this config and serves the transformer unfused; the port
    refuses it (the fused act kernel covers the LSTM actor-critic only)."""
    from tpu_rl.config import Config as JaxConfig

    assert JaxConfig.from_dict({**TF, "act_kernel": "pallas"}).act_kernel == "pallas"
    for dtype in ("float32", "bfloat16"):
        with pytest.raises(NotImplementedError, match="model='transformer'"):
            Config.from_dict({**TF, "act_kernel": "pallas", "compute_dtype": dtype})
    assert Config.from_dict({"act_kernel": "pallas"}).model == "lstm"
