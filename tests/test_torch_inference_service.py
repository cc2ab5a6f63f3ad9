"""The port's InferenceService on the CPU over a LocalRouter: deadline and
full-batch flushes, server-side carries (kept across ticks, reset on
``first``), the parameter swap with version echo, rejected payloads, the
bucket ladder and smallest-covering dispatch (mirroring
tests/test_inference_service.py), and one slice-parity test against
tpu_rl's own InferenceService over ZMQ with bridged weights."""

import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tests.conftest import small_config
from tests.test_torch_bridge import with_random_biases
from tpu_rl.models.families import build_family as jax_build_family
from tpu_rl.runtime.inference_service import InferenceClient
from tpu_rl.runtime.inference_service import InferenceService as JaxInferenceService
from tpu_rl_torch.bridge import flax_to_state_dict
from tpu_rl_torch.config import Config
from tpu_rl_torch.models.families import build_family
from tpu_rl_torch.ops import fused_act as FA
from tpu_rl_torch.runtime.inference_service import InferenceService
from tpu_rl_torch.runtime.local_router import LocalRouter
from tpu_rl_torch.runtime.protocol import Protocol

PARITY_PORT = 30370  # this module's ZMQ port; test_inference_service owns 30150+


def _svc_config(**kw):
    base = dict(
        algo="PPO", hidden_size=16, obs_shape=(4,), action_space=2,
        worker_num_envs=2, inference_batch=8, inference_flush_us=2000,
    )
    base.update(kw)
    return Config.from_dict(base)


def _start_service(**cfg_kw):
    cfg = _svc_config(**cfg_kw)
    family = build_family(cfg, device="cpu")
    params = family.init_params(torch.Generator().manual_seed(0))
    router = LocalRouter()
    svc = InferenceService(cfg, family, params, router, device="cpu").start()
    assert svc.wait_ready(60.0), svc.error
    assert svc.error is None, svc.error
    return cfg, family, params, router, svc


@pytest.fixture
def service(request):
    kw = getattr(request, "param", {})
    cfg, family, params, router, svc = _start_service(**kw)
    yield cfg, family, params, router, svc
    svc.close()
    assert not svc.running and svc.error is None


def _obs(n, cfg, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, int(cfg.obs_shape[0]))).astype(np.float32)


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


@pytest.mark.parametrize("service", [dict(inference_batch=64, inference_flush_us=1500)],
                         indirect=True)
def test_deadline_flush_partial_batch(service):
    cfg, _family, _params, router, svc = service
    reply = router.client(b"w0").act(_obs(2, cfg), np.ones(2, np.float32), timeout_ms=5000)
    # 2 rows can never fill a 64-row batch: only the deadline can flush them
    assert reply is not None and reply["seq"] == 0
    assert reply["act"].shape == (2, 1) and reply["act"].dtype == np.float32
    assert reply["logits"].shape == (2, int(cfg.action_space))
    assert reply["log_prob"].shape == (2, 1)
    assert set(reply) == {"seq", "act", "logits", "log_prob", "ver", "hx", "cx"}
    assert svc.n_flush_deadline >= 1 and svc.n_flush_full == 0


@pytest.mark.parametrize("service", [dict(inference_batch=2, inference_flush_us=2_000_000)],
                         indirect=True)
def test_full_batch_flushes_before_deadline(service):
    cfg, _family, _params, router, svc = service
    t0 = time.perf_counter()
    reply = router.client(b"w0").act(_obs(2, cfg), np.ones(2, np.float32), timeout_ms=5000)
    dt = time.perf_counter() - t0
    assert reply is not None
    assert dt < 1.5, f"full batch waited on the deadline ({dt:.2f}s)"
    assert svc.n_flush_full >= 1 and svc.n_flush_deadline == 0


def test_carry_lives_server_side_and_resets_on_first(service):
    """The first tick acts from (and reports) a zero carry; the next tick's
    reported pre-step carry is the post-step carry of the first, computed
    locally; a ``first`` flag zeroes that row's carry only."""
    cfg, family, params, router, svc = service
    client = router.client(b"w0")
    obs1, obs2, obs3 = (_obs(2, cfg, seed=s) for s in (1, 2, 3))
    r1 = client.act(obs1, np.ones(2, np.float32))
    np.testing.assert_array_equal(r1["hx"], 0.0)
    np.testing.assert_array_equal(r1["cx"], 0.0)
    hw, cw = family.carry_widths
    _a, _lg, _lp, h2, c2 = family.act(
        params, torch.from_numpy(obs1), torch.zeros(2, hw), torch.zeros(2, cw)
    )
    r2 = client.act(obs2, np.zeros(2, np.float32))
    np.testing.assert_allclose(r2["hx"], h2.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r2["cx"], c2.numpy(), rtol=1e-5, atol=1e-6)
    r3 = client.act(obs3, np.array([1.0, 0.0], np.float32))
    np.testing.assert_array_equal(r3["hx"][0], 0.0)
    np.testing.assert_array_equal(r3["cx"][0], 0.0)
    assert np.abs(r3["hx"][1]).max() > 0 and np.abs(r3["cx"][1]).max() > 0
    # every client keeps its own carry: a new identity starts from zeros
    r_other = router.client(b"w1").act(obs2, np.zeros(2, np.float32))
    np.testing.assert_array_equal(r_other["hx"], 0.0)
    assert set(svc.clients) == {b"w0", b"w1"}


def test_a_client_changing_its_row_count_reuses_rows(service):
    """A client that changes its row count starts over from zero rows and
    gives its old rows back: over three changes the carry table keeps the
    size it had after both clients' first contact, and the other client's
    rows are untouched."""
    cfg, _family, _params, router, svc = service
    a, b = router.client(b"a"), router.client(b"b")
    a.act(_obs(4, cfg), np.ones(4, np.float32))
    b.act(_obs(2, cfg, seed=1), np.ones(2, np.float32))
    b.act(_obs(2, cfg, seed=2), np.zeros(2, np.float32))
    flat, b_rows = svc.carry_bytes, svc.clients[b"b"].h
    for n in (2, 4, 2):
        r = a.act(_obs(n, cfg, seed=n), np.zeros(n, np.float32))
        np.testing.assert_array_equal(r["hx"], 0.0)
        np.testing.assert_array_equal(r["cx"], 0.0)
        r = a.act(_obs(n, cfg, seed=n), np.zeros(n, np.float32))
        assert r["hx"].shape == (n, cfg.hidden_size) and np.abs(r["hx"]).max() > 0
        assert svc.carry_bytes == flat, n
    np.testing.assert_array_equal(svc.clients[b"b"].h, b_rows)


def test_carry_table_free_list():
    """Released ranges merge with their free neighbours, are handed out
    again (zeroed) before the table grows, and a free range at the end goes
    back to the unused tail."""
    from tpu_rl_torch.runtime.inference_service import _CarryTable

    t = _CarryTable(3, 2, torch.device("cpu"))
    bases = [t.alloc(n) for n in (2, 3, 4)]
    assert bases == [1, 3, 6] and t.rows == 10
    t.h[1:10] = 7.0
    cap = t.h.shape[0]
    t.release(1, 2)
    t.release(3, 3)
    assert t.free == [(1, 5)]
    assert t.alloc(4) == 1 and t.free == [(5, 1)]
    assert (t.h[1:5] == 0).all() and (t.c[1:5] == 0).all() and (t.h[6:10] == 7).all()
    t.release(6, 4)
    assert t.free == [] and t.rows == 5  # (5, 1) and (6, 4) went back to the tail
    assert t.alloc(4) == 5 and t.h.shape[0] == cap and (t.h[5:9] == 0).all()


def test_nan_carry_does_not_survive_a_reset(service):
    """The reset is a ``where``, not a multiply: a NaN carry row is zeroed by
    ``first`` and the reply is finite."""
    cfg, _family, _params, router, svc = service
    client = router.client(b"w0")
    client.act(_obs(2, cfg), np.ones(2, np.float32))
    svc.clients[b"w0"].h = np.full_like(svc.clients[b"w0"].h, np.nan)
    svc.clients[b"w0"].c = np.full_like(svc.clients[b"w0"].c, np.nan)
    reply = client.act(_obs(2, cfg, seed=5), np.ones(2, np.float32))
    np.testing.assert_array_equal(reply["hx"], 0.0)
    np.testing.assert_array_equal(reply["cx"], 0.0)
    assert np.isfinite(reply["logits"]).all() and np.isfinite(reply["log_prob"]).all()


def test_param_swap_changes_policy_and_echoes_version(service):
    cfg, family, params, router, svc = service
    client = router.client(b"w0")
    obs = _obs(2, cfg, seed=3)
    first = np.ones(2, np.float32)  # zero carry: logits depend on params and obs only
    before = client.act(obs, first)
    again = client.act(obs, first)
    np.testing.assert_allclose(again["logits"], before["logits"], rtol=1e-6)
    assert before["ver"] == -1 and svc.version == -1
    new = family.init_params(torch.Generator().manual_seed(123))
    svc.set_params(new, version=7)
    after = client.act(obs, first)
    assert after["ver"] == 7 and svc.version == 7
    assert not np.allclose(after["logits"], before["logits"])
    want, _h2, _c2 = FA.fused_act_step_plain(
        new["actor"], torch.from_numpy(obs), torch.zeros(2, 16), torch.zeros(2, 16)
    )
    np.testing.assert_allclose(after["logits"], want.numpy(), atol=1e-6)
    # the served tensors are the service's own copies
    assert svc._params["actor"]["body.weight"] is not new["actor"]["body.weight"]


@pytest.mark.timeout(120)
def test_swaps_under_concurrent_traffic_never_tear(service):
    """16 client threads act while the test thread swaps between two
    policies 20 times, with a tiny thread switch interval. Every reply acts
    from a zero carry, so its logits are a function of the params alone:
    they must be those of the version the reply echoes (a torn swap would
    pair one version with the other's weights), and each client sees
    versions in order."""
    cfg, family, _params, router, svc = service
    policies = [family.init_params(torch.Generator().manual_seed(s)) for s in (1, 2)]
    n_clients, acts = 16, 15
    obs = [_obs(2, cfg, seed=100 + k) for k in range(n_clients)]
    zeros = torch.zeros(2, 16)
    want = [[FA.fused_act_step_plain(p["actor"], torch.from_numpy(o), zeros, zeros)[0].numpy()
             for o in obs] for p in policies]
    svc.set_params(policies[0], version=0)
    replies = [[] for _ in range(n_clients)]

    def run(k):
        client = router.client(f"w{k}".encode())
        for _ in range(acts):
            replies[k].append(client.act(obs[k], np.ones(2, np.float32), timeout_ms=20_000))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(n_clients)]
        for t in threads:
            t.start()
        for version in range(1, 21):
            svc.set_params(policies[version % 2], version=version)
            time.sleep(0.002)
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for k in range(n_clients):
        assert len(replies[k]) == acts and all(r is not None for r in replies[k])
        versions = [r["ver"] for r in replies[k]]
        assert versions == sorted(versions), versions
        for r in replies[k]:
            np.testing.assert_allclose(r["logits"], want[r["ver"] % 2][k], atol=1e-5)
    assert svc.error is None and svc.n_requests == svc.n_replies == n_clients * acts


def test_rejected_payloads_do_not_kill_the_service(service):
    cfg, _family, _params, router, svc = service
    bad = router.client(b"bad")
    bad.send(Protocol.ObsRequest, {"seq": 0})  # no obs / first
    bad.send(Protocol.Stat, 1.0)  # wrong protocol entirely
    bad.send(Protocol.ObsRequest, {"seq": 1, "obs": np.zeros((2, 7), np.float32),
                                   "first": np.ones(2, np.float32)})  # wrong obs width
    bad.send(Protocol.ObsRequest, {"seq": 2, "obs": np.zeros((3, 4), np.float32),
                                   "first": np.ones(2, np.float32)})  # rows != firsts
    bad.send(Protocol.ObsRequest, {"seq": 3, "obs": np.zeros((9, 4), np.float32),
                                   "first": np.ones(9, np.float32)})  # > the largest bucket
    reply = router.client(b"good").act(_obs(2, cfg), np.ones(2, np.float32))
    assert reply is not None
    assert _wait(lambda: svc.n_rejected_payload == 5), svc.n_rejected_payload
    assert svc.running and svc.error is None
    assert bad.recv(timeout_ms=50) is None  # nothing answered a rejected request
    assert svc.n_requests == svc.n_replies == 1


def test_fused_act_kernel_path_serves_on_cpu():
    """``act_kernel="pallas"`` on a CPU service takes the fused act's plain
    version: the same replies as the unfused module forward."""
    replies = []
    for kernel in ("xla", "pallas"):
        cfg, _family, _params, router, svc = _start_service(act_kernel=kernel)
        try:
            client = router.client(b"w0")
            r1 = client.act(_obs(2, cfg, seed=1), np.ones(2, np.float32))
            r2 = client.act(_obs(2, cfg, seed=2), np.zeros(2, np.float32))
            replies.append((r1, r2))
        finally:
            svc.close()
    for a, b in zip(*replies, strict=True):
        for key in ("logits", "log_prob", "hx", "cx"):
            np.testing.assert_allclose(a[key], b[key], atol=1e-6, err_msg=key)


@pytest.mark.parametrize("algo", ["PPO-Continuous", "SAC-Continuous", "SAC"])
def test_other_families_are_served(algo):
    """A Gaussian policy's replies carry (n, A) f32 actions, per-dimension
    log-probs and zero logits; SAC's discrete actor replies like the
    actor-critic. The log-prob is the family's own for the action sent."""
    from tpu_rl_torch.ops import distributions as D

    A = 2 if algo != "SAC" else 3
    cfg, family, params, router, svc = _start_service(algo=algo, obs_shape=(3,), action_space=A)
    try:
        reply = router.client(b"w0").act(_obs(2, cfg), np.ones(2, np.float32), timeout_ms=5000)
    finally:
        svc.close()
    wide = A if family.continuous else 1
    assert reply["act"].shape == reply["log_prob"].shape == (2, wide)
    assert reply["logits"].shape == (2, A) and reply["act"].dtype == np.float32
    assert np.isfinite(reply["log_prob"]).all()
    if algo == "PPO-Continuous":
        obs = torch.from_numpy(_obs(2, cfg))
        zeros = torch.zeros(2, 16)
        mu, std, _v, _c = torch.func.functional_call(family.actor, params["actor"],
                                                     (obs, (zeros, zeros)))
        want = D.normal_log_prob(mu, std, torch.from_numpy(reply["act"]))
        np.testing.assert_allclose(reply["log_prob"], want.detach().numpy(), atol=1e-5)
        assert not reply["logits"].any()


def test_close_stops_the_serve_thread(service):
    *_, svc = service
    assert svc.running
    svc.close()
    assert not svc.running and svc.error is None


class TestBucketLadder:
    @pytest.mark.parametrize("kw,want", [
        (dict(inference_batch=64), [64]),  # single fixed shape
        (dict(inference_batch=64, inference_buckets=8), [8, 16, 32, 64]),
        (dict(inference_batch=64, inference_buckets=6), [8, 16, 32, 64]),  # floor -> pow2
        (dict(inference_batch=64, inference_buckets=64), [64]),
        (dict(inference_batch=48, inference_buckets=8), [8, 16, 32, 48]),  # top = pad_rows
        (dict(inference_batch=8, worker_num_envs=32, inference_buckets=8), [8, 16, 32]),
        (dict(inference_batch=256, inference_buckets=8, worker_num_envs=4),
         [8, 16, 32, 64, 128, 256]),  # the serving slice's ladder
    ])
    def test_ladder_shapes(self, kw, want):
        cfg = _svc_config(**kw)
        family = build_family(cfg, device="cpu")
        params = family.init_params(torch.Generator().manual_seed(0))
        svc = InferenceService(cfg, family, params, LocalRouter(), device="cpu")
        assert svc._bucket_ladder() == want

    @pytest.mark.parametrize("service", [dict(inference_batch=16, inference_buckets=4,
                                              inference_flush_us=200, worker_num_envs=16)],
                             indirect=True)
    def test_dispatch_uses_smallest_covering_bucket(self, service):
        cfg, _family, _params, router, svc = service
        assert svc.buckets == [4, 8, 16]
        assert svc.n_flush_bucket == {}  # warm-up runs are not flushes
        client = router.client(b"w0")
        for n, want_bucket in ((3, 4), (4, 4), (5, 8), (11, 16), (16, 16), (1, 4)):
            before = svc.n_flush_bucket.get(want_bucket, 0)
            got = client.act(_obs(n, cfg), np.ones(n, np.float32))
            assert got is not None and got["act"].shape[0] == n
            # counted before the reply is sent: no race with the serve thread
            assert svc.n_flush_bucket.get(want_bucket, 0) == before + 1, (
                n, want_bucket, dict(svc.n_flush_bucket)
            )

    @pytest.mark.parametrize("service", [dict(inference_batch=8, inference_flush_us=200)],
                             indirect=True)
    def test_single_bucket_counts_pad_rows(self, service):
        cfg, _family, _params, router, svc = service
        assert svc.buckets == [8]
        assert router.client(b"w0").act(_obs(2, cfg), np.ones(2, np.float32)) is not None
        assert svc.n_flush_bucket == {8: 1}

    @pytest.mark.parametrize("service", [dict(inference_batch=4, inference_buckets=2,
                                              inference_flush_us=50_000, worker_num_envs=2)],
                             indirect=True)
    def test_burst_drains_in_whole_client_chunks(self, service):
        """Three 2-row clients pending at once against a 4-row top bucket:
        two clients go in one full flush, the third in the next, and no
        client's rows are split."""
        cfg, _family, _params, router, svc = service
        clients = [router.client(f"w{k}".encode()) for k in range(3)]
        for k, cl in enumerate(clients):
            cl.send(Protocol.ObsRequest, {"seq": 0, "obs": _obs(2, cfg, seed=k),
                                          "first": np.ones(2, np.float32)})
        for cl in clients:
            got = cl.recv(timeout_ms=5000)
            assert got is not None and got[1]["act"].shape == (2, 1)
        assert svc.n_batches == 2
        assert svc.n_flush_bucket == {4: 1, 2: 1}


# ----------------------------------------------------------- slice parity
# Two clients, 2 envs each, 3 ticks; client 0's env 1 resets at tick 2.
FIRSTS = [
    [np.ones(2, np.float32), np.ones(2, np.float32)],
    [np.zeros(2, np.float32), np.zeros(2, np.float32)],
    [np.array([0.0, 1.0], np.float32), np.zeros(2, np.float32)],
]
HIDDEN = 32


def _script_obs():
    rng = np.random.default_rng(2024)
    return [[rng.standard_normal((2, 4)).astype(np.float32) for _ in range(2)]
            for _ in FIRSTS]


@pytest.fixture(scope="module")
def jax_replies():
    """tpu_rl's own service over ZMQ, driven by the scripted stream: its
    replies and its actor weights (numpy)."""
    cfg = small_config(
        algo="PPO", hidden_size=HIDDEN, obs_shape=(4,), action_space=2,
        worker_num_envs=2, inference_batch=8, inference_flush_us=2000,
        inference_timeout_ms=10_000, inference_retries=0,
    )
    family = jax_build_family(cfg)
    params = family.init_params(jax.random.key(0), seq_len=cfg.seq_len)
    params = {**params, "actor": with_random_biases(params["actor"], 3)}
    svc = JaxInferenceService(cfg, family, params, port=PARITY_PORT).start()
    assert svc.wait_ready(120.0) and svc.error is None, svc.error
    clients = [InferenceClient(cfg, "127.0.0.1", PARITY_PORT, wid=k) for k in range(2)]
    try:
        replies = [[cl.act(o, f) for cl, o, f in zip(clients, obs_t, first_t, strict=True)]
                   for obs_t, first_t in zip(_script_obs(), FIRSTS, strict=True)]
    finally:
        for cl in clients:
            cl.close()
        svc.close()
    actor = jax.tree_util.tree_map(np.asarray, jax.device_get(params["actor"]))
    return actor, replies


@pytest.mark.parametrize("act_kernel", ["xla", "pallas"])
def test_slice_parity_with_tpu_rl_service(jax_replies, act_kernel):
    """The same weights (bridged) and the same scripted obs/first stream
    through both services: logits, hx and cx agree at 1e-5 tick for tick,
    through the mid-stream reset. Sampled actions differ by design (JAX's
    threefry against torch's Philox), so each side's log_prob is held to
    its own logits at its own action instead."""
    actor, want = jax_replies
    cfg = _svc_config(hidden_size=HIDDEN, act_kernel=act_kernel)
    family = build_family(cfg, device="cpu")
    router = LocalRouter()
    svc = InferenceService(
        cfg, family, {"actor": flax_to_state_dict(actor)}, router, device="cpu"
    ).start()
    assert svc.wait_ready(60.0), svc.error
    clients = [router.client(f"w{k}".encode()) for k in range(2)]
    try:
        got = [[cl.act(o, f) for cl, o, f in zip(clients, obs_t, first_t, strict=True)]
               for obs_t, first_t in zip(_script_obs(), FIRSTS, strict=True)]
    finally:
        svc.close()
    for t, (got_t, want_t) in enumerate(zip(got, want, strict=True)):
        for k, (g, w) in enumerate(zip(got_t, want_t, strict=True)):
            assert g is not None and w is not None, (t, k)
            for key in ("logits", "hx", "cx"):
                np.testing.assert_allclose(
                    g[key], w[key], atol=1e-5, rtol=0, err_msg=f"tick {t} client {k} {key}"
                )
            for r in (g, w):
                idx = np.asarray(r["act"])[:, 0].astype(int)
                picked = np.asarray(r["logits"])[np.arange(2), idx]
                np.testing.assert_allclose(np.asarray(r["log_prob"])[:, 0], picked, atol=1e-6)
    # the reset zeroed client 0's env-1 carry on both sides, and only there
    np.testing.assert_array_equal(got[2][0]["hx"][1], 0.0)
    assert np.abs(got[2][0]["hx"][0]).max() > 0


# ------------------------------------------------------- serving precision
@pytest.mark.parametrize("act_kernel", ["xla", "pallas"])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_quantized_serving_matches_tpu_rl_jitted_step(mode, act_kernel):
    """``inference_dtype`` bf16 / int8: the port's service, given the f32
    weights (bridged), quantizes them as tpu_rl's service does and widens
    them inside each act step. Its replies over the scripted stream match
    tpu_rl's jitted act step (``InferenceService._step_fn``) on tpu_rl's
    own quantized tree, carried tick by tick: logits, hx and cx at 1e-5.
    ``param_bytes`` is tpu_rl's ``tree_bytes`` of that tree; a swap is
    quantized too and served with its version."""
    import jax.numpy as jnp

    from tpu_rl.models.quant import tree_bytes as jax_tree_bytes

    raw = dict(algo="PPO", hidden_size=HIDDEN, obs_shape=(4,), action_space=2, worker_num_envs=2,
               inference_batch=8, inference_flush_us=2000, inference_dtype=mode)
    jcfg = small_config(**raw)
    jfam = jax_build_family(jcfg)
    jparams = jfam.init_params(jax.random.key(0), seq_len=jcfg.seq_len)
    jparams = {"actor": with_random_biases(jax.tree_util.tree_map(np.asarray, jparams["actor"]), 3)}
    jsvc = JaxInferenceService(jcfg, jfam, jparams, port=PARITY_PORT + 1)
    jq = jsvc._quantize(jparams)
    jstep = jax.jit(jsvc._step_fn(jnp))
    carries = [(np.zeros((2, HIDDEN), np.float32),) * 2 for _ in range(2)]
    want = []
    for obs_t, first_t in zip(_script_obs(), FIRSTS, strict=True):
        row = []
        for k in range(2):
            _a, logits, _lp, h, c, h2, c2 = jstep(jq, obs_t[k], *carries[k], first_t[k],
                                                  jax.random.key(k))
            carries[k] = (np.asarray(h2), np.asarray(c2))
            row.append(dict(logits=np.asarray(logits), hx=np.asarray(h), cx=np.asarray(c)))
        want.append(row)

    cfg = _svc_config(hidden_size=HIDDEN, act_kernel=act_kernel, inference_dtype=mode)
    family = build_family(cfg, device="cpu")
    router = LocalRouter()
    svc = InferenceService(
        cfg, family, {"actor": flax_to_state_dict(jparams["actor"])}, router, device="cpu"
    ).start()
    assert svc.wait_ready(60.0), svc.error
    assert svc.param_bytes == jax_tree_bytes(jq)
    clients = [router.client(f"w{k}".encode()) for k in range(2)]
    try:
        got = [[cl.act(o, f) for cl, o, f in zip(clients, obs_t, first_t, strict=True)]
               for obs_t, first_t in zip(_script_obs(), FIRSTS, strict=True)]
        new = build_family(cfg, device="cpu").init_params(torch.Generator().manual_seed(5))
        svc.set_params(new, version=9)
        swapped = clients[0].act(_script_obs()[0][0], np.ones(2, np.float32))
    finally:
        svc.close()
    assert svc.error is None, svc.error
    for t, (got_t, want_t) in enumerate(zip(got, want, strict=True)):
        for k, (g, w) in enumerate(zip(got_t, want_t, strict=True)):
            for key in ("logits", "hx", "cx"):
                np.testing.assert_allclose(
                    g[key], w[key], atol=1e-5, rtol=0, err_msg=f"tick {t} client {k} {key}"
                )
    from tpu_rl_torch.models.quant import dequantize_tree, quantize_tree

    served = dequantize_tree(quantize_tree(new, mode))
    zeros = torch.zeros((2, HIDDEN))
    logits, _v, _c = torch.func.functional_call(
        family.actor, served["actor"], (torch.from_numpy(_script_obs()[0][0]), (zeros, zeros)))
    assert swapped["ver"] == 9
    np.testing.assert_allclose(swapped["logits"], logits.numpy(), atol=1e-6)


# ------------------------------------------------------- the telemetry plane
@pytest.mark.parametrize("act_kernel", ["xla", "pallas"])
def test_serving_telemetry_counts_buckets_flops_and_no_recompiles(act_kernel, tmp_path):
    """With the plane on, each bucket's tracker counted its warm-up call
    (the fused step by B3's formula; the unfused one adds the value head),
    no flush recompiled, and publish_serving_metrics replays the per-bucket
    flush counts without observing a flush twice."""
    from tpu_rl_torch.obs import MetricsRegistry

    cfg, family, _params, router, svc = _start_service(
        act_kernel=act_kernel, inference_buckets=2, result_dir=str(tmp_path),
        inference_flush_us=500,
    )
    try:
        clients = [router.client(f"w{i}".encode()) for i in range(3)]
        for t in range(6):
            for client in clients[: 1 + t % 3]:
                client.act(_obs(2, cfg, seed=t), np.zeros(2, np.float32))
        assert _wait(lambda: svc.n_replies >= 12)
        assert sorted(svc.perf_buckets) == svc.buckets == [2, 4, 8]
        H, A = cfg.hidden_size, cfg.action_space
        for rows, tracker in svc.perf_buckets.items():
            want = FA.act_flops(rows, 4, H, A) + (0 if act_kernel == "pallas" else 2 * rows * H)
            assert tracker.flops_per_call == want, rows
        assert svc.recompiles == 0
        # a swap to params of the same shapes is no new signature
        svc.set_params(family.init_params(torch.Generator().manual_seed(9)), version=1)
        for client in clients:
            client.act(_obs(2, cfg, seed=9), np.zeros(2, np.float32))
        assert _wait(lambda: svc.n_replies >= 15) and svc.recompiles == 0
        reg = MetricsRegistry(role="inference", pid=0, host="h")
        svc.publish_serving_metrics(reg)
        svc.publish_serving_metrics(reg)
        snap = reg.snapshot()
        flushes = {e[1]["rows"]: e[2] for e in snap["counters"]
                   if e[0] == "inference-bucket-flushes"}
        assert flushes == {str(r): n for r, n in svc.n_flush_bucket.items()}
        hist = next(h for h in snap["hists"] if h[0] == "inference-bucket-rows")
        assert hist[4] == sum(svc.n_flush_bucket.values())  # observed once per flush
        counters = {e[0]: e[2] for e in snap["counters"]}
        assert counters["inference-xla-recompiles"] == 0
        ledger = svc.ledger.snapshot()
        assert ledger["buckets"]["compute"] > 0 and ledger["role"] == "inference"
    finally:
        svc.close()


def test_serving_telemetry_off_builds_nothing(service):
    _cfg, _family, _params, _router, svc = service
    assert svc.perf_buckets == {} and svc.ledger is None
    assert svc.recompiles == 0
