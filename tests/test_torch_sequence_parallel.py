"""The port's ring and Ulysses attention on gloo ranks (CPU) against
``tpu_rl``'s own, ``shard_map``-ped over ``make_sp_mesh`` of the virtual CPU
devices, at ``tests/test_sequence_parallel.py:65,85``'s bars (outputs atol
2e-5, grads atol 3e-4) on the same seeded inputs; causal and segment
masking through the ring; the ring's backward residuals against the shard,
not the ring; and the transformer's PPO step under ``mesh_seq`` against
``tpu_rl``'s ``make_sp_train_step`` (loss rtol 2e-4 / atol 2e-5, params
rtol 2e-3 / atol 2e-5, ``tests/test_parallel.py:83-96``'s bars). The ranks
are subprocesses (``tests/torch_rank_child.py``, torch only)."""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from tests.conftest import small_config
from tests.test_torch_transformer import _batch_np, perturbed
from tests.torch_rank_child import run_ranks
from tpu_rl.algos.registry import get_algo as jax_get_algo
from tpu_rl.parallel import make_sp_train_step as jax_sp_step
from tpu_rl.parallel import replicate as jax_replicate
from tpu_rl.parallel.mesh import shard_map
from tpu_rl.parallel.sequence import DATA_AXIS, SEQ_AXIS
from tpu_rl.parallel.sequence import make_sp_mesh as jax_sp_mesh
from tpu_rl.parallel.sequence import ring_attention as jax_ring
from tpu_rl.parallel.sequence import ulysses_attention as jax_ulysses
from tpu_rl.types import Batch as JaxBatch
from tpu_rl_torch.bridge import train_state_from_flax

# (world, mesh): the rank meshes of the cases
MESHES = [(2, (1, 2)), (4, (1, 4)), (4, (2, 2))]
IMPLS = {"ring": jax_ring, "ulysses": jax_ulysses}
OUT_ATOL, GRAD_ATOL = 2e-5, 3e-4
TF = dict(algo="PPO", model="transformer", hidden_size=16, n_heads=4, n_layers=1, seq_len=8,
          batch_size=4, buffer_size=8, obs_shape=(4,), action_space=2, K_epoch=1)
STEP_CASES = [(2, (1, 2), "ring"), (4, (2, 2), "ulysses")]


def _inputs(seed, B=2, T=32, H=4, D=8, n_segments=3):
    """tests/test_sequence_parallel.py's inputs: global positions, segment
    ids from random seams, and a cotangent for the grads."""
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(4))
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    firsts = np.zeros((B, T), np.int32)
    firsts[:, 0] = 1
    for b in range(B):
        firsts[b, rng.choice(np.arange(1, T), size=n_segments - 1, replace=False)] = 1
    seg = np.cumsum(firsts, axis=1).astype(np.int32)
    return dict(q=q, k=k, v=v, pos=pos, seg=seg, w=w)


def _jax_attn(impl, mesh_shape, x):
    """tpu_rl's impl over its (data, seq) mesh: output and grads of
    sum(o * w)."""
    mesh = jax_sp_mesh(*mesh_shape)
    qs, ps = P(DATA_AXIS, SEQ_AXIS, None, None), P(DATA_AXIS, SEQ_AXIS)
    attn = shard_map(functools.partial(IMPLS[impl], axis_name=SEQ_AXIS, causal=True),
                     mesh=mesh, in_specs=(qs, qs, qs, ps, ps), out_specs=qs)
    pos, seg, w = (jnp.asarray(x[n]) for n in ("pos", "seg", "w"))

    def loss(q, k, v):
        o = attn(q, k, v, pos, seg)
        return (o * w).sum(), o

    (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x[n]) for n in ("q", "k", "v")))
    return {"o": np.asarray(o), "dq": np.asarray(g[0]), "dk": np.asarray(g[1]),
            "dv": np.asarray(g[2])}


def _jax_sp_step(world, mesh_shape, impl):
    """tpu_rl's transformer PPO step on its (data, seq) mesh, and the port's
    job for the same state and batch."""
    raw = dict(TF, attention_impl=impl, mesh_data=mesh_shape[0], mesh_seq=mesh_shape[1])
    jcfg = small_config(**raw)
    mesh = jax_sp_mesh(*mesh_shape)
    _f, jstate, jstep = jax_get_algo("PPO").build(jcfg, jax.random.key(0), mesh=mesh)
    jstate = jax.device_get(jstate.replace(
        params={"actor": perturbed(jax.device_get(jstate.params["actor"]), 3)}))
    batch = _batch_np(TF["batch_size"], TF["seq_len"], 21)
    step = jax_sp_step(jstep, mesh, jcfg)
    ref = jax.device_get(step(jax_replicate(jstate, mesh), JaxBatch.from_mapping(batch),
                              jax_replicate(jax.random.key(1), mesh)))
    job = dict(kind="sp_step", raw=raw, mesh=mesh_shape, state=train_state_from_flax(jstate),
               batch=batch)
    return ref, job


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    refs, jobs, index = {}, {2: [], 4: []}, {}

    def add(world, key, job):
        index[key] = (world, len(jobs[world]))
        jobs[world].append(job)

    x = _inputs(0)
    x16 = _inputs(1, T=16)
    for world, mesh in MESHES:
        for impl in IMPLS:
            refs[("attn", impl, mesh)] = _jax_attn(impl, mesh, x)
            add(world, ("attn", impl, mesh), dict(kind="attn", impl=impl, mesh=mesh, **x))
            refs[("attn16", impl, mesh)] = _jax_attn(impl, mesh, x16)
            add(world, ("attn16", impl, mesh), dict(kind="attn", impl=impl, mesh=mesh, **x16))
    # masking through the ring: one episode, then perturbed future K/V; two
    # episodes, then perturbed K/V of the first
    one = _inputs(2, B=2, T=8, n_segments=1)
    future = dict(one, k=one["k"].copy(), v=one["v"].copy())
    future["k"][:, 5:] = 0.0
    future["v"][:, 5:] = 99.0
    two = dict(one, seg=np.repeat(np.array([[1] * 4 + [2] * 4], np.int32), 2, axis=0))
    past = dict(two, k=two["k"].copy(), v=two["v"].copy())
    past["k"][:, :4] = 7.0
    past["v"][:, :4] = -3.0
    for name, inp in (("one", one), ("future", future), ("two", two), ("past", past)):
        add(2, ("mask", name), dict(kind="attn", impl="ring", mesh=(1, 2), **inp))
    for world, mesh, impl in STEP_CASES:
        refs[("step", impl)], job = _jax_sp_step(world, mesh, impl)
        add(world, ("step", impl), job)
    # the ring's residuals at 2 and at 4 seq ranks over one global sequence
    add(2, ("resid", 2), dict(kind="attn", impl="ring", mesh=(1, 2), **_inputs(3, T=64)))
    add(4, ("resid", 4), dict(kind="attn", impl="ring", mesh=(1, 4), **_inputs(3, T=64)))

    out, errors = {}, []
    # made here: two threads making pytest's base temp dir at once race
    dirs = {w: str(tmp_path_factory.mktemp(f"sp{w}")) for w in (2, 4)}

    def go(world):
        try:
            out[world] = run_ranks(jobs[world], world, dirs[world])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=go, args=(w,)) for w in (2, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]

    def results(key):
        world, i = index[key]
        return [out[world][r][i] for r in range(world)]

    return refs, results


def _assemble(res, name, shape):
    """The global tensor from every rank's (rows, cols) block."""
    full = np.zeros(shape, np.float32)
    for r in res:
        full[r["rows"], r["cols"]] = r[name].numpy()
    return full


@pytest.mark.parametrize("mesh", [m for _, m in MESHES], ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("impl", list(IMPLS))
def test_sharded_matches_tpu_rl(runs, impl, mesh):
    refs, results = runs
    want = refs[("attn", impl, mesh)]
    got = _assemble(results(("attn", impl, mesh)), "o", want["o"].shape)
    np.testing.assert_allclose(got, want["o"], atol=OUT_ATOL)


@pytest.mark.parametrize("mesh", [m for _, m in MESHES], ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("impl", list(IMPLS))
def test_sharded_gradients_match_tpu_rl(runs, impl, mesh):
    refs, results = runs
    want = refs[("attn16", impl, mesh)]
    res = results(("attn16", impl, mesh))
    for n in ("dq", "dk", "dv"):
        np.testing.assert_allclose(_assemble(res, n, want[n].shape), want[n], atol=GRAD_ATOL,
                                   err_msg=n)


def test_ring_causal_masking(runs):
    """Row t of the ring's output does not depend on keys and values past t,
    wherever they sit in the ring."""
    _refs, results = runs
    out1 = _assemble(results(("mask", "one")), "o", (2, 8, 4, 8))
    out2 = _assemble(results(("mask", "future")), "o", (2, 8, 4, 8))
    np.testing.assert_allclose(out1[:, :5], out2[:, :5], atol=1e-6)
    assert not np.allclose(out1[:, 5:], out2[:, 5:])


def test_ring_segment_masking_blocks_cross_episode(runs):
    """The second episode's rows (on the second rank) do not see the
    first episode's keys and values (on the first rank)."""
    _refs, results = runs
    out1 = _assemble(results(("mask", "two")), "o", (2, 8, 4, 8))
    out2 = _assemble(results(("mask", "past")), "o", (2, 8, 4, 8))
    np.testing.assert_allclose(out1[:, 4:], out2[:, 4:], atol=1e-6)
    assert not np.allclose(out1[:, :4], out2[:, :4])


def test_ring_backward_residuals_scale_with_shard_not_ring(runs):
    """What the ring saves for its backward is O(T / n) per rank: q, k, v,
    the output and the row log-sum-exp of its shard (positions and segment
    ids too), never the rotating blocks; a 4-ring's rank saves half of a
    2-ring's over the same sequence."""
    _refs, results = runs
    r2 = max(r["saved_bytes"] for r in results(("resid", 2)))
    r4 = max(r["saved_bytes"] for r in results(("resid", 4)))
    qkv4 = 3 * 2 * (64 // 4) * 4 * 8 * 4  # q, k, v of one 4-ring shard, f32
    assert r4 <= 0.55 * r2, (r2, r4)
    assert r4 <= 2.5 * qkv4, (r4, qkv4)


@pytest.mark.parametrize("impl", [c[2] for c in STEP_CASES])
def test_transformer_step_matches_make_sp_train_step(runs, impl):
    """The transformer's PPO step under mesh_seq (ring over (1, 2), Ulysses
    over (2, 2)) against tpu_rl's make_sp_train_step on its mesh: every
    rank ends with the same state, tpu_rl's at the DP bars. The loss's scans
    see the whole window (outputs all-gathered along the seq group), and
    each seq rank's n_seq-fold gradient is divided out by the world mean."""
    refs, results = runs
    (jstate, jmetrics) = refs[("step", impl)]
    res = results(("step", impl))
    from tpu_rl_torch.bridge import state_dict_to_flax

    want = jax.tree_util.tree_leaves(jstate.params["actor"])
    for r in res:
        np.testing.assert_allclose(float(r["metrics"]["loss"]), float(jmetrics["loss"]),
                                   rtol=2e-4, atol=2e-5)
        got = jax.tree_util.tree_leaves(state_dict_to_flax(r["state"].params["actor"]))
        for a, b in zip(got, want, strict=True):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-3, atol=2e-5)
