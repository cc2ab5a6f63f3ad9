"""The port's data-parallel train step on gloo ranks (CPU) against
``tpu_rl``'s ``make_parallel_train_step`` on ``make_mesh(n)`` of the virtual
CPU devices, from the same bridged state and the same seeded global batch.

Each rank is a subprocess (``tests/torch_rank_child.py``, torch only) that
trains on its rows of the global batch; the ranks' jobs for 2 and for 4
ranks run once per module. Bars are ``tests/test_parallel.py:83-96``'s:
loss rtol 2e-4 / atol 2e-5, params rtol 2e-3 / atol 2e-5. ``tpu_rl``'s LSTM
runs its plain scan (``set_pallas_mode("off")``), the port's its plain
version: no kernel runs on the CPU. Shared noise: V-MPO's per-epoch
uniforms and SAC-Continuous's normals are ``tpu_rl``'s draws at the global
shape, each rank taking its rows."""

import copy
import threading

import jax
import numpy as np
import pytest
import torch

from tests.conftest import small_config
from tests.test_torch_bridge import with_random_biases
from tests.test_torch_ppo import SPACES, _batch_np
from tests.torch_rank_child import run_ranks
from tpu_rl.algos.registry import get_algo as jax_get_algo
from tpu_rl.models import cells as jax_cells
from tpu_rl.parallel import make_mesh as jax_make_mesh
from tpu_rl.parallel import make_parallel_train_step as jax_pstep
from tpu_rl.parallel import replicate as jax_replicate
from tpu_rl.parallel import shard_batch as jax_shard_batch
from tpu_rl.parallel import shard_chained_batch as jax_shard_chained
from tpu_rl.types import Batch as JaxBatch
from tpu_rl_torch.bridge import sac_state_from_flax, train_state_from_flax

ALGOS = ["PPO", "IMPALA", "V-MPO", "PPO-Continuous", "SAC", "SAC-Continuous"]
WORLDS = [2, 4]
CHAINED = ["IMPALA", "SAC"]
K_CHAIN = 3
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
KEY = 9


def _raw(algo, **kw):
    obs_shape, n = SPACES[algo]
    return {**dict(algo=algo, hidden_size=16, batch_size=8, buffer_size=32, time_horizon=32,
                   seq_len=5, obs_shape=obs_shape, action_space=n, K_epoch=1,
                   update_guard=True), **kw}


def _jax(fn, *args):
    """``fn(*args)`` with tpu_rl's LSTM on its plain scan (no kernel)."""
    jax_cells.set_pallas_mode("off")
    try:
        return jax.device_get(fn(*args))
    finally:
        jax_cells.set_pallas_mode("auto")


def _warm_state(algo, raw):
    """tpu_rl's initial state with perturbed biases, and its step."""
    jcfg = small_config(**raw)
    jfam, jstate, jstep = jax_get_algo(algo).build(jcfg, jax.random.key(0))
    if jfam.separate:
        jstate = jstate.replace(
            actor_params=with_random_biases(jstate.actor_params, 11),
            critic_params=with_random_biases(jstate.critic_params, 12),
            target_critic_params=with_random_biases(jstate.target_critic_params, 13))
    else:
        jstate = jstate.replace(params={**jstate.params,
                                        "actor": with_random_biases(jstate.params["actor"], 11)})
    return jcfg, jfam, jax.device_get(jstate), jstep


def _port_state(jfam, jstate):
    return sac_state_from_flax(jstate) if jfam.separate else train_state_from_flax(jstate)


def _step_kw(algo, batch_np, k_epoch=1):
    """The port's copy of the step's draws tpu_rl makes from KEY."""
    key = jax.random.key(KEY)
    if algo == "V-MPO":
        return {"coef_alpha_u": torch.tensor(
            [float(jax.random.uniform(jax.random.fold_in(key, e), ())) for e in range(k_epoch)])}
    if algo == "SAC-Continuous":
        shape = batch_np["act"].shape
        out = []
        for e in range(k_epoch):
            pair = jax.random.split(jax.random.fold_in(key, e))
            out.append(tuple(torch.tensor(np.asarray(jax.random.normal(k, shape)))
                             for k in pair))
        return {"noise": out}
    return {}


def _leaves(state) -> list[np.ndarray]:
    """A port state's parameters as numpy, in tpu_rl's leaf order."""
    if hasattr(state, "params"):
        tree = {"actor": state.params["actor"]}
        extra = [state.params["duals"][k] for k in ("log_alpha", "log_eta")] \
            if "duals" in state.params else []
        from tpu_rl_torch.bridge import state_dict_to_flax

        return ([np.asarray(x) for x in jax.tree_util.tree_leaves(
            state_dict_to_flax(tree["actor"]))] + [x.numpy() for x in extra])
    from tpu_rl_torch.bridge import state_dict_to_flax

    return ([np.asarray(x) for p in (state.actor_params, state.critic_params,
                                     state.target_critic_params)
             for x in jax.tree_util.tree_leaves(state_dict_to_flax(p))]
            + [state.log_alpha.numpy()])


def _jax_leaves(jstate) -> list[np.ndarray]:
    if hasattr(jstate, "params"):
        p = dict(jstate.params)
        actor = p.pop("actor")
        return ([np.asarray(x) for x in jax.tree_util.tree_leaves(actor)]
                + [np.asarray(p[k]) for k in ("log_alpha", "log_eta") if k in p])
    return ([np.asarray(x) for p in (jstate.actor_params, jstate.critic_params,
                                     jstate.target_critic_params)
             for x in jax.tree_util.tree_leaves(p)] + [np.asarray(jstate.log_alpha)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """tpu_rl's DP results and the port's ranks' results for every case.
    The ranks start as soon as their jobs are built and run while tpu_rl's
    programs compile."""
    refs: dict = {}
    jobs = {w: [] for w in WORLDS}
    index: dict = {}
    todo = []  # (key, fn, args) of tpu_rl's reference runs

    def add(world, key, job):
        index[(world, key)] = len(jobs[world])
        jobs[world].append(job)

    def ref(key, fn, *args):
        todo.append((key, fn, args))

    for algo in ALGOS:
        raw = _raw(algo)
        jcfg, jfam, jstate, jstep = _warm_state(algo, raw)
        batch_np = _batch_np(jcfg, 21, jfam.continuous)
        state = _port_state(jfam, jstate)
        for world in WORLDS:
            mesh = jax_make_mesh(world)
            ref((world, algo), jax_pstep(jstep, mesh, jcfg), jax_replicate(jstate, mesh),
                jax_shard_batch(JaxBatch.from_mapping(batch_np), mesh),
                jax_replicate(jax.random.key(KEY), mesh))
            add(world, algo, dict(kind="dp", raw=raw, state=copy.deepcopy(state),
                                  batches=[batch_np], kw=[_step_kw(algo, batch_np)]))
    for algo in CHAINED:
        raw = _raw(algo, learn_diag=True)
        jcfg, jfam, jstate, jstep = _warm_state(algo, raw)
        batches = [_batch_np(jcfg, 30 + i, jfam.continuous) for i in range(K_CHAIN)]
        mesh = jax_make_mesh(4)
        ref((4, "chain", algo), jax_pstep(jstep, mesh, jcfg, chain=K_CHAIN),
            jax_replicate(jstate, mesh),
            jax_shard_chained([JaxBatch.from_mapping(b) for b in batches], mesh),
            jax_replicate(jax.random.key(KEY), mesh))
        add(4, ("chain", algo), dict(kind="dp", raw=raw, state=_port_state(jfam, jstate),
                                     batches=batches, kw=[{}] * K_CHAIN))
    # the guard: a NaN behaviour log-prob in rank 0's rows only
    raw = _raw("PPO")
    jcfg, jfam, jstate, jstep = _warm_state("PPO", raw)
    bad = _batch_np(jcfg, 22)
    bad["log_prob"][0, 0, 0] = np.nan
    mesh = jax_make_mesh(2)
    ref((2, "guard"), jax_pstep(jstep, mesh, jcfg), jax_replicate(jstate, mesh),
        jax_shard_batch(JaxBatch.from_mapping(bad), mesh),
        jax_replicate(jax.random.key(KEY), mesh))
    refs[(2, "guard", "before")] = _port_state(jfam, jstate)
    add(2, "guard", dict(kind="dp", raw=raw, state=_port_state(jfam, jstate), batches=[bad],
                         kw=[{}]))
    add(2, "mismatch", dict(kind="replicate_check", raw=raw, state=_port_state(jfam, jstate)))

    out: dict = {}
    errors: list = []
    # made here: two threads making pytest's base temp dir at once race
    dirs = {w: str(tmp_path_factory.mktemp(f"w{w}")) for w in WORLDS}

    def go(world):
        try:
            out[world] = run_ranks(jobs[world], world, dirs[world])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=go, args=(w,)) for w in WORLDS]
    for t in threads:
        t.start()
    for key, fn, args in todo:
        refs[key] = _jax(fn, *args)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return refs, out, index


def _results(runs, world, key):
    _refs, out, index = runs
    return [out[world][r][index[(world, key)]] for r in range(world)]


def _assert_ranks_equal(res):
    for r in res[1:]:
        for a, b in zip(_leaves(res[0]["state"]), _leaves(r["state"]), strict=True):
            np.testing.assert_array_equal(a, b)
        assert float(r["metrics"]["loss"]) == float(res[0]["metrics"]["loss"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("algo", ALGOS)
def test_dp_step_matches_tpu_rl(runs, algo, world):
    """Every rank ends with the same state, and it is tpu_rl's DP step's at
    the loss and params bars; V-MPO's top-half selection and softmax are
    the global batch's."""
    refs = runs[0]
    jstate, jmetrics = refs[(world, algo)]
    res = _results(runs, world, algo)
    _assert_ranks_equal(res)
    np.testing.assert_allclose(float(res[0]["metrics"]["loss"]), float(jmetrics["loss"]),
                               **LOSS_TOL)
    for a, b in zip(_leaves(res[0]["state"]), _jax_leaves(jstate), strict=True):
        np.testing.assert_allclose(a, b, **PARAM_TOL)
    assert float(res[0]["metrics"]["nonfinite-updates"]) == 0.0


@pytest.mark.parametrize("algo", CHAINED)
def test_chained_step_matches_tpu_rl(runs, algo):
    """chain=3 over 4 ranks: the state and the last update's loss of
    tpu_rl's chained program; ``nonfinite-updates`` summed over the chain;
    the diag rows of every update in update-major, global row order."""
    jstate, jmetrics = runs[0][(4, "chain", algo)]
    res = _results(runs, 4, ("chain", algo))
    _assert_ranks_equal(res)
    m = res[0]["metrics"]
    np.testing.assert_allclose(float(m["loss"]), float(jmetrics["loss"]), **LOSS_TOL)
    for a, b in zip(_leaves(res[0]["state"]), _jax_leaves(jstate), strict=True):
        np.testing.assert_allclose(a, b, **PARAM_TOL)
    assert float(m["nonfinite-updates"]) == float(jmetrics["nonfinite-updates"]) == 0.0
    assert float(m["diag"]["n-updates"]) == float(jmetrics["diag"]["n-updates"]) == K_CHAIN
    assert set(m["diag"]["rows"]) == set(jmetrics["diag"]["rows"])
    for k, want in jmetrics["diag"]["rows"].items():
        assert m["diag"]["rows"][k].shape == (K_CHAIN * 8,)
        np.testing.assert_allclose(m["diag"]["rows"][k].numpy(), np.asarray(want),
                                   rtol=2e-3, atol=2e-5, err_msg=k)


def test_guard_decides_the_same_on_every_rank(runs):
    """A NaN in rank 0's rows only: the reduced grads are NaN on every rank,
    so every rank skips the update (as tpu_rl's step does) and keeps its
    state."""
    jstate, jmetrics = runs[0][(2, "guard")]
    before = runs[0][(2, "guard", "before")]
    res = _results(runs, 2, "guard")
    assert float(jmetrics["nonfinite-updates"]) == 1.0
    for r in res:
        assert float(r["metrics"]["nonfinite-updates"]) == 1.0
        for a, b in zip(_leaves(r["state"]), _leaves(before), strict=True):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(res[0]["state"]), _jax_leaves(jstate), strict=True):
        np.testing.assert_allclose(a, b, **PARAM_TOL)


def test_replicate_refuses_ranks_that_disagree(runs):
    """replicate() broadcasts rank 0's state, after checking that every rank
    already held it: a rank with other weights makes it raise on all."""
    for r in _results(runs, 2, "mismatch"):
        assert "held another state than rank 0" in r["error"]


def test_batch_not_divisible_raises():
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.parallel import make_parallel_train_step
    from tpu_rl_torch.parallel.mesh import DATA_AXIS, Mesh

    mesh = Mesh(world=4, rank=0, device=torch.device("cpu"), backend="gloo",
                shape={DATA_AXIS: 4}, coords={DATA_AXIS: 0}, groups={})
    cfg = Config.from_dict(_raw("PPO", batch_size=6))
    _f, _s, step = get_algo("PPO").build(cfg, torch.Generator().manual_seed(0), device="cpu",
                                         mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        make_parallel_train_step(step, mesh, cfg)
    with pytest.raises(ValueError, match="not divisible"):
        jax_pstep(lambda s, b, k: (s, {}), jax_make_mesh(4), small_config(batch_size=6))
    # a step built without the mesh as its hook is refused
    _f, _s, plain = get_algo("PPO").build(cfg.replace(batch_size=8),
                                          torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="collective hook"):
        make_parallel_train_step(plain, mesh)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_host_local_batch_to_global(n):
    """Each rank's rows from its host's local rows equal tpu_rl's placement
    of the same global batch on device ``rank`` (one host; and one host per
    rank, feeding only its own block); a host block that does not cover the
    rank's rows fails tpu_rl's coverage assert."""
    from tpu_rl.parallel.mesh import batch_sharding as jax_batch_sharding
    from tpu_rl.parallel.multihost import host_local_batch_to_global as jax_place
    from tpu_rl_torch.parallel.mesh import RowShard
    from tpu_rl_torch.parallel.multihost import host_local_batch_to_global

    rng = np.random.default_rng(n)
    batch = {"obs": rng.normal(size=(16, 5, 4)).astype(np.float32),
             "rew": rng.normal(size=(16, 5, 1)).astype(np.float32)}
    placed = jax_place(batch, jax_batch_sharding(jax_make_mesh(n)))
    for rank in range(n):
        shard = RowShard(rank, n)
        one_host = host_local_batch_to_global(batch, shard, host_rows=RowShard(0, 1))
        own = host_local_batch_to_global({k: v[shard.of(16)] for k, v in batch.items()}, shard)
        for k in batch:
            want = np.asarray(placed[k].addressable_shards[rank].data)
            np.testing.assert_array_equal(one_host[k].numpy(), want)
            np.testing.assert_array_equal(own[k].numpy(), want)
    with pytest.raises(AssertionError, match="does not cover"):
        host_local_batch_to_global({k: v[:16 // n] for k, v in batch.items()}, RowShard(1, n),
                                   host_rows=RowShard(0, n))
