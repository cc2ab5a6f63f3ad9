"""The port's Sebulba split (``tpu_rl_torch.runtime.sebulba``) against
``tpu_rl``'s on the CPU: ``BoundedPipe``'s units on both classes; the
split's partitions and refusals beside ``tpu_rl``'s on its 8 CPU devices;
the config refusals; the loop over the test seam's devices (``["cpu",
"cpu"]``, and an actor group of two): it trains to its budget with both
ledgers, the queue bound, staleness at most depth + 1, and a learner state
equal, bit for bit, to the colocated train step replaying the batches the
lane consumed; a learner group of two gloo ranks; one learner-lane update
from bridged weights against ``tpu_rl``'s ``SebulbaLoop.train`` on a 4 + 4
split (``tests/test_torch_ppo.py``'s bars); a checkpointed run resumed
with the run epoch bumped; and the config path refusing a split of one
device."""

import copy
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_bridge import with_random_biases
from tests.test_torch_ppo import _assert_metrics_close, _assert_states_close, _batch_np
from tests.torch_rank_child import run_ranks
from tpu_rl.config import Config as JaxConfig
from tpu_rl.models import cells as jax_cells
from tpu_rl.obs.goodput import GoodputLedger as JaxLedger
from tpu_rl.runtime import sebulba as jax_sebulba
from tpu_rl.types import Batch as JaxBatch
from tpu_rl_torch.bridge import train_state_from_flax
from tpu_rl_torch.config import Config
from tpu_rl_torch.obs.goodput import GoodputLedger
from tpu_rl_torch.runtime import sebulba
from tpu_rl_torch.runtime.colocated import ColocatedLoop
from tpu_rl_torch.types import Batch
from tpu_rl_torch.utils.tree import tree_leaves

PIPES = [pytest.param((jax_sebulba.BoundedPipe, JaxLedger), id="tpu_rl"),
         pytest.param((sebulba.BoundedPipe, GoodputLedger), id="port")]


def _kw(**kw):
    base = dict(env="CartPole-v1", env_mode="colocated", algo="PPO", colocated_envs=16,
                hidden_size=16, seq_len=5, time_horizon=100, sebulba_split=1, sebulba_queue=2,
                loss_log_interval=5, learner_device="cpu")
    base.update(kw)
    return base


# ------------------------------------------------------------- BoundedPipe
@pytest.mark.parametrize("cls", PIPES)
def test_pipe_backpressure_bounds_depth_and_attributes_wait(cls):
    """tests/test_sebulba.py's unit on either class: a fast producer
    blocks (no drop, no growth), the high-watermark stays within the depth,
    and the blocked span lands in the producer's queue-wait bucket."""
    pipe_cls, ledger_cls = cls
    pipe = pipe_cls(2)
    led = ledger_cls("producer")
    got: list[int] = []

    def consume():
        for _ in range(8):
            time.sleep(0.02)
            got.append(pipe.get())

    t = threading.Thread(target=consume)
    t.start()
    for i in range(8):
        assert pipe.put(i, ledger=led, poll_s=0.005)
    t.join(timeout=10)
    assert got == list(range(8))
    assert 1 <= pipe.peak_depth <= pipe.depth == 2
    assert led.snapshot()["buckets"]["queue-wait"] > 0.0


@pytest.mark.parametrize("cls", PIPES)
def test_pipe_get_waits_on_empty(cls):
    pipe_cls, ledger_cls = cls
    pipe = pipe_cls(3)
    led = ledger_cls("consumer")

    def produce():
        time.sleep(0.05)
        pipe.put("x")

    t = threading.Thread(target=produce)
    t.start()
    assert pipe.get(ledger=led, poll_s=0.005) == "x"
    t.join(timeout=10)
    assert led.snapshot()["buckets"]["queue-wait"] >= 0.04


@pytest.mark.parametrize("cls", PIPES)
def test_pipe_stop_unsticks_both_sides(cls):
    """A set stop event unsticks a blocked put (False, item not enqueued)
    and a blocked get (None)."""
    pipe = cls[0](1)
    stop = threading.Event()
    assert pipe.put("a", stop=stop, poll_s=0.005)
    stop.set()
    t0 = time.perf_counter()
    assert pipe.put("b", stop=stop, poll_s=0.005) is False
    assert pipe.get(stop=None, poll_s=0.005) == "a"
    assert pipe.get(stop=stop, poll_s=0.005) is None
    assert time.perf_counter() - t0 < 5.0


# ---------------------------------------------------------------- topology
@pytest.mark.parametrize("split", [0, 1, 2, 7, 8, 9])
def test_split_partitions_like_tpu_rl(split):
    """On 8 devices each package gives the actor group the first ``split``
    devices and the learner the rest, and refuses the same splits with a
    ValueError naming sebulba_split and the count."""
    devices = [f"cuda:{i}" for i in range(8)]
    try:
        jacts, jlearns = jax_sebulba.split_local_devices(split)
    except ValueError as e:
        assert "sebulba_split" in str(e) and "=8" in str(e)
        with pytest.raises(ValueError, match=r"sebulba_split=.*len\(devices\)=8"):
            sebulba.split_local_devices(split, devices)
        return
    acts, learns = sebulba.split_local_devices(split, devices)
    assert [d.index for d in acts] == [d.id for d in jacts]
    assert [d.index for d in learns] == [d.id for d in jlearns]


def test_split_refuses_one_device_on_the_config_path():
    """The config path partitions the host's real devices: the CPU is one,
    so every split is refused, naming the count, before anything runs (on
    one card likewise, naming torch.cuda.device_count())."""
    from tpu_rl_torch.runtime.runner import colocated_role

    with pytest.raises(ValueError, match="sebulba_split=1 must partition the CPU's device count=1"):
        colocated_role(Config.from_dict(_kw()))
    with pytest.raises(ValueError, match="sebulba_split=1"):
        sebulba.SebulbaLoop(Config.from_dict(_kw()), device="cpu")


@pytest.mark.parametrize("raw,msg", [
    (dict(multihost={"coordinator": "x:1", "num_processes": 2, "process_id": 0}), "per-host"),
    (dict(learner_chain=2), "learner_chain"),
    (dict(env_mode="distributed", colocated_envs=0), "env_mode='colocated'"),
    (dict(sebulba_queue=0), "0"),
    (dict(sebulba_split=-1), "-1"),
], ids=["multihost", "chain", "distributed", "queue0", "split-1"])
def test_config_refusals_match_tpu_rl(raw, msg):
    with pytest.raises(AssertionError, match=msg):
        JaxConfig.from_dict(_kw(**raw))
    with pytest.raises(AssertionError, match=msg):
        Config.from_dict(_kw(**raw))


# ----------------------------------------------------------- the real loop
def _replay(loop, init_state):
    """The colocated train step replaying the batches the lane consumed,
    each with its update's generator."""
    ref = ColocatedLoop(Config.from_dict(_kw(sebulba_split=0)), seed=0, device="cpu")
    state = init_state
    for _it, seed_it, _ver, batch in loop.consumed:
        state, _m = ref.train_step(state, batch, torch.Generator().manual_seed(seed_it))
    return state


@pytest.mark.parametrize("devices", [["cpu", "cpu"], ["cpu", "cpu", "cpu"]],
                         ids=["1+1", "2+1"])
def test_loop_trains_with_bounded_queue_and_replays_bit_for_bit(tmp_path, devices):
    """The two lanes end to end on the test seam's devices (1 + 1, and an
    actor group of two stepping 8 envs each): the update budget, episodes,
    the queue bound, staleness at most depth + 1, compute and queue-wait on
    both lane ledgers, the queue gauges; and the learner's final state equal,
    bit for bit, to the colocated train step replaying the consumed batches
    from the initial state."""
    split = len(devices) - 1
    cfg = Config.from_dict(_kw(sebulba_split=split, result_dir=str(tmp_path), time_horizon=20))
    loop = sebulba.SebulbaLoop(cfg, seed=0, max_updates=12, device="cpu", devices=devices,
                               record_batches=True)
    assert len(loop.act_devices) == split and loop.n_local == 16 // split
    init = copy.deepcopy(loop.state)
    out = loop.run(log=False)
    assert out["updates"] == 12 == len(loop.consumed)
    assert out["episodes"] > 0
    assert 1 <= out["queue_peak_depth"] <= cfg.sebulba_queue
    assert 0 <= out["max_staleness"] <= cfg.sebulba_queue + 1
    assert [it for it, *_ in loop.consumed] == list(range(12))
    roles = {led.role: led.snapshot()["buckets"] for led in loop._ledgers()}
    assert set(roles) == {"sebulba-actor", "sebulba-learner"}
    for r in roles.values():
        assert r["compute"] > 0.0
    assert roles["sebulba-actor"]["queue-wait"] + roles["sebulba-learner"]["queue-wait"] > 0.0
    assert set(loop._goodput_payload()["roles"]) == {"sebulba-actor", "sebulba-learner"}
    doc = json.loads((tmp_path / "telemetry.json").read_text())
    names = {g[0] for src in doc["sources"] for g in src["gauges"]}
    assert {"sebulba-queue-depth", "sebulba-queue-peak-depth"} <= names
    want = _replay(loop, init)
    for a, b in zip(tree_leaves(loop.state.params), tree_leaves(want.params), strict=True):
        assert torch.equal(a, b)
    assert int(loop.state.step) == 12


def test_lanes_hold_their_invariants_under_a_short_switch_interval():
    """The lanes share a params slot, the stats slot and the pipe: with the
    interpreter switching threads every 10 µs, the queue bound, the
    staleness bound and the replay equality still hold."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        loop = sebulba.SebulbaLoop(Config.from_dict(_kw(time_horizon=20, sebulba_queue=1)),
                                   seed=1, max_updates=10, device="cpu",
                                   devices=["cpu", "cpu"], record_batches=True)
        init = copy.deepcopy(loop.state)
        out = loop.run(log=False)
    finally:
        sys.setswitchinterval(old)
    assert out["updates"] == 10 and out["queue_peak_depth"] == 1
    assert out["max_staleness"] <= 2
    want = _replay(loop, init)
    for a, b in zip(tree_leaves(loop.state.params), tree_leaves(want.params), strict=True):
        assert torch.equal(a, b)


def test_learner_group_of_two_ranks_matches_the_replay(tmp_path):
    """A learner group of two gloo ranks (devices cpu x 3, split 1): rank 0
    runs both lanes and scatters each batch's rows, rank 1 follows; both
    end on the same params, which equal the one-device replay of the
    consumed batches at the data-parallel bars (params rtol 1e-4, atol
    1e-5)."""
    raw = _kw(time_horizon=20)
    res = run_ranks([dict(kind="sebulba", raw=raw, devices=["cpu"] * 3, updates=6)], 2,
                    str(tmp_path))
    r0, r1 = res[0][0], res[1][0]
    assert r0["world"] == r1["world"] == 2
    assert r0["run"]["updates"] == 6 and r1["updates"] == 6
    torch.testing.assert_close(r1["params"], r0["params"], rtol=0, atol=0)
    cfg = Config.from_dict(_kw(sebulba_split=0))
    ref = ColocatedLoop(cfg, seed=0, device="cpu")
    state = ref.state
    for _it, seed_it, _v, batch in r0["consumed"]:
        state, _m = ref.train_step(state, batch, torch.Generator().manual_seed(seed_it))
    want = torch.cat([t.reshape(-1) for t in state.params["actor"].values()])
    np.testing.assert_allclose(r0["params"].numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


def test_learner_lane_update_matches_tpu_rl_split(monkeypatch):
    """One learner-lane update: tpu_rl's ``SebulbaLoop.train`` over the
    learner half of a 4 + 4 split of its CPU devices (after one warm-up
    update, so RMSprop's nu is not zero), and the port's learner lane from
    the bridged state on the same batch: metrics, params and nu at
    tests/test_torch_ppo.py's bars."""
    jcfg = JaxConfig(**_kw(sebulba_split=4, learner_device="auto"))
    jloop = jax_sebulba.SebulbaLoop(jcfg, seed=0, max_updates=1)
    assert len(jloop.mesh.devices.flat) == 4 and len(jloop.act_mesh.devices.flat) == 4
    jstate = jloop.state.replace(params={"actor": with_random_biases(jloop.state.params["actor"], 5)})
    cfg = Config.from_dict(_kw())
    warm, batch_np = _batch_np(jloop.cfg, 30), _batch_np(jloop.cfg, 31)
    jax_cells.set_pallas_mode("off")
    try:
        jstate, _m = jloop.train(jstate, JaxBatch.from_mapping(warm), jax.random.key(1))
        jstate = jax.device_get(jstate)
        jnew, jmetrics = jloop.train(jstate, JaxBatch.from_mapping(batch_np), jax.random.key(2))
    finally:
        jax_cells.set_pallas_mode("auto")
    loop = sebulba.SebulbaLoop(cfg, seed=0, device="cpu", devices=["cpu", "cpu"])
    state = train_state_from_flax(jstate)
    new, metrics = loop.train_step(state, Batch.from_mapping(batch_np, device="cpu"),
                                   loop._learn_generator(1))
    _assert_metrics_close(metrics, jax.device_get(jmetrics))
    _assert_states_close(new, jax.device_get(jnew))


def test_checkpointed_run_resumes_with_the_epoch_bumped(tmp_path):
    """A run checkpointed every 3 updates to 6, then a fresh loop to 9:
    it resumes at the committed index 6 with run epoch 1 (a resume record
    in learner_resume.jsonl), its actor stream continuing at batch 6."""
    kw = _kw(model_dir=str(tmp_path / "models"), model_save_interval=3,
             result_dir=str(tmp_path / "run"), ckpt_async=False)
    first = sebulba.SebulbaLoop(Config.from_dict(kw), seed=0, max_updates=6, device="cpu",
                                devices=["cpu", "cpu"])
    assert first.run(log=False)["updates"] == 6 and first.run_epoch == 0
    second = sebulba.SebulbaLoop(Config.from_dict(kw), seed=0, max_updates=9, device="cpu",
                                 devices=["cpu", "cpu"], record_batches=True)
    out = second.run(log=False)
    assert (out["updates"], second._start_it, second.run_epoch) == (9, 6, 1)
    assert [it for it, *_ in second.consumed] == [6, 7, 8]
    lines = [json.loads(x) for x in (tmp_path / "run" / "learner_resume.jsonl").read_text()
             .splitlines()]
    assert [(r["idx"], r["epoch"]) for r in lines] == [(6, 1)]
    from tpu_rl_torch.checkpoint import latest_committed, read_meta

    idx, path = latest_committed(str(tmp_path / "models"), "PPO")
    assert idx == 9 and read_meta(path)["epoch"] == 1


def test_derived_streams_are_stateless():
    """A batch's actor stream and an update's learner stream depend on the
    index alone: the same index, the same draws."""
    a = sebulba.derive_seed(0, sebulba.ACT_STREAM, 5, 0)
    assert a == sebulba.derive_seed(0, sebulba.ACT_STREAM, 5, 0)
    assert a != sebulba.derive_seed(0, sebulba.ACT_STREAM, 6, 0)
    assert a != sebulba.derive_seed(0, sebulba.ACT_STREAM, 5, 1)
    assert a != sebulba.derive_seed(1, sebulba.ACT_STREAM, 5, 0)
    assert 0 <= a < 2**63
