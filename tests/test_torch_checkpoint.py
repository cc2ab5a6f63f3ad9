"""Crash-atomic checkpoints and resume in the port (``tpu_rl_torch.checkpoint``
and ``ColocatedLoop``), on the CPU: the torch counterparts of
``tests/test_durability.py:48-207,308-329`` (a torn save is invisible, init
cleans torn directories, a corrupt marker reads as empty meta, the GC keeps
the newest, async saves equal sync ones, latest-wins, a writer's error
surfaces, the fingerprint refusal and its override, runtime knobs do not
change the fingerprint, and the run meta round-trips the random
generator's state), plus ``copy_committed``, the fingerprint against
``tpu_rl``'s, every train state of the port (``SACState`` included), and
the colocated loop's save and resume."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from tpu_rl_torch.algos.registry import get_algo
from tpu_rl_torch.checkpoint import (
    COMMIT_MARKER,
    Checkpointer,
    copy_committed,
    is_committed,
    latest_committed,
    read_meta,
    restore_actor_params,
    resume_fingerprint,
)
from tpu_rl_torch.config import Config
from tpu_rl_torch.runtime.colocated import ColocatedLoop


def _state(val: float = 1.0):
    return {
        "params": {
            "actor": {"w": torch.full((3, 2), val)},
            "critic": {"w": torch.full((2,), -val)},
        },
        "step": torch.zeros((), dtype=torch.int32),
    }


def _plant_torn(model_dir: str, algo: str, idx: int) -> str:
    """A torn save: a checkpoint-shaped directory with NO commit marker."""
    path = os.path.join(model_dir, f"{algo}_{idx}")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "state.pt"), "w") as f:
        f.write("torn mid-write")
    return path


# --------------------------------------------------------------- atomicity
def test_torn_checkpoint_invisible_to_readers(tmp_path):
    d = str(tmp_path)
    ck = Checkpointer(d, "PPO")
    ck.save(_state(1.0), 100)
    torn = _plant_torn(d, "PPO", 200)  # newer idx, never committed
    assert not is_committed(torn)
    assert latest_committed(d, "PPO") == (100, os.path.join(d, "PPO_100"))
    assert ck.latest_idx() == 100
    got, idx = ck.restore_latest(_state(0.0))
    assert idx == 100
    assert torch.equal(got["params"]["actor"]["w"], torch.full((3, 2), 1.0))
    actor = restore_actor_params(d, "PPO")
    assert torch.equal(actor["actor"]["w"], torch.full((3, 2), 1.0))
    ck.close()


def test_init_cleans_torn_dirs(tmp_path):
    d = str(tmp_path)
    ck = Checkpointer(d, "PPO")
    ck.save(_state(), 100)
    ck.close()
    _plant_torn(d, "PPO", 200)
    ck2 = Checkpointer(d, "PPO")
    assert sorted(os.listdir(d)) == ["PPO_100"]
    ck2.close()


def test_corrupt_marker_reads_as_empty_meta(tmp_path):
    d = str(tmp_path)
    ck = Checkpointer(d, "PPO")
    path = ck.save(_state(), 100)
    with open(os.path.join(path, COMMIT_MARKER), "w") as f:
        f.write("{not json")
    assert read_meta(path) == {}
    ck.close()


def test_gc_keeps_newest_and_skips_uncommitted(tmp_path):
    d = str(tmp_path)
    ck = Checkpointer(d, "PPO", keep=2)
    torn = _plant_torn(d, "PPO", 50)
    for idx in (100, 200, 300):
        ck.save(_state(), idx)
    assert sorted(os.listdir(d)) == ["PPO_200", "PPO_300", "PPO_50"]
    assert os.path.isdir(torn)
    ck.close()


# ---------------------------------------------------------------- asynchrony
def test_async_save_equivalent_to_sync(tmp_path):
    """flush() after an async save gives what a sync save writes; the meta
    rides along, and the snapshot is not touched by a later in-place
    update of the saved tensors."""
    d_async, d_sync = str(tmp_path / "a"), str(tmp_path / "s")
    ck = Checkpointer(d_async, "PPO", async_save=True)
    state = _state(7.0)
    ck.save(state, 100, meta={"epoch": 3})
    state["params"]["actor"]["w"].add_(1.0)  # after the snapshot
    ck.flush(timeout=60.0)
    assert ck.n_saves == 1 and ck.pending == 0
    got, idx, meta = ck.restore_run(_state(0.0))
    assert idx == 100 and meta["epoch"] == 3 and meta["idx"] == 100 and meta["algo"] == "PPO"
    assert torch.equal(got["params"]["actor"]["w"], torch.full((3, 2), 7.0))
    assert ck.drain_save_secs() and ck.drain_save_secs() == []
    ck.close()
    sync = Checkpointer(d_sync, "PPO")
    sync.save(_state(7.0), 100)
    a = torch.load(os.path.join(d_async, "PPO_100", "state.pt"), weights_only=True)
    s = torch.load(os.path.join(d_sync, "PPO_100", "state.pt"), weights_only=True)
    assert a.keys() == s.keys() and torch.equal(a["params"]["actor"]["w"], s["params"]["actor"]["w"])
    sync.close()


def test_async_latest_wins_drops_stale_queue(tmp_path):
    d = str(tmp_path)
    ck = Checkpointer(d, "PPO", async_save=True)
    gate, started = threading.Event(), threading.Event()
    orig_write = ck._write

    def slow_write(host_state, idx, meta):
        started.set()
        gate.wait(30.0)
        orig_write(host_state, idx, meta)

    ck._write = slow_write
    ck.save(_state(1.0), 100)
    assert started.wait(10.0)  # 100 is in flight, not merely queued
    ck.save(_state(2.0), 200)  # queued behind it
    ck.save(_state(3.0), 300)  # replaces 200 in the queue slot
    assert ck.n_skipped == 1 and ck.pending == 2
    gate.set()
    ck.flush(timeout=60.0)
    ck.close()
    assert [n for n in sorted(os.listdir(d)) if not n.startswith(".")] == ["PPO_100", "PPO_300"]


def test_async_error_surfaces_on_next_save(tmp_path):
    ck = Checkpointer(str(tmp_path), "PPO", async_save=True)

    def boom(host_state, idx, meta):
        raise OSError("disk gone")

    ck._write = boom
    ck.save(_state(), 100)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        ck.flush(timeout=30.0)
    ck.save(_state(), 200)
    deadline = time.monotonic() + 30.0
    while ck.pending and time.monotonic() < deadline:  # 200's write has failed
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        ck.save(_state(), 300)  # the error of 200's write, raised here
    ck._write = lambda *a: None  # don't fail again on close's drain
    ck.close()


# ------------------------------------------------------------ run fingerprint
def test_resume_refuses_fingerprint_mismatch_unless_forced(tmp_path):
    d = str(tmp_path)
    cfg = Config()
    fp = resume_fingerprint(cfg)
    ck = Checkpointer(d, "PPO")
    ck.save(_state(5.0), 100, meta={"fingerprint": fp, "epoch": 0})
    got = ck.restore_run(_state(0.0), fingerprint=fp)
    assert got is not None and got[1] == 100
    fp2 = resume_fingerprint(cfg.replace(hidden_size=cfg.hidden_size * 2))
    assert fp2 != fp
    with pytest.raises(RuntimeError, match="different config"):
        ck.restore_run(_state(0.0), fingerprint=fp2)
    got = ck.restore_run(_state(0.0), fingerprint=fp2, force=True)
    assert got is not None and got[1] == 100
    ck.close()


def test_fingerprint_ignores_runtime_knobs():
    cfg = Config()
    fp = resume_fingerprint(cfg)
    assert fp == resume_fingerprint(cfg.replace(ckpt_keep=2, model_save_interval=3, lr=1e-3,
                                                inference_dtype="int8", loss_log_interval=7))
    assert fp != resume_fingerprint(cfg.replace(n_layers=cfg.n_layers + 1))
    assert fp != resume_fingerprint(cfg.replace(compute_dtype="bfloat16"))


@pytest.mark.parametrize("raw", [
    {},
    {"compute_dtype": "bfloat16", "algo": "IMPALA"},
    {"model": "transformer", "attention_impl": "flash", "n_layers": 4, "hidden_size": 512,
     "n_heads": 8, "seq_len": 2048, "obs_shape": [64], "action_space": 8,
     "compute_dtype": "bfloat16"},
], ids=["default", "bf16", "transformer"])
def test_fingerprint_equals_tpu_rl(raw):
    """The same params file hashes to the same fingerprint string in both
    packages (the port carries tpu_rl's conv fields and field list)."""
    from tpu_rl.checkpoint import resume_fingerprint as jax_fingerprint
    from tpu_rl.config import Config as JaxConfig

    assert resume_fingerprint(Config.from_dict(raw)) == jax_fingerprint(JaxConfig.from_dict(raw))


def test_resume_meta_roundtrips_generator_state(tmp_path):
    """The colocated loop stores its generator's state in the commit
    marker (in place of tpu_rl's PRNG key words); set_state from it
    continues the identical stream."""
    g = torch.Generator().manual_seed(42)
    torch.rand(3, generator=g)
    ck = Checkpointer(str(tmp_path), "PPO")
    path = ck.save(_state(), 100, meta={"generator": g.get_state().tolist(), "epoch": 1})
    meta = read_meta(path)
    assert meta["epoch"] == 1
    g2 = torch.Generator().set_state(torch.tensor(meta["generator"], dtype=torch.uint8))
    assert torch.equal(torch.rand(4, generator=g2), torch.rand(4, generator=g))
    ck.close()


def test_durability_keys_match_tpu_rl():
    """model_dir is a field now (no longer refused); the checkpoint knobs
    carry tpu_rl's defaults and asserts."""
    from tpu_rl.config import Config as JaxConfig

    for k in ("model_dir", "model_save_interval", "ckpt_keep", "ckpt_async", "resume_force",
              "need_conv", "height", "width", "is_gray"):
        assert getattr(Config(), k) == getattr(JaxConfig(), k), k
    cfg = Config.from_dict({"model_dir": "/tmp/ckpt", "ckpt_keep": 2})
    assert cfg.model_dir == "/tmp/ckpt" and cfg.extra == {}
    for bad in ({"ckpt_keep": 0}, {"model_save_interval": 0}):
        with pytest.raises(AssertionError):
            JaxConfig.from_dict(bad)
        with pytest.raises(AssertionError):
            Config.from_dict(bad)


# ------------------------------------------------------------ the port's states
def test_copy_committed_keeps_two_phase_semantics(tmp_path):
    src_dir, dst_dir = str(tmp_path / "src"), str(tmp_path / "dst")
    ck = Checkpointer(src_dir, "PPO")
    src = ck.save(_state(4.0), 100, meta={"epoch": 2, "fingerprint": "abc"})
    ck.close()
    dst = copy_committed(src, dst_dir, "PPO", 7, meta_overrides={"epoch": 5})
    assert is_committed(dst) and dst == os.path.join(dst_dir, "PPO_7")
    meta = read_meta(dst)
    assert meta["idx"] == 7 and meta["epoch"] == 5 and meta["fingerprint"] == "abc"
    got, idx = Checkpointer(dst_dir, "PPO").restore_latest(_state(0.0))
    assert idx == 7 and torch.equal(got["params"]["actor"]["w"], torch.full((3, 2), 4.0))
    with pytest.raises(ValueError, match="not committed"):
        copy_committed(_plant_torn(src_dir, "PPO", 200), dst_dir, "PPO", 8)
    assert not os.path.exists(os.path.join(dst_dir, "PPO_8"))


def _tree_equal(a, b):
    import dataclasses

    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(_tree_equal(getattr(a, f.name), getattr(b, f.name))
                                          for f in dataclasses.fields(a))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)


@pytest.mark.parametrize("algo", ["PPO", "V-MPO", "SAC", "SAC-Continuous"])
@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_every_train_state_round_trips(tmp_path, algo, async_save):
    """A TrainState (V-MPO's duals included) or SACState after one train
    step is restored bit for bit into a fresh state of the same config, and
    restore_actor_params finds its actor; a template of another width is
    refused."""
    from tests.test_torch_ppo import SPACES
    from tpu_rl_torch.types import Batch

    obs_shape, n = SPACES[algo]
    cfg = Config.from_dict(dict(algo=algo, hidden_size=16, batch_size=8, buffer_size=32,
                                obs_shape=obs_shape, action_space=n,
                                is_continuous=algo.endswith("Continuous")))
    fam, state, step = get_algo(algo).build(cfg, torch.Generator().manual_seed(0), device="cpu")
    from tests.test_torch_ppo import _batch_np

    state, _m = step(state, Batch.from_mapping(_batch_np(cfg, 1, fam.continuous), device="cpu"),
                     generator=torch.Generator().manual_seed(1))
    ck = Checkpointer(str(tmp_path), algo, async_save=async_save)
    ck.save(state, 1, meta={"fingerprint": resume_fingerprint(cfg)})
    ck.flush(timeout=60.0)
    fresh = get_algo(algo).build(cfg, torch.Generator().manual_seed(9), device="cpu")[1]
    got, idx, meta = ck.restore_run(fresh, fingerprint=resume_fingerprint(cfg))
    assert idx == 1 and _tree_equal(got, state)
    actor = state.actor_params if hasattr(state, "actor_params") else state.params["actor"]
    assert _tree_equal(restore_actor_params(str(tmp_path), algo)["actor"], actor)
    wide = get_algo(algo).build(cfg.replace(hidden_size=32), torch.Generator().manual_seed(0),
                                device="cpu")[1]
    with pytest.raises(ValueError, match="template"):
        ck.restore_run(wide)
    ck.close()


def test_restore_nth_latest_and_discard_above(tmp_path):
    ck = Checkpointer(str(tmp_path), "PPO", keep=5)
    for idx in (10, 20, 30):
        ck.save(_state(float(idx)), idx)
    got, idx, _m = ck.restore_nth_latest(_state(0.0), n=2)
    assert idx == 20 and float(got["params"]["actor"]["w"][0, 0]) == 20.0
    assert ck.restore_nth_latest(_state(0.0), n=9)[1] == 10
    assert ck.discard_above(15) == 2
    assert ck.latest_idx() == 10
    ck.close()


# ------------------------------------------------------------ colocated loop
def _loop_cfg(d, **kw):
    return Config(env_mode="colocated", colocated_envs=8, hidden_size=16, model_dir=d,
                  model_save_interval=3, ckpt_keep=2, loss_log_interval=4, **kw)


@pytest.mark.parametrize("ckpt_async", [True, False], ids=["async", "sync"])
def test_colocated_loop_saves_and_resumes(tmp_path, ckpt_async):
    """ColocatedLoop.run saves every model_save_interval updates and at the
    end (7 updates: 3, 6 and 7; two kept, the newest 7); a fresh loop resumes at idx 7
    with run epoch 1, its state and generator equal to the saved ones bit
    for bit, and runs on to 9 with finite metrics. A torn directory above
    is invisible; a bf16-compute config refuses the checkpoint unless
    resume_force."""
    d = str(tmp_path)
    loop = ColocatedLoop(_loop_cfg(d, ckpt_async=ckpt_async), seed=0, max_updates=7, device="cpu")
    out = loop.run(log=False)
    assert out["updates"] == 7 and loop.ckpt is None  # closed at the end
    assert latest_committed(d, "PPO")[0] == 7
    kept = sorted(os.listdir(d))  # PPO_6, or PPO_3 if latest-wins dropped 6
    assert len(kept) == 2 and kept[-1] == "PPO_7" and kept[0] in ("PPO_3", "PPO_6")
    meta = read_meta(os.path.join(d, "PPO_7"))
    assert meta["epoch"] == 0 and meta["fingerprint"] == resume_fingerprint(loop.cfg)
    _plant_torn(d, "PPO", 50)

    loop2 = ColocatedLoop(_loop_cfg(d, ckpt_async=ckpt_async), seed=0, max_updates=9, device="cpu")
    assert not os.path.exists(os.path.join(d, "PPO_50"))  # cleaned at init
    restored = loop2.restore(loop2.state)
    assert (loop2._start_it, loop2.run_epoch) == (7, 1)
    assert _tree_equal(restored, loop.state)
    assert torch.equal(loop2.generator.get_state(), loop.generator.get_state())
    out2 = loop2.run(log=False)
    assert out2["updates"] == 9 and out2["env_steps"] == 9 * 8 * 5
    assert all(np.isfinite(float(v)) for p in loop2.state.params["actor"].values() for v in [p.sum()])
    assert read_meta(os.path.join(d, "PPO_9"))["epoch"] == 1

    with pytest.raises(RuntimeError, match="different config"):
        ColocatedLoop(_loop_cfg(d, compute_dtype="bfloat16"), seed=0, max_updates=10,
                      device="cpu").run(log=False)
    out3 = ColocatedLoop(_loop_cfg(d, compute_dtype="bfloat16", resume_force=True), seed=0,
                         max_updates=10, device="cpu").run(log=False)
    assert out3["updates"] == 10


def test_colocated_loop_without_model_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    loop = ColocatedLoop(Config(env_mode="colocated", colocated_envs=8, hidden_size=16),
                         seed=0, max_updates=2, device="cpu")
    assert loop.ckpt is None
    assert loop.run(log=False)["updates"] == 2
    assert os.listdir(tmp_path) == []
    json.dumps(loop.save_meta())  # the meta is JSON either way
