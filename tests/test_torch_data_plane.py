"""The port's host data plane against ``tpu_rl``'s on the CPU, bit for bit:
``BatchLayout`` widths; the assembler's windows from one seeded step stream
(``push``, ``push_tick``, splice seams, stale drops under an injected
clock, the version sidecar, ``pop_many_full`` and ``requeue``); the stores'
contents and samples from the same puts and the same
``np.random.Generator``; and a torn read re-drawn while a **spawn** child
writes the ring, as ``tests/test_shm_ring_mp.py`` does for ``tpu_rl``."""

import multiprocessing as mp
import time

import numpy as np
import pytest

from tests.conftest import small_config
from tpu_rl.data.assembler import RolloutAssembler as JaxAssembler
from tpu_rl.data.assembler import split_rollout_batch as jax_split
from tpu_rl.data.assembler import stack_window as jax_stack_window
from tpu_rl.data.layout import BatchLayout as JaxLayout
from tpu_rl.data.shm_ring import make_store as jax_make_store
from tpu_rl_torch.config import Config
from tpu_rl_torch.data import BatchLayout, ReplayStore, RolloutAssembler, make_store
from tpu_rl_torch.data.assembler import split_rollout_batch, stack_window
from tpu_rl_torch.data.shm_ring import ShmHandles, alloc_handles
from tpu_rl_torch.types import BATCH_FIELDS

LAYOUTS = {
    "cartpole": dict(obs_shape=(4,), action_space=2, hidden_size=16),
    "pendulum": dict(algo="SAC-Continuous", obs_shape=(3,), action_space=1, is_continuous=True,
                     hidden_size=16),
    "wide": dict(algo="IMPALA", obs_shape=(64,), action_space=8, hidden_size=1024, seq_len=16),
    "transformer": dict(model="transformer", obs_shape=(4,), action_space=2, hidden_size=32),
}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _layouts(**kw):
    return BatchLayout.from_config(Config(**kw)), JaxLayout.from_config(small_config(**kw))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_batch_layout_matches(name):
    ours, ref = _layouts(**LAYOUTS[name])
    assert {f: ours.width(f) for f in BATCH_FIELDS} == {f: ref.width(f) for f in BATCH_FIELDS}
    assert (ours.seq_len, ours.step_floats, ours.traj_floats) == (
        ref.seq_len, ref.step_floats, ref.traj_floats)
    assert ours.fields == tuple(ref.fields)
    # a malformed step and tick are refused by both
    bad = {f: np.zeros(ours.width(f) + (f == "obs"), np.float32) for f in BATCH_FIELDS}
    for layout in (ours, ref):
        with pytest.raises(ValueError, match="obs"):
            layout.validate_step(bad)
        tick = {f: np.zeros((3, ours.width(f)), np.float32) for f in BATCH_FIELDS}
        tick["done"] = np.zeros(2)
        with pytest.raises(ValueError, match="done"):
            layout.validate_tick(tick, 3)


def _tick(rng, layout, ids, done_p, ver):
    n = len(ids)
    payload = {f: rng.standard_normal((n, layout.width(f))).astype(np.float32)
               for f in BATCH_FIELDS}
    payload["id"] = list(ids)
    payload["done"] = (rng.random(n) < done_p).astype(np.uint8)
    if ver is not None:
        payload["ver"] = ver
    return payload


def _drive(asm_cls, split, layout, seed, n_envs, mode):
    """One seeded stream (episode turnover, 0.7 s gaps, versioned ticks)
    through ``mode`` ("tick" or "step"); returns the windows with their
    lineage and versions, the stats and the leftover ready count."""
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    asm = asm_cls(layout, lag_sec=0.5, clock=clock, validate=True)
    ids = [f"ep{i}" for i in range(n_envs)]
    next_id = n_envs
    out = []
    for t in range(300):
        clock.t += 0.7 if rng.random() < 0.05 else 0.01
        payload = _tick(rng, layout, ids, 0.12, t if t % 3 else None)
        if mode == "tick":
            asm.push_tick(payload, trace_id=t if t % 7 == 0 else None)
        else:
            for step in split(payload):
                asm.push(step)
        if t % 11 == 0:
            wins, traces, vers = asm.pop_many_full(2)
            asm.requeue(wins, traces, vers)  # back at the front, in order
        wins, traces, vers = asm.pop_many_full()
        out.extend(zip(wins, traces or [None] * len(wins), vers, strict=True))
        for i in range(n_envs):
            if payload["done"][i]:
                ids[i] = f"ep{next_id}"
                next_id += 1
    return out, asm.stats, len(asm)


@pytest.mark.parametrize("mode", ["tick", "step"])
@pytest.mark.parametrize("seed,n_envs", [(0, 1), (1, 5), (2, 3)])
def test_assembler_windows_match(seed, n_envs, mode):
    """The same stream through both packages' assemblers: the same windows
    in the same order, bit for bit, with the same lineage, versions and
    counters (splices and stale drops exercised)."""
    ours_layout, ref_layout = _layouts(**LAYOUTS["cartpole"])
    got, got_stats, got_left = _drive(RolloutAssembler, split_rollout_batch, ours_layout, seed,
                                      n_envs, mode)
    want, want_stats, want_left = _drive(JaxAssembler, jax_split, ref_layout, seed, n_envs, mode)
    assert got_stats == want_stats and got_left == want_left
    assert got_stats["spliced"] > 0 and got_stats["dropped_stale"] > 0
    assert len(got) == len(want) > 0
    for (gw, gt, gv), (ww, wt, wv) in zip(got, want, strict=True):
        assert (gt, gv) == (wt, wv)
        for f in BATCH_FIELDS:
            np.testing.assert_array_equal(gw[f], ww[f], err_msg=f)
            assert gw[f].dtype == np.float32


def test_stack_window_and_split_match():
    ours_layout, _ = _layouts(**LAYOUTS["pendulum"])
    rng = np.random.default_rng(3)
    payload = _tick(rng, ours_layout, ["a", "b", "c"], 0.5, 4)
    got, want = split_rollout_batch(payload), jax_split(payload)
    assert [s.keys() for s in got] == [s.keys() for s in want]
    for g, w in zip(got, want, strict=True):
        assert (g["id"], g["done"], g.get("ver")) == (w["id"], w["done"], w.get("ver"))
    gs, ws = stack_window(got), jax_stack_window(want)
    for f in BATCH_FIELDS:
        np.testing.assert_array_equal(gs[f], ws[f])


def _windows(layout, rng, k):
    return [{f: rng.standard_normal((layout.seq_len, layout.width(f))).astype(np.float32)
             for f in BATCH_FIELDS} for _ in range(k)]


@pytest.mark.parametrize("algo", ["PPO", "SAC"])
def test_stores_match_under_the_same_puts(algo):
    """make_store picks the same store; the same puts (single, burst, past
    capacity, with versions) leave the same contents; the same generator
    draws the same sample, ``ver`` included; the on-policy consume returns
    the same batch and resets both."""
    kw = dict(LAYOUTS["cartpole"], algo=algo, batch_size=6, buffer_size=12)
    ours_layout, ref_layout = _layouts(**kw)
    ours = make_store(Config(**kw), ours_layout)
    ref = jax_make_store(small_config(**kw), ref_layout)
    assert type(ours).__name__ == type(ref).__name__ == (
        "ReplayStore" if algo == "SAC" else "OnPolicyStore")
    wins = _windows(ours_layout, np.random.default_rng(1), 20)
    vers = list(range(100, 120))
    for store in (ours, ref):
        assert store.put(wins[0], ver=vers[0])
        store.put_many(wins[1:15], vers[1:15])
        store.put(wins[15], ver=-1)
        store.put_many(wins[16:], None)
    for f in BATCH_FIELDS:
        np.testing.assert_array_equal(ours.views[f], ref.views[f])
    np.testing.assert_array_equal(ours.slot_vers, ref.slot_vers)
    assert ours.size == ref.size
    if algo == "SAC":
        assert ours.total_puts == ref.total_puts == 20
        assert ours.transitions_received() == ref.transitions_received()
        r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
        for batch in (6, 12, 3):
            got, want = ours.sample(batch, r1), ref.sample(batch, r2)
            assert set(got) == set(want) == set(BATCH_FIELDS) | {"ver"}
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert ours.sample(13, r1) is None and ref.sample(13, r2) is None
        # the generators stayed in step
        assert r1.integers(0, 1 << 30) == r2.integers(0, 1 << 30)
    else:
        got, want = ours.consume(), ref.consume()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert ours.size == ref.size == 0
        assert ours.consume() is None and ref.consume() is None


def test_handles_come_from_the_spawn_context():
    """The stores' primitives are made by the spawn context (a forked child
    of a process that has initialised CUDA cannot use CUDA)."""
    layout, _ = _layouts(**LAYOUTS["cartpole"])
    h = alloc_handles(layout, 4)
    assert isinstance(h, ShmHandles) and h.capacity == 4
    assert h.lock._is_fork_ctx is False  # a fork-context lock says True
    assert np.all(np.frombuffer(h.vers, np.int64) == -1)


# -------------------------------------------------- a spawn writer, torn reads
def _window_of(layout, value):
    return {f: np.full((layout.seq_len, layout.width(f)), value, np.float32)
            for f in BATCH_FIELDS}


def _spawn_replay_writer(handles, n_puts, stop):
    """The child: the port's ReplayStore over the inherited handles, writing
    windows whose every float is the put's index."""
    layout = BatchLayout.from_config(Config(**LAYOUTS["cartpole"]))
    store = ReplayStore(handles, layout)
    i = 0
    while i < n_puts and not stop.is_set():
        store.put(_window_of(layout, float(i)), ver=i)
        i += 1


class _CountingRng:
    """A generator that counts its ``integers`` calls (a sample's first
    draw, then one per re-draw of torn rows)."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.calls = 0

    def integers(self, *a, **kw):
        self.calls += 1
        return self.rng.integers(*a, **kw)


@pytest.mark.timeout(180)
def test_replay_sample_redraws_torn_slots_under_a_spawn_writer():
    """A spawn child overwrites a 16-slot ring as fast as it can while this
    process samples: every returned window is uniform (no torn read) with a
    version equal to its value, sampling keeps succeeding, and torn rows
    were really re-drawn (more draws than samples)."""
    ctx = mp.get_context("spawn")
    layout = BatchLayout.from_config(Config(**LAYOUTS["cartpole"]))
    handles = alloc_handles(layout, 16, ctx=ctx)
    store = ReplayStore(handles, layout)
    stop = ctx.Event()
    writer = ctx.Process(target=_spawn_replay_writer, args=(handles, 2_000_000, stop),
                         daemon=True)
    writer.start()
    try:
        deadline = time.time() + 120
        while store.size < 16 and time.time() < deadline:
            time.sleep(0.01)
        rng = _CountingRng(0)
        n_ok = n_samples = 0
        seen = set()
        end = time.time() + 5.0
        while (time.time() < end or rng.calls == n_samples) and time.time() < deadline \
                and writer.is_alive():
            n_samples += 1
            got = store.sample(8, rng)
            if got is None:
                continue  # the retry budget ran out this round: legal
            rows = np.concatenate([got[f].reshape(8, -1) for f in BATCH_FIELDS], axis=1)
            assert (rows.min(axis=1) == rows.max(axis=1)).all(), "torn window returned"
            np.testing.assert_array_equal(got["ver"], rows[:, 0].astype(np.int64))
            seen.update(rows[:, 0].tolist())
            n_ok += 1
        assert n_ok > 100, (n_ok, n_samples)
        assert len(seen) > 16  # samples span many laps of the ring
        assert rng.calls > n_samples, "no torn row was ever re-drawn"
    finally:
        stop.set()
        writer.join(30)
        if writer.is_alive():
            writer.terminate()


@pytest.mark.parametrize("zero", [False, True])
def test_maybe_zero_carry_matches(zero):
    """types.maybe_zero_carry against tpu_rl's: the mapping itself when the
    gate is off; else a shallow copy with hx/cx zeroed, the input intact."""
    from tpu_rl.types import maybe_zero_carry as jax_maybe_zero_carry
    from tpu_rl_torch.types import maybe_zero_carry

    layout, _ = _layouts(**LAYOUTS["cartpole"])
    raw = {f: np.stack(v) for f, v in zip(
        BATCH_FIELDS, zip(*[[w[f] for f in BATCH_FIELDS]
                             for w in _windows(layout, np.random.default_rng(2), 3)]),
        strict=True)}
    got = maybe_zero_carry(Config(zero_window_carry=zero, algo="IMPALA"), raw)
    want = jax_maybe_zero_carry(small_config(zero_window_carry=zero, algo="IMPALA"), raw)
    assert (got is raw) == (want is raw) == (not zero)
    for f in BATCH_FIELDS:
        np.testing.assert_array_equal(got[f], want[f])
    assert raw["hx"].any() and (not got["hx"].any()) == zero
