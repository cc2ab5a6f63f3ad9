"""The port's learner feed on the CPU: ``tpu_rl``'s prefetch contract
(ordering and no loss, chain accumulation, shutdown while the feeder is
blocked, the external stop event, a feeder error re-raised from ``get``,
the update:data ratio gate), run on both packages; RNG stream stability
through a real ``ReplayStore``; ``device_batch``; and the prefetched
batches, and the params after SAC train steps on them, equal to the
synchronous feed's bit for bit."""

import threading
import time

import numpy as np
import pytest
import torch

from tpu_rl.data import prefetch as jax_prefetch
from tpu_rl_torch.algos.registry import get_algo
from tpu_rl_torch.config import Config
from tpu_rl_torch.data import BatchLayout, ReplayStore, make_store, prefetch
from tpu_rl_torch.data.prefetch import DeviceStager, device_batch, wait_ready
from tpu_rl_torch.types import BATCH_FIELDS, Batch
from tpu_rl_torch.utils.tree import tree_leaves

PACKAGES = {"port": prefetch, "tpu_rl": jax_prefetch}


def _drain(pipe, n, timeout=30.0):
    got = []
    deadline = time.time() + timeout
    while len(got) < n and time.time() < deadline:
        item = pipe.get(timeout=0.05)
        if item is not None:
            got.append(item[0])
    return got


@pytest.mark.timeout(60)
@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_prefetch_ordering_and_no_batch_loss(pkg):
    counter = iter(range(50))
    pipe = PACKAGES[pkg].PrefetchPipeline(lambda: next(counter, None), list, chain=1, depth=2)
    got = _drain(pipe, 50)
    pipe.close()
    assert [g[0] for g in got] == list(range(50))
    assert pipe.dispatched == 50


@pytest.mark.timeout(60)
@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_prefetch_chain_accumulation(pkg):
    counter = iter(range(12))
    pipe = PACKAGES[pkg].PrefetchPipeline(lambda: next(counter, None), list, chain=3, depth=2)
    got = _drain(pipe, 4)
    pipe.close()
    assert got == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]


@pytest.mark.timeout(60)
@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_prefetch_close_joins_blocked_feeder(pkg):
    """close() ends the feeder while it is blocked on a full queue."""
    pipe = PACKAGES[pkg].PrefetchPipeline(lambda: 1, lambda raws: raws, chain=1, depth=1)
    deadline = time.time() + 10
    while pipe.qsize() < 1 and time.time() < deadline:
        time.sleep(0.01)
    assert pipe.qsize() == 1
    pipe.close(timeout=10)
    assert not pipe._thread.is_alive()


@pytest.mark.timeout(60)
@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_prefetch_external_stop_event(pkg):
    stop = threading.Event()
    pipe = PACKAGES[pkg].PrefetchPipeline(lambda: 1, lambda raws: raws, depth=1, stop_event=stop)
    stop.set()
    deadline = time.time() + 10
    while pipe._thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    assert not pipe._thread.is_alive()
    pipe.close()


@pytest.mark.timeout(60)
@pytest.mark.parametrize("where", ["fetch", "assemble"])
def test_prefetch_feeder_exception_reraises_in_consumer(where):
    """An exception on the feeder thread (in fetch, or in assemble — where
    the port places batches on the card) surfaces from get()."""
    calls = {"n": 0}

    def fetch():
        calls["n"] += 1
        if where == "fetch" and calls["n"] > 2:
            raise RuntimeError("store exploded")
        return calls["n"]

    def assemble(raws):
        if where == "assemble" and raws[0] > 2:
            raise RuntimeError("placement exploded")
        return raws[0]

    pipe = prefetch.PrefetchPipeline(fetch, assemble, chain=1, depth=1)
    with pytest.raises(RuntimeError, match="exploded"):
        deadline = time.time() + 30
        while time.time() < deadline:
            pipe.get(timeout=0.05)
    pipe.close()


def test_prefetch_rejects_bad_depth():
    with pytest.raises(ValueError):
        prefetch.PrefetchPipeline(lambda: None, lambda r: r, depth=0)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_synchronous_feed_accumulates_chain_across_none(pkg):
    seq = iter([10, None, 11, None, None, 12])
    feed = PACKAGES[pkg].SynchronousFeed(lambda: next(seq, None), list, chain=3)
    results = [item[0] for item in (feed.get() for _ in range(6)) if item is not None]
    assert results == [[10, 11, 12]]
    assert feed.qsize() == 0
    feed.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_update_ratio_gate_arithmetic(pkg):
    gate = PACKAGES[pkg].UpdateRatioGate(max_ratio=0.5)
    assert not gate.ready(0)
    assert gate.ready(2)
    gate.note_fetched()
    assert not gate.ready(2) and not gate.ready(3) and gate.ready(4)
    gate.note_fetched()
    assert not gate.ready(4) and gate.ready(1000)
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError):
            PACKAGES[pkg].UpdateRatioGate(bad)


# ----------------------------------------------------- placement, RNG, equality
SAC_KW = dict(algo="SAC", obs_shape=(4,), action_space=2, hidden_size=16, batch_size=8,
              buffer_size=64, seq_len=5, K_epoch=1)


def _filled_replay(cfg, n=40, seed=3):
    layout = BatchLayout.from_config(cfg)
    store = make_store(cfg, layout)
    assert isinstance(store, ReplayStore)
    rng = np.random.default_rng(seed)
    for i in range(n):
        w = {f: rng.standard_normal((layout.seq_len, layout.width(f))).astype(np.float32)
             for f in BATCH_FIELDS}
        w["act"] = rng.integers(0, 2, size=w["act"].shape).astype(np.float32)
        w["is_fir"][:] = 0.0
        w["is_fir"][0] = 1.0
        store.put(w, ver=i)
    return store


def _fetcher(store, cfg, seed=11, gate=None):
    rng = np.random.default_rng(seed)

    def fetch():
        if gate is not None and not gate.ready(store.transitions_received()):
            return None
        raw = store.sample(cfg.batch_size, rng)
        if raw is not None and gate is not None:
            gate.note_fetched()
        return raw

    return fetch


def _feed_batches(feed, n):
    got = []
    deadline = time.time() + 30
    while len(got) < n and time.time() < deadline:
        item = feed.get(timeout=0.05)
        if item is not None:
            got.append(item[0])
    feed.close()
    return got


def test_device_batch_on_the_cpu():
    """On the CPU device_batch is Batch.from_mapping: the ``ver`` sidecar
    is ignored; chained raws and a CUDA placement without a stager are
    refused, and a stager is CUDA-only."""
    cfg = Config(**SAC_KW)
    raw = _filled_replay(cfg).sample(8, np.random.default_rng(0))
    assert "ver" in raw
    b = device_batch([raw], "cpu")
    assert isinstance(b, Batch) and b.obs.device.type == "cpu"
    for f in BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(b, f).numpy(), raw[f])
    assert wait_ready(b) is b  # no event: passes through
    with pytest.raises(ValueError, match="one raw batch"):
        device_batch([raw, raw], "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        DeviceStager("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_batch([raw], "cuda")


@pytest.mark.timeout(120)
@pytest.mark.parametrize("ratio", [None, 0.5])
def test_prefetch_batches_equal_the_synchronous_feeds(ratio):
    """Through a real ReplayStore: the prefetch pipeline's batches equal the
    synchronous feed's (and tpu_rl's synchronous feed's samples) bit for bit,
    in order — the sampler's generator is touched by one thread only — with
    and without the update:data gate."""
    cfg = Config(**SAC_KW)
    store = _filled_replay(cfg)
    n = 12

    def gate():
        return None if ratio is None else prefetch.UpdateRatioGate(ratio)

    sync = _feed_batches(prefetch.SynchronousFeed(
        _fetcher(store, cfg, gate=gate()), lambda raws: device_batch(raws, "cpu")), n)
    pre = _feed_batches(prefetch.PrefetchPipeline(
        _fetcher(store, cfg, gate=gate()), lambda raws: device_batch(raws, "cpu"), depth=2), n)
    ref = _feed_batches(jax_prefetch.SynchronousFeed(
        _fetcher(store, cfg, gate=gate()), lambda raws: raws[0]), n)
    assert len(sync) == len(pre) == len(ref) == n
    for s, p, r in zip(sync, pre, ref, strict=True):
        for f in BATCH_FIELDS:
            assert torch.equal(getattr(s, f), getattr(p, f)), f
            np.testing.assert_array_equal(getattr(s, f).numpy(), r[f])


@pytest.mark.timeout(120)
def test_sac_steps_on_prefetched_batches_equal_the_synchronous_run():
    """Five SAC train steps from one state and one train generator, fed once
    by the synchronous feed and once by the prefetch pipeline: the final
    states are equal bit for bit (the card's phase makes the same check
    through pinned buffers and a side stream)."""
    cfg = Config(**SAC_KW)
    store = _filled_replay(cfg)
    spec = get_algo("SAC")
    finals = []
    for feed_cls in (prefetch.SynchronousFeed, prefetch.PrefetchPipeline):
        _fam, state, step = spec.build(cfg, torch.Generator().manual_seed(0), device="cpu")
        gen = torch.Generator().manual_seed(5)
        feed = feed_cls(_fetcher(store, cfg), lambda raws: device_batch(raws, "cpu"))
        for batch in _feed_batches(feed, 5):
            state, metrics = step(state, wait_ready(batch), generator=gen)
            assert torch.isfinite(metrics["loss"])
        finals.append(state)
    for name in ("actor_params", "critic_params", "target_critic_params", "actor_opt",
                 "critic_opt", "alpha_opt"):
        for a, b in zip(tree_leaves(getattr(finals[0], name)),
                        tree_leaves(getattr(finals[1], name)), strict=True):
            assert torch.equal(a, b), name
    assert torch.equal(finals[0].log_alpha, finals[1].log_alpha)
