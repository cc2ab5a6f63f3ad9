"""The port's manager relay and storage ingest against ``tpu_rl``'s, in
process: the same encoded RolloutBatch and Stat frames go through each
package's ``Manager`` (both relay modes) and ``LearnerStorage`` ingest
into each package's shared-memory store; the forwarded frames, the stores'
bytes and the stat mailbox are equal bit for bit. The learner's
``_to_batch`` of one store sample equals ``tpu_rl``'s, and a Model frame
from the port's learner, for bridged weights, decodes to arrays equal to
``tpu_rl``'s ``_actor_snapshot``."""

import jax
import numpy as np
import pytest

from tests.conftest import small_config as jax_small_config
from tpu_rl.data.assembler import RolloutAssembler as JAssembler
from tpu_rl.data.layout import BatchLayout as JLayout
from tpu_rl.data.shm_ring import alloc_handles as j_alloc
from tpu_rl.data.shm_ring import make_store as j_make_store
from tpu_rl.runtime import protocol as JP
from tpu_rl.runtime.manager import Manager as JManager
from tpu_rl.runtime.storage import LearnerStorage as JStorage
from tpu_rl_torch.config import Config
from tpu_rl_torch.data.assembler import RolloutAssembler as PAssembler
from tpu_rl_torch.data.layout import BatchLayout as PLayout
from tpu_rl_torch.data.shm_ring import alloc_handles as p_alloc
from tpu_rl_torch.data.shm_ring import make_store as p_make_store
from tpu_rl_torch.runtime import protocol as PP
from tpu_rl_torch.runtime.mailbox import STAT_SLOTS
from tpu_rl_torch.runtime.manager import STAT_WINDOW
from tpu_rl_torch.runtime.manager import Manager as PManager
from tpu_rl_torch.runtime.storage import LearnerStorage as PStorage

BASE = dict(hidden_size=16, seq_len=5, batch_size=8, buffer_size=32, obs_shape=(4,),
            action_space=2, time_horizon=32, rollout_lag_sec=1e6)


def port_config(**kw) -> Config:
    return Config.from_dict({**BASE, **kw})


def ticks(n_ticks: int, n_envs: int, wid: int, seed: int) -> list[dict]:
    """A worker's RolloutBatch payloads as its loop builds them: seeded obs,
    actions and rewards, episodes of random length (uuid-like ids)."""
    rng = np.random.default_rng(seed)
    ids = [f"w{wid}e{i}-0" for i in range(n_envs)]
    first = np.ones(n_envs, np.float32)
    out = []
    for t in range(n_ticks):
        done = (rng.random(n_envs) < 0.08).astype(np.uint8)
        logits = rng.standard_normal((n_envs, 2)).astype(np.float32)
        out.append(dict(
            obs=rng.standard_normal((n_envs, 4)).astype(np.float32),
            act=rng.integers(0, 2, (n_envs, 1)).astype(np.float32),
            rew=(rng.random((n_envs, 1)) * 0.1).astype(np.float32),
            logits=logits,
            log_prob=-np.abs(logits[:, :1]),
            is_fir=first[:, None].copy(),
            hx=rng.standard_normal((n_envs, 16)).astype(np.float32),
            cx=rng.standard_normal((n_envs, 16)).astype(np.float32),
            id=list(ids), done=done, wid=wid, ver=t // 10, epoch=0,
        ))
        first = np.zeros(n_envs, np.float32)
        for i in np.flatnonzero(done):
            ids[i] = f"w{wid}e{i}-{t + 1}"
            first[i] = 1.0
    return out


def stat_frames(n: int, wid: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"rew": float(rng.integers(8, 200)), "n_model_loads": k // 3, "n_rejected": 0,
             "wid": wid} for k in range(n)]


class _Collect:
    """A stand-in relay PUB: keeps every frame the manager forwards."""

    def __init__(self, encode):
        self.encode = encode
        self.frames: list[list[bytes]] = []

    def send_raw(self, parts):
        self.frames.append(list(parts))

    def send(self, proto, payload, trace=None):
        self.frames.append(self.encode(proto, payload, trace))


class _Idle:
    def drain_raw(self, max_msgs=1024):
        return iter(())

    drain_traced = drain_raw


def relay_and_store(pkg: str, cfg, frames: list[list[bytes]]):
    """The frames through ``pkg``'s Manager and LearnerStorage ingest; ->
    (forwarded frames, store arrays, mailbox, windows)."""
    if pkg == "tpu_rl":
        P, Manager, Storage, Layout, Assembler, alloc, make_store = (
            JP, JManager, JStorage, JLayout, JAssembler, j_alloc, j_make_store)
    else:
        P, Manager, Storage, Layout, Assembler, alloc, make_store = (
            PP, PManager, PStorage, PLayout, PAssembler, p_alloc, p_make_store)
    layout = Layout.from_config(cfg)
    capacity = cfg.buffer_size if cfg.algo.startswith("SAC") else 64
    handles = alloc(layout, capacity)
    store = make_store(cfg, layout, handles=handles)
    assembler = Assembler(layout, lag_sec=cfg.rollout_lag_sec)
    mailbox = [0.0] * STAT_SLOTS
    storage = Storage(cfg, handles, 0, stat_array=mailbox)
    manager = Manager(cfg, 0, "127.0.0.1", 0)
    pub = _Collect(P.encode)
    done = 0
    for parts in frames:
        if manager.raw:
            manager._ingest(P.peek(parts), parts, pub)
        else:
            proto, payload = P.decode(parts)
            manager._ingest(proto, payload, pub, parts[2] if len(parts) == 3 else None)
        manager._pump(_Idle(), pub)
        for fwd in pub.frames[done:]:
            proto, payload = P.decode(fwd)
            storage._ingest(proto, payload, assembler, fwd[2] if len(fwd) == 3 else None)
        done = len(pub.frames)
        storage._flush(assembler, store)
    arrays = {f: bytes(np.frombuffer(a, np.uint8)) for f, a in handles.arrays.items()}
    arrays["vers"] = bytes(np.frombuffer(handles.vers, np.uint8))
    arrays["versions"] = bytes(np.frombuffer(handles.versions, np.uint8))
    return pub.frames, arrays, list(mailbox), storage.n_windows, int(handles.count.value)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("algo", ["PPO", "SAC"])
@pytest.mark.parametrize("relay_mode", ["raw", "decode"])
def test_relay_and_storage_fill_equal_stores(algo, relay_mode):
    cfg_j = jax_small_config(**{**BASE, "algo": algo, "relay_mode": relay_mode})
    cfg_p = port_config(algo=algo, relay_mode=relay_mode)
    frames = []
    trailer = JP.pack_trace(1, 7, JP.make_trace_id(1, 7), 42)
    for w in range(2):
        for t, tick in enumerate(ticks(40, 3, w, seed=10 + w)):
            frames.append(JP.encode(JP.Protocol.RolloutBatch, tick,
                                    trace=trailer if t % 9 == 0 else None))
        for st in stat_frames(STAT_WINDOW // 2 + 3, w, seed=20 + w):
            frames.append(JP.encode(JP.Protocol.Stat, st))
    got = relay_and_store("port", cfg_p, frames)
    want = relay_and_store("tpu_rl", cfg_j, frames)
    assert got[0] == want[0]  # forwarded frames, byte for byte
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        assert got[1][k] == want[1][k], k  # the stores' bytes
    assert got[2] == want[2]  # the stat mailbox
    assert got[3:] == want[3:] and want[3] > 0  # windows and the store's count
    assert want[2][0] == STAT_WINDOW  # one windowed stat reached the mailbox


@pytest.mark.parametrize("algo,zero", [("PPO", False), ("IMPALA", True), ("SAC", False)])
def test_learner_to_batch_equals_tpu_rl(algo, zero):
    from tpu_rl.runtime.learner_service import LearnerService as JLearner
    from tpu_rl_torch.runtime.learner_service import LearnerService as PLearner

    kw = {**BASE, "algo": algo, "zero_window_carry": zero}
    cfg_j, cfg_p = jax_small_config(**kw), port_config(**kw)
    from tpu_rl.types import BATCH_FIELDS

    layout = JLayout.from_config(cfg_j)
    rng = np.random.default_rng(3)
    raw = {f: rng.standard_normal((8, layout.seq_len, layout.width(f))).astype(np.float32)
           for f in BATCH_FIELDS}
    raw["is_fir"] = (rng.random(raw["is_fir"].shape) < 0.3).astype(np.float32)
    j = JLearner(cfg_j, None, 0)
    j._place_global = None
    p = PLearner(cfg_p, None, 0)
    want = j._to_batch({k: v.copy() for k, v in raw.items()})
    got = p._to_batch({k: v.copy() for k, v in raw.items()})
    for f in raw:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("algo", ["PPO", "SAC-Continuous"])
def test_model_frame_equals_tpu_rl_actor_snapshot(algo):
    """The port's learner publishes its (bridged) actor in tpu_rl's flax
    layout: the frame decodes, in tpu_rl, to arrays equal to tpu_rl's own
    ``_actor_snapshot`` bit for bit, under the same keys."""
    from tpu_rl.algos.registry import get_algo
    from tpu_rl.runtime.learner_service import LearnerService as JLearner
    from tpu_rl_torch.bridge import sac_state_from_flax, train_state_from_flax
    from tpu_rl_torch.runtime.learner_service import LearnerService as PLearner

    obs = (3,) if algo.endswith("Continuous") else (4,)
    kw = {**BASE, "algo": algo, "obs_shape": obs, "action_space": 1 if obs == (3,) else 2,
          "is_continuous": obs == (3,)}
    cfg_j, cfg_p = jax_small_config(**kw), port_config(**kw)
    _family, state, _ = get_algo(algo).build(cfg_j, jax.random.key(7))
    port_state = (sac_state_from_flax(state) if algo.startswith("SAC")
                  else train_state_from_flax(state))
    pub = _Collect(PP.encode)
    svc = PLearner(cfg_p, None, 0)
    svc._publish(pub, port_state, ver=11)
    (frame,) = pub.frames
    proto, payload = JP.decode(frame)
    assert proto == JP.Protocol.Model and payload["ver"] == 11 and payload["epoch"] == 0
    want = JLearner(cfg_j, None, 0)._actor_snapshot(state)["actor"]
    got = payload["actor"]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_g] == [jax.tree_util.keystr(k) for k, _ in flat_w]
    for (_, a), (_, b) in zip(flat_g, flat_w, strict=True):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
