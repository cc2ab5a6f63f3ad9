"""The port's inference fleet (``tpu_rl_torch.fleet``) on the CPU.

The port of ``tests/test_fleet.py``'s cases (the replica port plan,
FleetClient hedging with the duplicate deduplicated once, failover past a
SIGKILLed replica, the version floor, re-probe adoption, the version-keyed
swap, the ReplicaTable's floor, continuous batching, FleetClient through
real replicas), then parity with ``tpu_rl``'s fleet on the same seeded
inputs and bridged weights: the ReplicaTable on one event sequence, the
replica's replies against ``tpu_rl``'s replica (its Pallas kernel in
interpret mode), the sharded replica's ladder and logits, the wire both
ways, and one ``local_cluster`` with two replicas."""

import json
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tests.conftest import small_config
from tests.test_torch_bridge import with_random_biases
from tests.test_torch_transport import free_block
from tpu_rl.fleet import FleetClient as JaxFleetClient
from tpu_rl.fleet import InferenceReplica as JaxReplica
from tpu_rl.fleet import ReplicaTable as JaxReplicaTable
from tpu_rl.models import cells as jax_cells
from tpu_rl.models.families import build_family as jax_build_family
from tpu_rl_torch.bridge import flax_to_state_dict
from tpu_rl_torch.config import Config, MachinesConfig
from tpu_rl_torch.fleet import FleetClient, InferenceReplica, ReplicaTable
from tpu_rl_torch.models.families import build_family
from tpu_rl_torch.runtime.inference_service import InferenceClient
from tpu_rl_torch.runtime.local_router import LocalRouter
from tpu_rl_torch.runtime.protocol import Protocol
from tpu_rl_torch.runtime.transport import Router

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent


def _fleet_config(**kw):
    base = dict(
        env="CartPole-v1", algo="PPO", act_mode="remote", worker_num_envs=2,
        inference_batch=8, inference_flush_us=2000, inference_timeout_ms=5000,
        inference_retries=1, worker_step_sleep=0.0, hidden_size=16, obs_shape=(4,),
        action_space=2,
    )
    base.update(kw)
    return Config.from_dict(base)


def _obs(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 4)).astype(np.float32)


def _ones(n=2):
    return np.ones(n, np.float32)


def _zeros(n=2):
    return np.zeros(n, np.float32)


def _replica(cfg, router, version=1, seed=0, params=None):
    family = build_family(cfg, device="cpu")
    if params is None:
        params = family.init_params(torch.Generator().manual_seed(seed))
    svc = InferenceReplica(cfg, family, params, router, version=version, device="cpu").start()
    assert svc.wait_ready(60.0) and svc.error is None, svc.error
    return svc


class _FakeReplica(threading.Thread):
    """A scripted replica: a bare ROUTER answering ObsRequest with an Act
    reply after ``delay_s``, stamped with ``self.ver``."""

    def __init__(self, port: int, delay_s: float = 0.0, ver: int = 0):
        super().__init__(daemon=True)
        self.port = port
        self.delay_s = delay_s
        self.ver = ver
        self.n_served = 0
        self._halt = threading.Event()
        self._router = Router("127.0.0.1", port, bind=True)

    def run(self):
        while not self._halt.is_set():
            got = self._router.recv(timeout_ms=50)
            if got is None:
                continue
            identity, proto, payload = got
            if proto != Protocol.ObsRequest or not isinstance(payload, dict):
                continue
            if self.delay_s:
                time.sleep(self.delay_s)
            n = np.asarray(payload["obs"]).shape[0]
            self._router.send(identity, Protocol.Act, {
                "seq": payload["seq"], "act": np.zeros((n, 1), np.float32),
                "logits": np.zeros((n, 2), np.float32),
                "log_prob": np.zeros((n, 1), np.float32), "ver": self.ver,
            })
            self.n_served += 1

    def close(self):
        self._halt.set()
        self.join(timeout=5)
        self._router.close()


# A real OS process serving the replica wire, for the SIGKILL test.
_FAKE_PROC = """
import sys
import numpy as np
from tpu_rl_torch.runtime.protocol import Protocol
from tpu_rl_torch.runtime.transport import Router
router = Router("127.0.0.1", int(sys.argv[1]), bind=True)
print("up", flush=True)
while True:
    got = router.recv(timeout_ms=100)
    if got is None:
        continue
    identity, proto, payload = got
    if proto != Protocol.ObsRequest:
        continue
    n = np.asarray(payload["obs"]).shape[0]
    router.send(identity, Protocol.Act, {
        "seq": payload["seq"], "act": np.zeros((n, 1), np.float32),
        "logits": np.zeros((n, 2), np.float32),
        "log_prob": np.zeros((n, 1), np.float32), "ver": 0,
    })
"""


# ------------------------------------------------------------- port plan
class TestPortPlan:
    def test_explicit_range_is_consecutive(self):
        cfg = _fleet_config(inference_replicas=3, inference_base_port=31000)
        assert MachinesConfig().inference_ports(cfg) == [31000, 31001, 31002]

    def test_default_base_is_legacy_learner_plus_two(self):
        m = MachinesConfig()
        assert m.inference_ports(_fleet_config()) == [m.learner_port + 2]

    def test_collision_with_learner_port_raises(self):
        m = MachinesConfig()
        cfg = _fleet_config(inference_replicas=2, inference_base_port=m.learner_port - 1)
        with pytest.raises(ValueError, match="collides"):
            m.inference_ports(cfg)

    def test_collision_with_telemetry_port_raises(self):
        with pytest.raises(AssertionError, match="telemetry"):
            _fleet_config(inference_replicas=4, inference_base_port=31010,
                          telemetry_port=31012)

    def test_collision_with_worker_manager_port_raises(self):
        m = MachinesConfig()
        cfg = _fleet_config(inference_replicas=2, inference_base_port=m.workers[0].port - 1)
        with pytest.raises(ValueError, match="worker manager"):
            m.inference_ports(cfg)

    def test_validate_rejects_bad_fleet_fields(self):
        for kw in (
            dict(inference_replicas=0),
            dict(inference_hedge_ms=-1),
            dict(inference_timeout_ms=100, inference_hedge_ms=200),  # can never fire
            dict(inference_mesh_data=0),
            dict(inference_replicas=2, inference_base_port=65535),  # off the port space
        ):
            with pytest.raises(AssertionError):
                _fleet_config(**kw)


# ----------------------------------------------------------- fleet client
class TestFleetClient:
    def test_hedge_fires_and_duplicate_deduped_exactly_once(self):
        cfg = _fleet_config(inference_hedge_ms=50, inference_reprobe_s=0.5)
        base = free_block(2)
        slow = _FakeReplica(base, delay_s=0.3, ver=1)
        fast = _FakeReplica(base + 1, ver=1)
        slow.start(), fast.start()
        cl = FleetClient(cfg, [("127.0.0.1", base), ("127.0.0.1", base + 1)])
        try:
            # Bench the fast lane for a moment so the slow replica is the
            # forced primary; by hedge time (50 ms) the bench has lapsed.
            cl.lanes[1].dead_until = time.monotonic() + 0.01
            got = cl.act(_obs(2), _ones(), retries=0)
            assert got is not None and got["ver"] == 1
            assert cl.n_hedges == 1 and cl.n_failovers == 1
            time.sleep(0.5)  # the slow primary's reply lands
            assert cl.act(_obs(2), _zeros(), retries=0) is not None
            assert cl.n_dedups == 1  # discarded exactly once by the next sweep
        finally:
            cl.close()
            slow.close()
            fast.close()

    @pytest.mark.timeout(60)
    def test_sigkilled_replica_mid_request_fails_over(self):
        cfg = _fleet_config(inference_hedge_ms=50, inference_reprobe_s=0.5)
        base = free_block(2)
        victim = subprocess.Popen([sys.executable, "-c", _FAKE_PROC, str(base)], cwd=REPO,
                                  stdout=subprocess.PIPE, text=True)
        live = _FakeReplica(base + 1, ver=0)
        live.start()
        cl = FleetClient(cfg, [("127.0.0.1", base), ("127.0.0.1", base + 1)])
        try:
            assert victim.stdout.readline().strip() == "up"
            cl.lanes[1].dead_until = time.monotonic() + 0.2
            assert cl.act(_obs(2), _ones()) is not None  # the victim serves first
            victim.kill()  # SIGKILL: no FIN handshake from the process, no cleanup
            victim.wait(timeout=10)
            time.sleep(0.3)
            cl.lanes[1].dead_until = time.monotonic() + 0.01
            assert cl.act(_obs(2), _zeros(), retries=0) is not None
            assert cl.n_hedges >= 1 and cl.n_failovers >= 1
            assert cl.lanes[0].fails >= 1  # the dead lane is condemned, backoff armed
            assert cl.n_timeouts == 0
        finally:
            cl.close()
            if victim.poll() is None:
                victim.kill()
            live.close()

    def test_version_floor_rejects_stale_replies(self):
        cfg = _fleet_config(inference_timeout_ms=300, inference_retries=0,
                            inference_reprobe_s=0.2)
        port = free_block(1)
        srv = _FakeReplica(port, ver=5)
        srv.start()
        cl = FleetClient(cfg, [("127.0.0.1", port)])
        try:
            assert cl.act(_obs(2), _ones()) is not None and cl.floor == 5
            srv.ver = 3  # a restarted replica, below the client's floor
            assert cl.act(_obs(2), _zeros()) is None
            assert cl.n_floor_rejects >= 1 and cl.floor == 5
        finally:
            cl.close()
            srv.close()

    @pytest.mark.timeout(60)
    def test_scaled_out_replica_adopted_by_reprobe(self):
        cfg = _fleet_config(inference_hedge_ms=30, inference_retries=0,
                            inference_reprobe_s=0.2)
        base = free_block(2)
        live = _FakeReplica(base, ver=1)
        live.start()
        cl = FleetClient(cfg, [("127.0.0.1", base), ("127.0.0.1", base + 1)])
        late = None
        try:
            first = _ones()
            deadline = time.monotonic() + 10.0
            while cl.lanes[1].fails == 0 or cl.n_reprobes == 0:
                assert time.monotonic() < deadline
                assert cl.act(_obs(2), first, retries=0) is not None
                first = _zeros()
                time.sleep(0.01)
            late = _FakeReplica(base + 1, ver=1)  # arrives on the planned port
            late.start()
            deadline = time.monotonic() + 10.0
            while cl.lanes[1].fails > 0:
                assert time.monotonic() < deadline
                assert cl.act(_obs(2), _zeros()) is not None
                time.sleep(0.02)
            assert cl.n_reprobes >= 1 and cl.n_live == 2
        finally:
            cl.close()
            live.close()
            if late is not None:
                late.close()

    def test_all_lanes_dead_probes_anyway(self):
        cfg = _fleet_config(inference_timeout_ms=2000, inference_reprobe_s=30.0)
        port = free_block(1)
        srv = _FakeReplica(port, ver=0)
        srv.start()
        cl = FleetClient(cfg, [("127.0.0.1", port)])
        try:
            cl.lanes[0].dead_until = time.monotonic() + 30.0
            assert cl.n_live == 0
            assert cl.act(_obs(2), _ones(), retries=0) is not None
            assert cl.lanes[0].dead_until == 0.0  # the reply revived it
        finally:
            cl.close()
            srv.close()


def test_condemned_lane_backoff_stays_capped():
    """Thousands of condemnations of one lane (a replica gone for good)
    keep its re-probe backoff at inference_reprobe_max_s; tpu_rl's float
    power overflows past 1024."""
    cfg = _fleet_config(inference_reprobe_s=0.5, inference_reprobe_max_s=4.0)
    port = free_block(1)
    cl = FleetClient(cfg, [("127.0.0.1", port)])
    jcl = JaxFleetClient(small_config(inference_reprobe_s=0.5, inference_reprobe_max_s=4.0),
                         [("127.0.0.1", port)])
    try:
        with pytest.raises(OverflowError):
            for _ in range(2000):
                jcl._condemn(0)
        for _ in range(2000):
            cl._condemn(0)
        assert 0 < cl.lanes[0].dead_until - time.monotonic() <= 4.0
    finally:
        cl.close()
        jcl.close()


# ------------------------------------------------------ replica versioning
class TestReplicaVersioning:
    def test_ver_keyed_swap_never_rolls_back(self):
        cfg = _fleet_config()
        family = build_family(cfg, device="cpu")
        params = family.init_params(torch.Generator().manual_seed(0))
        svc = InferenceReplica(cfg, family, params, None, version=2, device="cpu")
        svc.set_params({"w": 1}, version=5)
        assert svc.version == 5 and svc.n_stale_sets == 0
        svc.set_params({"w": 2}, version=3)  # a re-delivered old broadcast
        assert svc.version == 5 and svc.n_stale_sets == 1
        svc.set_params({"w": 3}, version=5)  # an exact duplicate: a no-op too
        assert svc.version == 5 and svc.n_stale_sets == 2
        svc.set_params({"w": 4}, version=9)
        assert svc.version == 9 and svc.n_stale_sets == 2

    def test_replica_table_floor_monotonic_across_evict_and_rejoin(self):
        clock = [0.0]
        t = ReplicaTable(lease_s=10.0, clock=lambda: clock[0])
        assert t.touch(0, ver=5) is True
        t.touch(1, ver=3)
        assert t.floor == 5 and t.min_active_version() == 3
        clock[0] = 20.0
        assert sorted(t.evict_expired()) == [0, 1]
        assert t.active == {} and t.min_active_version() == -1
        assert t.floor == 5  # survives the eviction
        assert t.touch(0, ver=-1) is True  # rejoins on random-init weights
        assert t.floor == 5 and t.min_active_version() == -1
        t.touch(0, ver=7)
        assert t.floor == 7 and t.min_active_version() == 7


# --------------------------------------------------- continuous batching
class TestContinuousBatching:
    def test_replica_serves_real_clients(self):
        cfg = _fleet_config(inference_flush_us=10_000_000)
        port = free_block(1)
        router = Router("*", port, bind=True)
        svc = _replica(cfg, router, version=4)
        try:
            cl = InferenceClient(cfg, "127.0.0.1", port, wid=0)
            try:
                for i in range(5):
                    got = cl.act(_obs(2), _ones() if i == 0 else _zeros())
                    assert got is not None and got["act"].shape[0] == 2 and got["ver"] == 4
            finally:
                cl.close()
            deadline = time.monotonic() + 2.0
            while svc.n_replies < 5 and time.monotonic() < deadline:
                time.sleep(0.01)
            # a 2-row tick never fills the 8-row capacity and the deadline is
            # effectively infinite: only the continuous path served these
            assert svc.n_flush_continuous >= 5 and svc.n_flush_deadline == 0
            assert svc.n_replies >= 5
        finally:
            svc.close()
            router.close()

    def test_fleet_client_through_real_replicas(self):
        cfg = _fleet_config(inference_hedge_ms=0)
        base = free_block(2)
        routers = [Router("*", base + i, bind=True) for i in range(2)]
        svcs = [_replica(cfg, r, version=1) for r in routers]
        cl = FleetClient(cfg, [("127.0.0.1", base), ("127.0.0.1", base + 1)])
        try:
            for i in range(8):
                got = cl.act(_obs(2), _ones() if i == 0 else _zeros())
                assert got is not None and got["ver"] == 1
            assert cl.floor == 1
            deadline = time.monotonic() + 2.0
            while sum(s.n_replies for s in svcs) < 8 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert sum(s.n_replies for s in svcs) >= 8
        finally:
            cl.close()
            for s, r in zip(svcs, routers):
                s.close()
                r.close()


# ------------------------------------------------------------ parity
def test_replica_table_matches_tpu_rl_on_one_event_sequence():
    """The same touches, versions and evictions into both tables: the same
    active set, versions, floor, joins and evictions after every event."""
    rng = np.random.default_rng(7)
    clocks = {"jax": [0.0], "port": [0.0]}
    tables = {
        "jax": JaxReplicaTable(lease_s=3.0, clock=lambda: clocks["jax"][0]),
        "port": ReplicaTable(lease_s=3.0, clock=lambda: clocks["port"][0]),
    }
    for _ in range(200):
        kind = rng.integers(3)
        rid, ver, dt = int(rng.integers(4)), int(rng.integers(-1, 12)), float(rng.random())
        out = {}
        for name, t in tables.items():
            clocks[name][0] += dt
            if kind < 2:
                out[name] = t.touch(rid, ver=ver)
            else:
                out[name] = sorted(t.evict_expired())
        assert out["jax"] == out["port"]
        a, b = tables["jax"], tables["port"]
        assert (sorted(a.active), a.versions, a.floor, a.min_active_version(), a.n_joined,
                a.n_evicted) == (sorted(b.active), b.versions, b.floor, b.min_active_version(),
                                 b.n_joined, b.n_evicted)


_STREAM_FIRSTS = [np.array([1, 1], np.float32), np.zeros(2, np.float32),
                  np.array([0, 1], np.float32), np.zeros(2, np.float32)]


def _stream():
    rng = np.random.default_rng(2024)
    return [[rng.standard_normal((2, 4)).astype(np.float32) for _ in range(2)]
            for _ in _STREAM_FIRSTS]


def _drive(clients):
    return [[cl.act(o, f) for cl, o, f in zip(clients, obs_t, [first_t] * 2, strict=True)]
            for obs_t, first_t in zip(_stream(), _STREAM_FIRSTS, strict=True)]


def _hold_to(got, want):
    for t, (got_t, want_t) in enumerate(zip(got, want, strict=True)):
        for k, (g, w) in enumerate(zip(got_t, want_t, strict=True)):
            assert g is not None and w is not None, (t, k)
            np.testing.assert_allclose(g["logits"], w["logits"], atol=1e-5, rtol=0,
                                       err_msg=f"tick {t} client {k}")
            for r in (g, w):
                idx = np.asarray(r["act"])[:, 0].astype(int)
                picked = np.asarray(r["logits"])[np.arange(len(idx)), idx]
                np.testing.assert_allclose(np.asarray(r["log_prob"])[:, 0], picked, atol=1e-6)


@pytest.fixture(scope="module")
def jax_fleet():
    """tpu_rl's replica (its Pallas act kernel in interpret mode), seeded
    weights with random biases: the actor (numpy) and its replies to the
    scripted stream through tpu_rl's FleetClient."""
    cfg = small_config(
        algo="PPO", hidden_size=16, obs_shape=(4,), action_space=2, worker_num_envs=2,
        inference_batch=8, act_mode="remote", act_kernel="pallas", inference_timeout_ms=10_000,
        inference_retries=0, inference_replicas=2,
    )
    family = jax_build_family(cfg)
    params = family.init_params(jax.random.key(0), seq_len=cfg.seq_len)
    params = {**params, "actor": with_random_biases(params["actor"], 3)}
    actor = jax.tree_util.tree_map(np.asarray, jax.device_get(params["actor"]))
    port = free_block(1)
    jax_cells.set_pallas_mode("interpret")
    try:
        svc = JaxReplica(cfg, family, params, port=port, version=3).start()
        assert svc.wait_ready(120.0) and svc.error is None, svc.error
    finally:
        jax_cells.set_pallas_mode("auto")
    clients = [JaxFleetClient(cfg, [("127.0.0.1", port)], wid=k) for k in range(2)]
    try:
        replies = _drive(clients)
    finally:
        for cl in clients:
            cl.close()
    yield cfg, actor, replies, port, svc
    svc.close()


@pytest.mark.parametrize("act_kernel", ["pallas", "xla"])
def test_replica_replies_match_tpu_rl_replica(jax_fleet, act_kernel):
    """The same bridged weights and scripted stream: the port's replica
    (B3's plain version on the CPU under "pallas") answers as tpu_rl's
    replica does: logits within 1e-5, and each side's log_prob is its own
    logits at its own action within 1e-6 (the sampled actions differ by
    design: threefry against Philox)."""
    _cfg, actor, want, _port, _svc = jax_fleet
    cfg = _fleet_config(act_kernel=act_kernel, inference_replicas=2)
    router = LocalRouter()
    svc = _replica(cfg, router, version=3, params={"actor": flax_to_state_dict(actor)})
    try:
        got = _drive([router.client(f"w{k}".encode()) for k in range(2)])
    finally:
        svc.close()
    _hold_to(got, want)
    assert all(r["ver"] == 3 for tick in got for r in tick)
    assert svc.n_flush_deadline == 0 and svc.n_flush_continuous >= len(_STREAM_FIRSTS)


def test_sharded_replica_ladder_and_logits(jax_fleet):
    """inference_mesh_data=2: the same bucket ladder as tpu_rl's replica
    over 2 of the host's devices (every bucket rounded up to a multiple of
    2), each flush split in two shares and gathered in row order, with the
    same logits as the one-device replica and as tpu_rl's replica on the
    same weights and stream (logits do not depend on the ladder)."""
    _cfg, actor, want, _port, _svc = jax_fleet
    kw = dict(hidden_size=16, inference_batch=7, worker_num_envs=1, inference_buckets=1)
    jcfg = small_config(algo="PPO", obs_shape=(4,), action_space=2, act_mode="remote",
                        inference_mesh_data=2, **kw)
    jfam = jax_build_family(jcfg)
    jparams = jfam.init_params(jax.random.key(0), seq_len=jcfg.seq_len)
    jsvc = JaxReplica(jcfg, jfam, jparams, port=free_block(1), version=0).start()
    try:
        assert jsvc.wait_ready(120.0) and jsvc.error is None, jsvc.error
        jax_ladder = list(jsvc.buckets)
    finally:
        jsvc.close()
    params = {"actor": flax_to_state_dict(actor)}
    replies = {}
    for n in (1, 2):
        cfg = _fleet_config(inference_mesh_data=n, **kw)
        router = LocalRouter()
        svc = _replica(cfg, router, version=0, params=params)
        try:
            replies[n] = _drive([router.client(f"w{k}".encode()) for k in range(2)])
            ladder = list(svc.buckets)
        finally:
            svc.close()
        if n == 2:
            assert len(svc.shards) == 2 and ladder == jax_ladder == [2, 4, 8]
            assert all(b % 2 == 0 for b in ladder)
        else:
            assert ladder == [1, 2, 4, 7]
    _hold_to(replies[2], replies[1])
    _hold_to(replies[2], want)


def test_sharded_replica_refuses_more_devices_than_the_host_has(monkeypatch):
    from tpu_rl_torch.fleet.replica import shard_devices

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, only 1 visible"):
        shard_devices(2, "cuda")
    assert shard_devices(3, "cpu") == [torch.device("cpu")] * 3


def test_tpu_rl_fleet_client_drives_port_replicas(jax_fleet):
    """The wire one way: tpu_rl's FleetClient (pyzmq) through two of the
    port's replicas (ZMTP on stdlib sockets), hedging between them."""
    jcfg, actor, _want, _port, _svc = jax_fleet
    cfg = _fleet_config(inference_replicas=2)
    base = free_block(2)
    routers = [Router("*", base + i, bind=True) for i in range(2)]
    svcs = [_replica(cfg, r, version=5, params={"actor": flax_to_state_dict(actor)})
            for r in routers]
    cl = JaxFleetClient(jcfg, [("127.0.0.1", base), ("127.0.0.1", base + 1)], wid=0)
    try:
        for i in range(6):
            got = cl.act(_obs(2, i), _ones() if i == 0 else _zeros())
            assert got is not None and got["ver"] == 5 and got["logits"].shape == (2, 2)
        assert cl.floor == 5 and cl.n_timeouts == 0
    finally:
        cl.close()
        for s, r in zip(svcs, routers):
            s.close()
            r.close()


def test_port_fleet_client_drives_tpu_rl_replica(jax_fleet):
    """The wire the other way: the port's FleetClient through tpu_rl's
    replica, whose answers match the port's replica's."""
    _jcfg, actor, want, port, _svc = jax_fleet
    cfg = _fleet_config(inference_replicas=2, inference_timeout_ms=10_000)
    clients = [FleetClient(cfg, [("127.0.0.1", port)], wid=10 + k) for k in range(2)]
    try:
        got = _drive(clients)
        assert all(cl.floor == 3 and cl.n_timeouts == 0 for cl in clients)
    finally:
        for cl in clients:
            cl.close()
    _hold_to(got, want)


@pytest.mark.timeout(300)
def test_local_cluster_with_two_replicas(tmp_path):
    """``local_cluster`` on the CPU with act_mode="remote" and two replicas:
    the learner (replica 0) and an ``inference-1`` child; the learner exits
    0 at its budget, both replicas answer, storage's fleet gauges are set,
    and no worker falls back to local acting."""
    from tests.test_torch_runtime import _cluster_cfg, _machines, _run_learner
    from tpu_rl_torch.runtime.runner import local_cluster

    cfg = _cluster_cfg(
        tmp_path, act_mode="remote", act_kernel="pallas", inference_batch=4,
        inference_replicas=2, inference_timeout_ms=60_000, result_dir=str(tmp_path / "run"),
        telemetry_interval_s=0.5, transport="auto",
    )
    sup = local_cluster(cfg, _machines(free_block(6)), max_updates=6)
    try:
        assert {c.name for c in sup.children} >= {"learner", "storage", "inference-1"}
        learner = _run_learner(sup)
        assert not learner.proc.is_alive() and learner.proc.exitcode == 0
        time.sleep(1.5)  # one more telemetry.json write
    finally:
        sup.stop()
    doc = json.loads((tmp_path / "run" / "telemetry.json").read_text())

    def counters(s, kind="counters"):
        return {n: v for n, _l, v in s[kind]}

    srcs = doc["sources"]
    lrn = next(s for s in srcs if s["role"] == "learner")
    rep = next(s for s in srcs if s["role"] == "inference")
    sto = next(s for s in srcs if s["role"] == "storage")
    assert counters(lrn)["inference-replies"] > 0
    assert counters(rep)["inference-replies"] > 0
    assert counters(rep)["inference-flush-deadline"] == 0
    assert counters(sto, "gauges")["fleet-replicas-active"] == 1
    assert counters(sto, "gauges")["fleet-version-floor"] >= 0
    assert counters(sto)["fleet-replicas-joined"] >= 1
    for w in (s for s in srcs if s["role"] == "worker"):
        assert counters(w)["worker-remote-fallbacks"] == 0
