"""Multi-process bring-up of the port on the CPU (gloo), as
``tests/test_multihost.py`` and ``tests/test_colocated_multihost.py`` do for
``tpu_rl``: 2 and 4 processes through ``init_multihost`` on localhost, each a
"host" feeding its own rows (``host_local_batch_to_global``), whose
data-parallel step and ring attention equal the single-process results; the
colocated loop's pod (``multihost``, ``mesh_data=1`` widened to the world),
on hosts of one and of two ranks, against the single-host run at
``mesh_data`` = world (bit for bit: the same program) and both against the
one-device loop (``tests/test_colocated_multihost.py:65``'s parity: same
episodes, params rtol 1e-4 / atol 1e-5); a host's ranks counted from its
cards; the multihost learner's watchdog rollback on every rank; and the
learner service at ``mesh_data=2`` in a local cluster, which exits 0 at
exactly ``max_updates`` with every rank's updates in its closing
telemetry. Ranks are subprocesses that import no jax."""

import json
import os
import time

import numpy as np
import pytest
import torch

from tests.test_torch_colocated import free_port
from tests.test_torch_ppo import _batch_np
from tests.test_torch_runtime import _cluster_cfg, _machines, _run_learner
from tests.test_torch_transport import free_block
from tests.torch_rank_child import run_ranks
from tpu_rl_torch.algos.registry import get_algo
from tpu_rl_torch.config import Config
from tpu_rl_torch.parallel.sequence import full_attention
from tpu_rl_torch.types import Batch
from tpu_rl_torch.utils.tree import tree_leaves

RAW = dict(algo="IMPALA", hidden_size=16, seq_len=5, batch_size=8, buffer_size=32,
           obs_shape=(4,), action_space=2, K_epoch=1)
COLOCATED = dict(env="CartPole-v1", env_mode="colocated", algo="PPO", colocated_envs=8,
                 hidden_size=16, learner_device="cpu", loss_log_interval=10**9)
UPDATES = 6


@pytest.mark.parametrize("nprocs", [2, 4])
def test_init_multihost_processes(tmp_path, nprocs):
    """``nprocs`` processes join through ``init_multihost`` at a localhost
    coordinator (idempotent, ``is_multihost``); each feeds its own rows of
    the global batch, and the data-parallel step equals the one-process
    step on the whole batch; the ring's K/V rotation crosses the process
    boundary and equals full attention."""
    cfg = Config.from_dict(RAW)
    _f, state, step = get_algo("IMPALA").build(cfg, torch.Generator().manual_seed(0),
                                               device="cpu")
    batch = _batch_np(cfg, 5)
    rng = np.random.default_rng(1)
    B, T, H, D = 2, 8 * nprocs, 2, 4
    q, k, v, w = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(4))
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    seg = np.ones((B, T), np.int32)
    seg[:, T // 3:] = 2
    jobs = [dict(kind="dp", raw=RAW, state=state, batches=[batch], kw=[{}], host_local=True),
            dict(kind="attn", impl="ring", mesh=(1, nprocs), q=q, k=k, v=v, pos=pos, seg=seg,
                 w=w)]
    res = run_ranks(jobs, nprocs, str(tmp_path), coordinator=f"127.0.0.1:{free_port()}")
    _new, want = step(state, Batch.from_mapping(batch, device="cpu"))
    for r in res:
        np.testing.assert_allclose(float(r[0]["metrics"]["loss"]), float(want["loss"]),
                                   rtol=2e-4, atol=2e-5)
    o = full_attention(*(torch.tensor(x) for x in (q, k, v, pos, seg)))
    for r in res:
        got = r[1]
        np.testing.assert_allclose(got["o"].numpy(), o[got["rows"], got["cols"]].numpy(),
                                   atol=2e-5)


@pytest.mark.parametrize("local_ranks", [1, 2])
def test_colocated_pod_matches_single_host(tmp_path, local_ranks):
    """The pod (2 hosts of ``local_ranks`` ranks each, every loop joining
    through its config's ``multihost``, ``mesh_data=1`` widened to the
    world) and the single-host run (as many ranks, ``mesh_data`` = world)
    are the same program: equal params and episodes on every rank; and
    both are the one-device loop up to the order of the gradient's
    reduction."""
    from tpu_rl_torch.runtime.colocated import ColocatedLoop

    world = 2 * local_ranks
    port = free_port()
    pod_raw = dict(COLOCATED, multihost={"coordinator": f"127.0.0.1:{port}",
                                         "num_processes": 2, "process_id": 0})
    (tmp_path / "pod").mkdir()
    pod = run_ranks([dict(kind="colocated", raw=pod_raw, updates=UPDATES)], world,
                    str(tmp_path / "pod"), coordinator=f"127.0.0.1:{port}", pod=True,
                    local_ranks=local_ranks)
    (tmp_path / "one").mkdir()
    one_host = run_ranks([dict(kind="colocated", raw=dict(COLOCATED, mesh_data=world),
                               updates=UPDATES)], world, str(tmp_path / "one"))
    loop = ColocatedLoop(Config.from_dict(COLOCATED), seed=0, max_updates=UPDATES, device="cpu")
    single = loop.run(log=False)
    want = torch.cat([t.reshape(-1) for t in loop.state.params["actor"].values()])
    runs = [r[0] for r in pod + one_host]
    assert [r["world"] for r in runs] == [world] * (2 * world)
    for r in runs:
        torch.testing.assert_close(r["params"], runs[0]["params"], rtol=0, atol=0)
        assert r["episodes"] == single["episodes"]
    np.testing.assert_allclose(runs[0]["params"].numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


def test_multihost_takes_tpu_rl_keys_and_a_rank_per_card(monkeypatch):
    """``multihost`` takes tpu_rl's three keys; a host's ranks are its
    cards (one on the CPU), which the colocated pod and the multihost
    learner both spawn: the learner role's child is a group of one rank per
    card whose ranks join the pod themselves (no file rendezvous), and a
    host's batch must split over its ranks."""
    from tpu_rl_torch.runtime import runner
    from tpu_rl_torch.runtime.learner_service import LearnerService
    from tpu_rl_torch.runtime.runner import _host_ranks, learner_role

    host = {"coordinator": "127.0.0.1:1", "num_processes": 2, "process_id": 0}
    with pytest.raises(ValueError, match="coordinator, num_processes and process_id"):
        Config.from_dict({"multihost": dict(host, local_ranks=2)})
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    colocated = Config.from_dict(dict(COLOCATED, learner_device="auto", multihost=host))
    assert _host_ranks(colocated) == 4
    assert _host_ranks(colocated.replace(learner_device="cpu")) == 1
    learner = Config.from_dict(dict(RAW, multihost=host))
    spawned = {}

    def spawn(self, name, target, *args, **kw):
        spawned[name] = kw

    monkeypatch.setattr(runner.Supervisor, "spawn", spawn)
    monkeypatch.setattr(runner, "alloc_handles", lambda *a, **k: None)
    learner_role(learner, _machines(free_block(6)))
    assert spawned["learner"]["world"] == 4 and spawned["learner"]["rank_init"] is False
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    monkeypatch.setattr("tpu_rl_torch.parallel.multihost.init_multihost", lambda *a, **k: None)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 6)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    monkeypatch.setattr("tpu_rl_torch.parallel.mesh._build", lambda shape, dev: None)
    with pytest.raises(ValueError, match="not divisible by the host's 3 ranks"):
        LearnerService(learner.replace(learner_device="cpu"), None, 0).run()


@pytest.mark.timeout(300)
def test_multihost_learner_rollback_reaches_every_rank(tmp_path):
    """Two multihost learners, each fed by its own store: world rank 0's
    watchdog trips at update 5 and rolls back to the committed index 2;
    the other rank takes the restored state, index and run epoch, so both
    run the same 11 updates to ``max_updates`` 8 and end with equal
    params."""
    port = free_port()
    raw = dict(RAW, env="CartPole-v1", algo="PPO", obs_shape=(4,), learner_device="cpu",
               model_dir=str(tmp_path / "models"), model_save_interval=2, ckpt_keep=2,
               watchdog_enabled=True, loss_log_interval=1,
               multihost={"coordinator": f"127.0.0.1:{port}", "num_processes": 2,
                          "process_id": 0})
    res = run_ranks([dict(kind="learner", raw=raw, updates=8, trip_at=5,
                          model_ports=[free_port(), free_port()])], 2, str(tmp_path),
                    coordinator=f"127.0.0.1:{port}", pod=True)
    runs = [r[0] for r in res]
    for r in runs:
        assert (r["world"], r["updates"], r["rollbacks"], r["epoch"], r["ver"]) == (2, 11, 1, 1, 8)
    torch.testing.assert_close(runs[1]["params"], runs[0]["params"], rtol=0, atol=0)


@pytest.mark.timeout(300)
def test_multihost_learner_rollback_reaches_every_rank_of_every_host(tmp_path):
    """As above on two hosts of two ranks each: world rank 0's rollback
    reaches the other host's rank 0 through the verdict's broadcast and
    every host's follower through its host's channel, so all four ranks
    run the same 11 updates and end with equal params."""
    port = free_port()
    raw = dict(RAW, env="CartPole-v1", algo="PPO", obs_shape=(4,), learner_device="cpu",
               model_dir=str(tmp_path / "models"), model_save_interval=2, ckpt_keep=2,
               watchdog_enabled=True, loss_log_interval=1,
               multihost={"coordinator": f"127.0.0.1:{port}", "num_processes": 2,
                          "process_id": 0})
    res = run_ranks([dict(kind="learner", raw=raw, updates=8, trip_at=5,
                          model_ports=[free_port() for _ in range(4)])], 4, str(tmp_path),
                    coordinator=f"127.0.0.1:{port}", pod=True, local_ranks=2)
    runs = [r[0] for r in res]
    for r in runs:
        assert (r["world"], r["updates"], r["rollbacks"], r["epoch"]) == (4, 11, 1, 1)
        torch.testing.assert_close(r["params"], runs[0]["params"], rtol=0, atol=0)
    assert runs[0]["ver"] == runs[2]["ver"] == 8


@pytest.mark.timeout(300)
def test_learner_dp_cluster_exits_at_max_updates(tmp_path):
    """The learner at ``mesh_data=2`` in a local cluster: its two ranks are
    one supervised child; rank 0 samples and scatters, both train; the
    group exits 0 at exactly ``max_updates``, and the closing telemetry
    carries every rank's updates, ``mesh-world`` and ``mesh-backend``."""
    from tpu_rl_torch.runtime.runner import RankGroup, local_cluster

    rdir = tmp_path / "res"
    cfg = _cluster_cfg(tmp_path, mesh_data=2, result_dir=str(rdir), telemetry_interval_s=1.0,
                       model_dir=None)
    sup = local_cluster(cfg, _machines(free_block(6)), max_updates=UPDATES)
    try:
        learner = _run_learner(sup)
        assert isinstance(learner.proc, RankGroup) and learner.proc.world == 2
        assert not learner.proc.is_alive(), "the learner never finished"
        assert learner.proc.exitcode == 0
        snap = None
        deadline = time.time() + 30
        while snap is None and time.time() < deadline:
            path = rdir / "telemetry.json"
            if path.exists():
                try:
                    srcs = json.loads(path.read_text())["sources"]
                except (ValueError, KeyError):
                    srcs = []
                snap = next((s for s in srcs if s.get("role") == "learner" and s.get("closing")),
                            None)
            time.sleep(0.25)
        assert snap is not None, os.listdir(rdir)
        counters = {n: v for n, _l, v in snap["counters"]}
        gauges = {(n, tuple(sorted(lab.items()))): v for n, lab, v in snap["gauges"]}
        assert counters["learner-updates-run-rank0"] == counters["learner-updates-run-rank1"] \
            == UPDATES
        assert gauges[("mesh-world", ())] == 2
        assert gauges[("mesh-backend", (("backend", "gloo"),))] == 1
        assert counters["learner-scattered-bytes"] > 0
    finally:
        sup.stop()


@pytest.mark.timeout(300)
def test_multihost_learner_hosts_of_two_ranks_match_one_rank(tmp_path):
    """Two hosts of two ranks each (gloo subprocesses, one store a host):
    each host's rank 0 samples only its own storage (every row a rank
    trains on carries its host's tag) and scatters the rows over the
    host-local group; all four ranks end on the same params, which equal
    the one-rank learner's steps on the global batches (each host's batch
    in host order) at the data-parallel bars (params rtol 1e-4, atol
    1e-5)."""
    port = free_port()
    raw = dict(RAW, env="CartPole-v1", algo="PPO", obs_shape=(4,), learner_device="cpu",
               loss_log_interval=2,
               multihost={"coordinator": f"127.0.0.1:{port}", "num_processes": 2,
                          "process_id": 0})
    res = run_ranks([dict(kind="learner", raw=raw, updates=UPDATES, trip_at=None, record=True,
                          model_ports=[free_port() for _ in range(4)])], 4, str(tmp_path),
                    coordinator=f"127.0.0.1:{port}", pod=True, local_ranks=2)
    runs = [r[0] for r in res]
    for rank, r in enumerate(runs):
        assert (r["world"], r["updates"]) == (4, UPDATES)
        assert r["tags"] == [float(rank // 2)], (rank, r["tags"])
        torch.testing.assert_close(r["params"], runs[0]["params"], rtol=0, atol=0)
    assert runs[1]["assembled"] == runs[3]["assembled"] == []
    cfg = Config.from_dict(dict(raw, multihost=None))
    _f, state, step = get_algo("PPO").build(cfg, torch.Generator().manual_seed(0), device="cpu")
    for k in range(UPDATES):
        host_batches = [runs[0]["assembled"][k], runs[2]["assembled"][k]]
        glob = {f: np.concatenate([b[f] for b in host_batches]) for f in host_batches[0]
                if f != "ver"}
        state, _m = step(state, Batch.from_mapping(glob, device="cpu"))
    want = torch.cat([t.reshape(-1) for t in tree_leaves(state.params)])
    np.testing.assert_allclose(runs[0]["params"].numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
