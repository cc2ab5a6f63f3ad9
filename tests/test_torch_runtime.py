"""The port's distributed runtime end to end on the CPU
(``learner_device="cpu"``): worker -> manager -> storage -> learner as real
spawned processes over the port's ZMTP sockets and shared memory, mirroring
``tests/test_runtime.py``'s cluster cases (tiny batch, no throttle, bounded
updates, ports from a bind-checked free block). Also: the learner on
``learner_device="auto"`` refuses to run without a card (ROADMAP C 7), and
the CLI's ``local`` role."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_transport import free_block
from tpu_rl_torch.config import Config, MachinesConfig, WorkerMachine


def _machines(base: int, num_p: int = 2) -> MachinesConfig:
    # base + 1 is the model broadcast, base + 2 the inference ROUTER
    return MachinesConfig(
        learner_ip="127.0.0.1", learner_port=base,
        workers=[WorkerMachine(num_p=num_p, manager_ip="127.0.0.1", ip="127.0.0.1",
                               port=base + 5)],
    )


def _cluster_cfg(tmp_path, **kw) -> Config:
    base = dict(
        env="CartPole-v1", algo="PPO", batch_size=8, seq_len=5, hidden_size=16,
        buffer_size=32, obs_shape=(4,), action_space=2, worker_step_sleep=0.0,
        learner_device="cpu", rollout_lag_sec=30.0, time_horizon=100, result_dir=None,
        model_dir=str(tmp_path / "models"), model_save_interval=5, loss_log_interval=1000,
    )
    base.update(kw)
    return Config.from_dict(base)


def _run_learner(sup, timeout: float = 240.0):
    learner = next(c for c in sup.children if c.name == "learner")
    deadline = time.time() + timeout
    while time.time() < deadline and learner.proc.is_alive():
        time.sleep(0.5)
    return learner


@pytest.mark.timeout(300)
@pytest.mark.parametrize("relay_mode", ["raw", "decode"])
def test_local_cluster_end_to_end(tmp_path, relay_mode):
    """The whole local cluster; the learner completes updates fed only by
    worker rollouts, then checkpoints; in both relay modes."""
    from tpu_rl_torch.runtime.runner import local_cluster

    cfg = _cluster_cfg(tmp_path, relay_mode=relay_mode)
    sup = local_cluster(cfg, _machines(free_block(6)), max_updates=6)
    try:
        learner = _run_learner(sup)
        assert not learner.proc.is_alive(), "learner never finished 6 updates"
        assert learner.proc.exitcode == 0
        ckpts = os.listdir(tmp_path / "models")
        assert any(name.startswith("PPO_") for name in ckpts), ckpts
    finally:
        sup.stop()


@pytest.mark.timeout(300)
def test_remote_acting_cluster_end_to_end(tmp_path):
    """Workers act through the learner's InferenceService (DEALER -> ROUTER,
    the fused act step's plain version on the CPU); the learner completes
    its budget; no worker fell back to local acting (telemetry.json)."""
    from tpu_rl_torch.runtime.runner import local_cluster

    cfg = _cluster_cfg(
        tmp_path, act_mode="remote", act_kernel="pallas", inference_batch=4,
        inference_flush_us=2000, inference_timeout_ms=60_000, result_dir=str(tmp_path / "run"),
        telemetry_interval_s=0.5, transport="auto",
    )
    sup = local_cluster(cfg, _machines(free_block(6)), max_updates=6)
    try:
        learner = _run_learner(sup)
        assert not learner.proc.is_alive(), "learner never finished 6 updates under remote acting"
        assert learner.proc.exitcode == 0
        assert any(n.startswith("PPO_") for n in os.listdir(tmp_path / "models"))
        time.sleep(1.5)  # one more telemetry.json write
    finally:
        sup.stop()
    doc = json.loads((tmp_path / "run" / "telemetry.json").read_text())
    roles = {s["role"] for s in doc["sources"]}
    assert {"learner", "storage", "manager", "worker"} <= roles
    lrn = next(s for s in doc["sources"] if s["role"] == "learner")
    counters = {n: v for n, _l, v in lrn["counters"]}
    assert counters["inference-replies"] > 0
    for w in (s for s in doc["sources"] if s["role"] == "worker"):
        assert {n: v for n, _l, v in w["counters"]}["worker-remote-fallbacks"] == 0


@pytest.mark.slow
@pytest.mark.timeout(300)
def test_sac_replay_cluster_end_to_end(tmp_path):
    """Off-policy: rollouts -> storage -> ReplayStore -> the SAC learner
    samples to N updates, then checkpoints."""
    from tpu_rl_torch.runtime.runner import local_cluster

    cfg = _cluster_cfg(tmp_path, algo="SAC", buffer_size=32, model_save_interval=4)
    sup = local_cluster(cfg, _machines(free_block(6)), max_updates=5)
    try:
        learner = _run_learner(sup)
        assert not learner.proc.is_alive(), "SAC learner never finished 5 updates"
        assert learner.proc.exitcode == 0
        assert any(n.startswith("SAC_") for n in os.listdir(tmp_path / "models"))
    finally:
        sup.stop()


@pytest.mark.timeout(300)
def test_supervisor_restarts_dead_child(tmp_path):
    from tpu_rl_torch.runtime.runner import Supervisor, manager_role, worker_role

    cfg = _cluster_cfg(tmp_path)
    sup = Supervisor(heartbeat_timeout=5.0)
    machines = _machines(free_block(6))
    manager_role(cfg, machines, supervisor=sup)
    worker_role(cfg, machines, supervisor=sup)
    try:
        w = next(c for c in sup.children if c.name.startswith("worker"))
        deadline = time.time() + 60
        while time.time() < deadline and not w.proc.is_alive():
            time.sleep(0.2)
        w.proc.kill()
        w.proc.join(10)
        assert not w.proc.is_alive()
        restarted = []
        deadline = time.time() + 30
        while time.time() < deadline and not restarted:
            restarted = sup.check()
            time.sleep(0.5)
        assert any(name.startswith("worker") for name in restarted)
        assert w.restarts == 1 and w.proc.is_alive()
    finally:
        sup.stop()


@pytest.mark.timeout(300)
def test_worker_late_join_feeds_live_cluster(tmp_path):
    """Learner, storage and manager with no worker idle; a worker joined
    later feeds the learner to its budget."""
    from tpu_rl_torch.runtime.runner import Supervisor, learner_role, manager_role, worker_role

    cfg = _cluster_cfg(tmp_path)
    machines = _machines(free_block(6))
    sup = Supervisor()
    learner_role(cfg, machines, supervisor=sup, max_updates=4)
    manager_role(cfg, machines, supervisor=sup)
    try:
        learner = next(c for c in sup.children if c.name == "learner")
        deadline = time.time() + 60
        while time.time() < deadline and not learner.proc.is_alive():
            time.sleep(0.2)
        time.sleep(5.0)
        assert learner.proc.is_alive(), "learner exited with no workers"
        worker_role(cfg, machines, supervisor=sup)  # the late join
        learner = _run_learner(sup, 200)
        assert not learner.proc.is_alive(), "learner never finished after the late worker joined"
        assert learner.proc.exitcode == 0
        assert any(n.startswith("PPO_") for n in os.listdir(tmp_path / "models"))
    finally:
        sup.stop()


@pytest.mark.timeout(180)
def test_worker_warm_start_from_checkpoint(tmp_path):
    """A worker spawned where a checkpoint exists acts with its actor: the
    published logits are recomputed from the rollout's own (obs, hx, cx)
    under the checkpointed actor."""
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.checkpoint import Checkpointer
    from tpu_rl_torch.data.assembler import split_rollout_batch
    from tpu_rl_torch.runtime.protocol import Protocol
    from tpu_rl_torch.runtime.runner import Supervisor, worker_role
    from tpu_rl_torch.runtime.transport import Sub

    cfg = _cluster_cfg(tmp_path)
    family, state, _ = get_algo(cfg.algo).build(cfg, torch.Generator().manual_seed(42), device="cpu")
    ck = Checkpointer(str(tmp_path / "models"), cfg.algo)
    ck.save(state, 11)
    ck.close()
    machines = _machines(free_block(6), num_p=1)
    sub = Sub("127.0.0.1", machines.workers[0].port, bind=True)  # a manager stand-in
    sup = Supervisor()
    worker_role(cfg, machines, supervisor=sup)
    try:
        msg = None
        deadline = time.time() + 120
        while time.time() < deadline and msg is None:
            got = sub.recv(timeout_ms=1000)
            if got is not None and got[0] == Protocol.RolloutBatch:
                msg = split_rollout_batch(got[1])[0]
        assert msg is not None, "no rollout received from warm-started worker"
        with torch.no_grad():
            expected = family.act(
                {"actor": state.params["actor"]},
                torch.as_tensor(msg["obs"], dtype=torch.float32)[None],
                torch.as_tensor(msg["hx"], dtype=torch.float32)[None],
                torch.as_tensor(msg["cx"], dtype=torch.float32)[None],
            )[1]
        np.testing.assert_allclose(np.asarray(msg["logits"]), expected[0].numpy(),
                                   rtol=1e-5, atol=1e-6)
    finally:
        sup.stop()
        sub.close()


@pytest.mark.timeout(300)
def test_learner_chain_matches_sequential_through_shm(tmp_path):
    """learner_chain=K in the learner loop fed through the real
    OnPolicyStore: the same params as the raw train step applied in
    sequence to the same consumed batches."""
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.checkpoint import Checkpointer
    from tpu_rl_torch.data.layout import BatchLayout
    from tpu_rl_torch.data.shm_ring import OnPolicyStore, alloc_handles
    from tpu_rl_torch.runtime.learner_service import LearnerService
    from tpu_rl_torch.types import BATCH_FIELDS, Batch

    K, n_updates, B = 2, 4, 4
    cfg = _cluster_cfg(tmp_path, batch_size=B, learner_chain=K, model_save_interval=100)
    layout = BatchLayout.from_config(cfg)
    handles = alloc_handles(layout, capacity=B)
    store = OnPolicyStore(handles, layout)
    wrng = np.random.default_rng(5)
    windows = []
    for _ in range(n_updates * B):
        w = {}
        for f in BATCH_FIELDS:
            shape = (layout.seq_len, layout.width(f))
            if f == "act":
                w[f] = wrng.integers(0, 2, size=shape).astype(np.float32)
            elif f == "is_fir":
                a = np.zeros(shape, np.float32)
                a[0] = 1.0
                w[f] = a
            elif f == "log_prob":
                w[f] = np.full(shape, -0.7, np.float32)
            else:
                w[f] = wrng.standard_normal(shape).astype(np.float32) * 0.1
        windows.append(w)

    def feed():
        for w in windows:
            while not store.put(w):
                time.sleep(0.001)

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    svc = LearnerService(cfg, handles, model_port=free_block(1), stop_event=threading.Event(),
                         max_updates=n_updates, seed=0)
    svc.run()
    feeder.join(timeout=30)
    assert not feeder.is_alive()

    spec = get_algo(cfg.algo)
    _family, state, train_step = spec.build(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    for i in range(n_updates):
        raw = {f: np.stack([w[f] for w in windows[i * B:(i + 1) * B]]) for f in BATCH_FIELDS}
        state, _ = train_step(state, Batch.from_mapping(raw, device="cpu"), gen)
    template = spec.build(cfg, torch.Generator().manual_seed(0), device="cpu")[1]
    got, idx = Checkpointer(str(tmp_path / "models"), cfg.algo).restore_latest(template)
    assert idx == n_updates
    for k, v in state.params["actor"].items():
        torch.testing.assert_close(got.params["actor"][k], v, rtol=2e-5, atol=1e-6)
    for k, v in state.params["critic"].items() if "critic" in state.params else ():
        torch.testing.assert_close(got.params["critic"][k], v, rtol=2e-5, atol=1e-6)


def test_learner_device_auto_needs_a_card(tmp_path):
    """ROADMAP C 7: learner_device="auto" is the card; without one the
    learner raises before it binds a socket or trains (tpu_rl degrades to
    the CPU instead)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal cannot be observed")
    from tpu_rl_torch.runtime.learner_service import LearnerService
    from tpu_rl_torch.utils.platform import learner_device

    cfg = _cluster_cfg(tmp_path, learner_device="auto")
    assert cfg.learner_device == "auto" == Config().learner_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        learner_device(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LearnerService(cfg, None, model_port=free_block(1)).run()
    assert learner_device(_cluster_cfg(tmp_path)) == "cpu"


def test_host_roles_hide_the_card():
    """A host child starts with no card visible (the supervisor's child
    environment), and force_cpu refuses once CUDA is initialised."""
    from tpu_rl_torch.utils.platform import HOST_ENV

    assert HOST_ENV == {"CUDA_VISIBLE_DEVICES": ""}


@pytest.mark.timeout(300)
def test_cli_local_role(tmp_path):
    """``python -m tpu_rl_torch local --params P --machines M``: the local
    cluster to --max-updates, exit 0, a checkpoint in <result-dir>/models."""
    from tpu_rl_torch.__main__ import main

    params = tmp_path / "params.json"
    params.write_text(json.dumps(dict(
        algo="PPO", batch_size=8, seq_len=5, hidden_size=16, worker_step_sleep=0.0,
        learner_device="cpu", rollout_lag_sec=30.0, time_horizon=100,
        model_save_interval=2, loss_log_interval=1000, supervise_poll_s=0.5)))
    base = free_block(6)
    machines = tmp_path / "machines.json"
    machines.write_text(json.dumps({"learner": {"ip": "127.0.0.1", "port": base},
                                    "workers": [{"num_p": 2, "port": base + 5}]}))
    rc = main(["local", "--env", "CartPole-v1", "--params", str(params), "--machines",
               str(machines), "--max-updates", "3", "--result-dir", str(tmp_path / "run")])
    assert rc == 0
    assert any(n.startswith("PPO_") for n in os.listdir(tmp_path / "run" / "models"))


def test_later_roles_are_refused():
    """The autopilot role waits for its slice; the population role, ported
    with the training-topology slice, builds its controller (and, as
    tpu_rl's, asserts a pop_spec)."""
    from tpu_rl_torch.population import PopulationController
    from tpu_rl_torch.runtime.runner import autopilot_role, population_role

    with pytest.raises(NotImplementedError, match="A 9"):
        autopilot_role(Config())
    with pytest.raises(AssertionError, match="pop_spec"):
        population_role(Config())
    ctrl = population_role(Config.from_dict({"env_mode": "colocated", "result_dir": "unused",
                                             "pop_spec": "lr:log[1e-4,1e-3] k=2"}))
    assert isinstance(ctrl, PopulationController) and len(ctrl.members) == 2


@pytest.mark.timeout(300)
def test_colocated_role_runs_the_colocated_loop(tmp_path):
    """``env_mode="colocated"``: the deployment is one supervised child, the
    existing ColocatedLoop, run to max_updates with exit 0."""
    from tpu_rl_torch.runtime.runner import colocated_role

    cfg = Config.from_dict(dict(env="CartPole-v1", env_mode="colocated", algo="PPO",
                                batch_size=8, seq_len=5, hidden_size=16, learner_device="cpu",
                                supervise_poll_s=0.5))
    sup = colocated_role(cfg, max_updates=3)
    try:
        sup.loop()
        child = sup.children[0]
        assert child.name == "colocated" and child.proc.exitcode == 0
    finally:
        sup.stop()


@pytest.mark.timeout(300)
@pytest.mark.parametrize("algo", ["PPO", "SAC"])
def test_learner_log_cadence_with_watchdog_and_diag(tmp_path, algo):
    """The learner's every-update branches on the CPU, fed through the real
    store: the loss log each update, the learning-dynamics drain into
    learn.jsonl, the watchdog's observe, checkpoints and the closing
    telemetry snapshot (storage's stand-in here: a FanInSub on the stat
    port)."""
    from tpu_rl_torch.data.layout import BatchLayout
    from tpu_rl_torch.data.shm_ring import alloc_handles, make_store
    from tpu_rl_torch.runtime.learner_service import LearnerService
    from tpu_rl_torch.runtime.mailbox import STAT_SLOTS
    from tpu_rl_torch.runtime.protocol import Protocol
    from tpu_rl_torch.runtime.transport import FanInSub
    from tpu_rl_torch.types import BATCH_FIELDS

    cfg = _cluster_cfg(tmp_path, algo=algo, loss_log_interval=1, watchdog_enabled=True,
                       ckpt_keep=2, model_save_interval=2, result_dir=str(tmp_path / "run"),
                       transport="shm", telemetry_interval_s=0.2)
    layout = BatchLayout.from_config(cfg)
    capacity = cfg.buffer_size if algo == "SAC" else cfg.batch_size
    handles = alloc_handles(layout, capacity)
    store = make_store(cfg, layout, handles=handles)
    rng = np.random.default_rng(1)

    def window():
        w = {f: rng.standard_normal((layout.seq_len, layout.width(f))).astype(np.float32) * 0.1
             for f in BATCH_FIELDS}
        w["act"] = rng.integers(0, 2, w["act"].shape).astype(np.float32)
        w["is_fir"][:] = 0.0
        w["is_fir"][0] = 1.0
        w["log_prob"][:] = -0.7
        return w

    stop = threading.Event()

    def feed():
        while not stop.is_set():
            if not store.put(window()):
                time.sleep(0.001)

    port = free_block(2)
    sink = FanInSub("*", port)
    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    mailbox = [0.0] * STAT_SLOTS
    try:
        LearnerService(cfg, handles, model_port=port + 1, stat_array=mailbox, max_updates=4,
                       stop_event=threading.Event(), stat_port=port).run()
        snaps = []
        deadline = time.time() + 10
        while time.time() < deadline and not any(s.get("closing") for s in snaps):
            got = sink.recv(timeout_ms=200)
            if got is not None and got[0] == Protocol.Telemetry:
                snaps.append(got[1])
    finally:
        stop.set()
        feeder.join(10)
        sink.close()
    closing = next(s for s in snaps if s.get("closing"))
    gauges = {n: v for n, _l, v in closing["gauges"]}
    assert gauges["learner-update-index"] == 4
    lines = (tmp_path / "run" / "learn.jsonl").read_text().splitlines()
    assert len(lines) == 4 and json.loads(lines[-1])["idx"] == 4
    assert sorted(os.listdir(tmp_path / "models")) == [f"{algo}_2", f"{algo}_4"]
    assert mailbox[8] == 1.0  # the run epoch (0) + 1 in the cross-respawn slot


@pytest.mark.timeout(300)
def test_learner_anneal_and_stop_at_reward(tmp_path, capsys):
    """entropy_anneal switches the step's coefficients at its absolute
    update; stop_at_reward ends the run once the fleet's 50-game mean (the
    stat mailbox, window full) reaches it."""
    from tpu_rl_torch.data.layout import BatchLayout
    from tpu_rl_torch.data.shm_ring import OnPolicyStore, alloc_handles
    from tpu_rl_torch.runtime.learner_service import LearnerService
    from tpu_rl_torch.runtime.mailbox import SLOT_GAME_COUNT, SLOT_MEAN_REW, STAT_SLOTS
    from tpu_rl_torch.types import BATCH_FIELDS

    cfg = _cluster_cfg(tmp_path, entropy_anneal={"at": 2, "coef": 0.0, "lr": 1e-5},
                       stop_at_reward=20.0, learner_prefetch=0)
    layout = BatchLayout.from_config(cfg)
    handles = alloc_handles(layout, cfg.batch_size)
    store = OnPolicyStore(handles, layout)
    rng = np.random.default_rng(2)
    mailbox = [0.0] * STAT_SLOTS
    stop = threading.Event()

    def feed():
        n = 0
        while not stop.is_set():
            w = {f: rng.standard_normal((layout.seq_len, layout.width(f))).astype(np.float32) * 0.1
                 for f in BATCH_FIELDS}
            w["act"] = rng.integers(0, 2, w["act"].shape).astype(np.float32)
            if store.put(w):
                n += 1
                if n == 3 * cfg.batch_size:  # the fleet "solves" once 3 batches went in
                    mailbox[SLOT_GAME_COUNT], mailbox[SLOT_MEAN_REW] = 50.0, 25.0
            else:
                time.sleep(0.001)

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    svc = LearnerService(cfg, handles, model_port=free_block(1), stat_array=mailbox,
                         max_updates=20, stop_event=threading.Event())
    try:
        svc.run()
    finally:
        stop.set()
        feeder.join(10)
    out = capsys.readouterr().out
    assert "update 2: entropy_coef -> 0.0, lr -> 1e-05" in out
    assert svc.cfg.entropy_coef == 0.0 and svc.cfg.lr == 1e-5
    assert "solved, stopping at update" in out
    idx = int(out.split("solved, stopping at update ")[1].split()[0])
    assert 2 <= idx < 20  # the first update after the mailbox shows the bar
