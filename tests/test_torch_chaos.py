"""The port's chaos plane against ``tpu_rl``'s, in the same process: the
fault-plan grammar (every spec of ``tests/test_chaos.py``, good and bad),
the transport, data, service and process injectors fed the same inputs,
seeds and clocks (the same bytes, payloads, signals and counts out), the
port's inference service under ``refuse:`` (the client times out and the
worker falls back), and a CPU cluster under the chip smoke's chaos plan
(worker kill, rollout corruption, relay delay, inference stall)."""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from tpu_rl import chaos as J
from tpu_rl_torch import chaos as T
from tpu_rl_torch.config import Config
from tpu_rl_torch.runtime import protocol as TP

# tests/test_chaos.py's specs: the full one, its resolver cases, and its
# malformed ones.
GOOD_SPECS = [
    "kill:worker-0-1@t+3s,corrupt:rollout@p=0.01,delay:manager@50ms,hang:storage@t+5s,"
    "stall:inference@200ms@p=0.5,refuse:inference@p=0.1,drop:model@p=0.2",
    "corrupt:rollout@p=0.5",
    "drop:model@p=0.5",
    "delay:manager@10ms,delay:storage@5ms@p=0.5",
    "corrupt:rollout@p=0.1",
    "corrupt:rollout@p=1.0",
    "drop:model@p=1.0",
    "delay:manager@20ms",
    "stall:inference@500ms,refuse:inference@p=1.0",
    "kill:worker@t+1s",
    "refuse:inference@p=0.5",
    "kill:worker-0-1@t+3s",
    "hang:worker@t+0s",
    "kill:learner@t+1s",
    # the chip smoke's plans
    "kill:worker-0-1@t+6s,corrupt:rollout@p=0.02,delay:manager@10ms@p=0.2,stall:inference@5ms",
    "nan:rollout@p=0.4@t+4s@for=6s@wid=1,spike:rollout@p=0.2@t+4s@for=6s@wid=1,"
    "nan:logp@p=0.5@t+2s@for=25s@wid=0",
    "stall:inference@40ms,kill:inference-1@t+5s",
]
BAD_SPECS = [
    "", "explode:worker@t+1s", "kill:worker", "corrupt:worker@p=0.1", "corrupt:rollout",
    "corrupt:rollout@p=0", "corrupt:rollout@p=1.5", "delay:rollout@10ms", "delay:manager",
    "stall:inference", "refuse:inference", "stall:storage@10ms", "kill:@t+1s", "kill",
    "nan:model@p=0.5", "spike:rollout", "nan:rollout@p=0.5@for=0s", "kill:x@t+1s@wid=a",
]


def _resolved(plan) -> dict:
    def rows(faults):
        return [dataclasses.asdict(f) for f in faults]

    return {
        "faults": rows(plan.faults),
        "process": rows(plan.process_faults()),
        "transport": {s: [rows(x) for x in plan.transport_faults(s)]
                      for s in ("worker", "manager", "learner", "storage")},
        "service": rows(plan.service_faults()),
        "data": {i: rows(plan.data_faults(i)) for i in (None, 0, 1, 2)},
    }


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_fault_plan_resolves_as_tpu_rl(spec):
    assert _resolved(T.FaultPlan.parse(spec)) == _resolved(J.FaultPlan.parse(spec))


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_plan_refuses_as_tpu_rl(spec):
    with pytest.raises(ValueError) as want:
        J.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        T.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("site,instance", [("storage", 0), ("worker", 3), ("inference", 0)])
def test_site_seed_matches(site, instance):
    for seed in (0, 7, 2**31 + 5):
        assert T.site_seed(seed, site, instance) == J.site_seed(seed, site, instance)


def _frames():
    """A stream of frames of every channel, encoded by the port's codec (byte
    for byte tpu_rl's frames, tests/test_torch_protocol.py)."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(120):
        kind = (TP.Protocol.RolloutBatch, TP.Protocol.Rollout, TP.Protocol.Stat,
                TP.Protocol.Model, TP.Protocol.Telemetry)[i % 5]
        payload = {"i": i, "obs": rng.standard_normal((4, 4)).astype(np.float32)}
        out.append(TP.encode(kind, payload if kind != TP.Protocol.Stat else float(i)))
    return out


@pytest.mark.parametrize("spec,site,side", [
    ("corrupt:rollout@p=0.5", "storage", "recv"),
    ("corrupt:rollout@p=0.02,corrupt:stat@p=0.5,drop:telemetry@p=0.3", "storage", "recv"),
    ("drop:model@p=0.5,corrupt:model@p=0.5", "worker", "recv"),
    ("delay:manager@10ms@p=0.2", "manager", "send"),
    ("delay:storage@5ms@p=0.5,corrupt:rollout@p=1.0", "storage", "recv"),
])
def test_transport_chaos_bytes_match(spec, site, side):
    """The same frames through both packages' shims at one seed: the same
    bytes (or swallow) out, the same sleeps and counts; every corrupted
    frame is rejected by the port's decode, so injected == rejected."""
    seed = J.site_seed(7, site)
    slept_j, slept_t = [], []
    jc = J.TransportChaos(*J.FaultPlan.parse(spec).transport_faults(site), seed=seed,
                          sleep=slept_j.append)
    tc = T.TransportChaos(*T.FaultPlan.parse(spec).transport_faults(site), seed=seed,
                          sleep=slept_t.append)
    rejected = 0
    for parts in _frames():
        want = getattr(jc, f"on_{side}")(list(parts))
        got = getattr(tc, f"on_{side}")(list(parts))
        assert got == want
        if got is not None:
            try:
                TP.decode(got)
            except ValueError:
                rejected += 1
    assert slept_t == slept_j
    counts = [(c.n_corrupted, c.n_dropped, c.n_delayed) for c in (tc, jc)]
    assert counts[0] == counts[1]
    assert rejected == tc.n_corrupted
    assert tc.n_corrupted + tc.n_dropped + tc.n_delayed > 0


def test_corrupted_frames_pass_peek_but_fail_decode():
    """The flip lands past the port's 12-byte header: the relay's header
    check passes, the body CRC fails."""
    tc = T.TransportChaos(*T.FaultPlan.parse("corrupt:rollout@p=1.0").transport_faults("storage"),
                          seed=1)
    for i in range(30):
        parts = tc.on_recv(TP.encode(TP.Protocol.RolloutBatch, {"x": np.arange(i + 1.0)}))
        assert parts[1][:TP._HEADER.size] == TP.encode(
            TP.Protocol.RolloutBatch, {"x": np.arange(i + 1.0)})[1][:TP._HEADER.size]
        with pytest.raises(ValueError):
            TP.decode(parts)
    assert tc.n_corrupted == 30


def _payload(seed: int, n: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "rew": rng.standard_normal((n, 1)).astype(np.float32),
        "log_prob": rng.standard_normal((n, 1)).astype(np.float32),
        "act": rng.integers(0, 2, (n, 1)).astype(np.float32),
    }


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("spec,instance", [
    ("nan:rollout@p=0.4@t+4s@for=6s@wid=1,spike:rollout@p=0.2@t+4s@for=6s@wid=1,"
     "nan:logp@p=0.5@t+2s@for=25s@wid=0", 0),
    ("nan:rollout@p=0.4@t+4s@for=6s@wid=1,spike:rollout@p=0.2@t+4s@for=6s@wid=1,"
     "nan:logp@p=0.5@t+2s@for=25s@wid=0", 1),
    ("nan:rollout@p=0.3,spike:rollout@p=0.3,nan:logp@p=0.3", 2),
])
@pytest.mark.parametrize("columns", ["numpy", "read-only numpy", "tensor views"])
def test_data_chaos_payloads_match(spec, instance, columns):
    """The same payloads, seed and clock through both packages' DataChaos:
    the same values poisoned, bit for bit, the same counts. A read-only
    column (a decoded reply's) is swapped for a copy, as in tpu_rl; a
    writable one is poked in place: the port's local act step hands its CPU
    tensors over as ``.numpy()`` views, and the tensor sees the poke."""
    clock = [100.0]
    seed = J.site_seed(11, "worker", instance)
    jd = J.DataChaos(J.FaultPlan.parse(spec).data_faults(instance), seed, clock=lambda: clock[0])
    td = T.DataChaos(T.FaultPlan.parse(spec).data_faults(instance), seed, clock=lambda: clock[0])
    for tick in range(200):
        clock[0] = 100.0 + tick * 0.2
        want = _payload(tick)
        for x in want.values():
            x.flags.writeable = False
        got = _payload(tick)
        tensors = {}
        if columns == "read-only numpy":
            for x in got.values():
                x.flags.writeable = False
        elif columns == "tensor views":
            tensors = {k: torch.from_numpy(v.copy()) for k, v in got.items()}
            got = {k: t.numpy() for k, t in tensors.items()}
        before = dict(got)
        jd.on_tick(want)
        td.on_tick(got)
        for k in want:
            assert _same(got[k], want[k]), (tick, k)
            if columns != "read-only numpy":
                assert got[k] is before[k]  # poked in place
            if tensors:
                assert _same(tensors[k].numpy(), want[k])
    assert (td.n_nan, td.n_spike, td.n_logp_nan) == (jd.n_nan, jd.n_spike, jd.n_logp_nan)


class _Proc:
    def __init__(self, pid, alive=True):
        self.pid = pid
        self._alive = alive

    def is_alive(self):
        return self._alive


class _Child:
    def __init__(self, name, pid, alive=True):
        self.name = name
        self.proc = _Proc(pid, alive)


@pytest.mark.parametrize("spec", [
    "kill:worker-0-1@t+3s",
    "hang:worker@t+0s,kill:learner@t+1s",
    "kill:worker-0-1@t+6s,stop:storage@t+2s,kill:inference-1@t+5s",
])
def test_process_chaos_fires_as_tpu_rl(spec):
    """One fake clock, the same children (one of them dead until t+4 s):
    the same signals at the same pids at the same polls."""
    clock = [0.0]
    sent = {"j": [], "t": []}
    jc = J.ProcessChaos.from_spec(spec, clock=lambda: clock[0],
                                  kill=lambda pid, sig: sent["j"].append((clock[0], pid, sig)))
    tc = T.ProcessChaos.from_spec(spec, clock=lambda: clock[0],
                                  kill=lambda pid, sig: sent["t"].append((clock[0], pid, sig)))
    kids = [_Child("worker-0-0", 10), _Child("worker-0-1", 11), _Child("learner", 12),
            _Child("storage", 13), _Child("inference-1", 14, alive=False)]
    fired = {"j": [], "t": []}
    for step in range(20):
        clock[0] = step * 0.5
        if clock[0] >= 4.0:
            kids[4].proc._alive = True
        fired["j"].append(jc.poll(kids))
        fired["t"].append(tc.poll(kids))
    assert fired["t"] == fired["j"] and sent["t"] == sent["j"]
    assert (tc.n_kills, tc.n_stops) == (jc.n_kills, jc.n_stops)
    assert sent["t"]


@pytest.mark.parametrize("spec", [
    "stall:inference@500ms,refuse:inference@p=1.0",
    "stall:inference@40ms@p=0.5,refuse:inference@p=0.3",
    "stall:inference@5ms",
])
def test_service_chaos_draws_as_tpu_rl(spec):
    seed = J.site_seed(3, "inference")
    slept = {"j": [], "t": []}
    jc = J.ServiceChaos(J.FaultPlan.parse(spec).service_faults(), seed, sleep=slept["j"].append)
    tc = T.ServiceChaos(T.FaultPlan.parse(spec).service_faults(), seed, sleep=slept["t"].append)
    seq = {"j": [], "t": []}
    for i in range(100):
        for key, c in (("j", jc), ("t", tc)):
            if i % 3 == 0:
                c.maybe_stall()
            seq[key].append(c.refuse())
    assert seq["t"] == seq["j"] and slept["t"] == slept["j"]
    assert (tc.n_stalled, tc.n_refused) == (jc.n_stalled, jc.n_refused)


def test_factories_gate_as_tpu_rl():
    from tests.conftest import small_config

    for spec in (None, "corrupt:rollout@p=0.5", "kill:worker@t+1s", "refuse:inference@p=0.5",
                 "nan:logp@p=0.5@wid=1", "delay:learner@5ms"):
        jcfg, tcfg = small_config(chaos_spec=spec), Config(chaos_spec=spec)
        for site in ("worker", "manager", "learner", "storage"):
            assert (T.maybe_transport_chaos(tcfg, site) is None) == \
                (J.maybe_transport_chaos(jcfg, site) is None), (spec, site)
        for inst in (0, 1):
            assert (T.maybe_data_chaos(tcfg, instance=inst) is None) == \
                (J.maybe_data_chaos(jcfg, instance=inst) is None), (spec, inst)
        assert (T.maybe_service_chaos(tcfg) is None) == (J.maybe_service_chaos(jcfg) is None)


def test_supervisor_builds_process_chaos_from_config():
    from tpu_rl_torch.runtime.runner import Supervisor

    sup = Supervisor.from_config(Config(chaos_spec="kill:worker@t+1s,corrupt:rollout@p=0.1"))
    assert sup.chaos is not None and len(sup.chaos.faults) == 1
    assert Supervisor.from_config(Config()).chaos is None
    assert Supervisor.from_config(Config(chaos_spec="corrupt:rollout@p=0.1")).chaos.faults == []


def test_supervisor_poll_audits_chaos(tmp_path, capsys):
    """The supervisor's chaos poll prints the [chaos] line and appends the
    chaos.jsonl record tpu_rl's does."""
    from tpu_rl_torch.runtime.runner import Supervisor

    clock = [0.0]
    sent = []
    chaos = T.ProcessChaos.from_spec("kill:worker-0-1@t+1s", clock=lambda: clock[0],
                                     kill=lambda pid, sig: sent.append((pid, sig)))
    sup = Supervisor(chaos=chaos, audit_dir=str(tmp_path))
    sup.children.append(_Child("worker-0-1", 77))
    assert sup.poll_chaos() == []
    clock[0] = 2.0
    assert sup.poll_chaos() == [("kill", "worker-0-1")]
    assert sent == [(77, 9)]
    assert "[chaos] kill -> worker-0-1" in capsys.readouterr().out
    rec = [json.loads(line) for line in open(tmp_path / "chaos.jsonl")]
    assert [(r["ev"], r["action"], r["target"]) for r in rec] == [("chaos", "kill", "worker-0-1")]


@pytest.mark.timeout(60)
def test_refused_replies_time_out_the_client():
    """A port InferenceService under refuse:inference@p=1 swallows every
    reply: the client times out through its retries and returns None, the
    worker's cue to fall back; n_replies counts replies sent (none)."""
    from tests.test_torch_transport import free_block
    from tpu_rl_torch.models.families import build_family
    from tpu_rl_torch.runtime.inference_service import InferenceClient, InferenceService
    from tpu_rl_torch.runtime.transport import Router

    cfg = Config(hidden_size=16, act_mode="remote", inference_batch=4, inference_flush_us=1000,
                 inference_timeout_ms=300, inference_retries=1, chaos_spec="refuse:inference@p=1.0",
                 chaos_seed=3)
    family = build_family(cfg, device="cpu")
    params = family.init_params(torch.Generator().manual_seed(0))
    port = free_block(1)
    router = Router("*", port, bind=True)
    svc = InferenceService(cfg, family, params, router, device="cpu").start()
    cl = InferenceClient(cfg, "127.0.0.1", port, wid=0)
    try:
        assert svc.wait_ready(30.0)
        t0 = time.monotonic()
        got = cl.act(np.zeros((2, 4), np.float32), np.ones((2,), np.float32))
        assert got is None and time.monotonic() - t0 >= 0.55  # 2 attempts x 300 ms
        deadline = time.monotonic() + 5.0
        while svc.chaos.n_refused < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc.chaos.n_refused >= 2 and svc.n_replies == 0
    finally:
        cl.close()
        svc.close()
        router.close()


def _tele_total(tele: dict, role: str, name: str) -> float:
    return sum(v for s in tele["sources"] if s.get("role") == role
               for n, _l, v in s.get("counters", ()) if n == name)


def _cluster(tmp_path, spec: str, updates: int, **kw):
    """A CPU local cluster (2 remote-acting workers, the learner's service
    through B3's plain version) under ``spec``; returns (learner exit code,
    restarts, telemetry.json, run dir)."""
    from tests.test_torch_runtime import _machines
    from tests.test_torch_transport import free_block
    from tpu_rl_torch.runtime.runner import local_cluster

    run = tmp_path / "run"
    cfg = Config.from_dict(dict(
        env="CartPole-v1", algo="PPO", batch_size=8, seq_len=5, hidden_size=16, buffer_size=32,
        obs_shape=(4,), action_space=2, worker_step_sleep=0.0, learner_device="cpu",
        rollout_lag_sec=30.0, time_horizon=100, loss_log_interval=2, result_dir=str(run),
        telemetry_interval_s=0.5, telemetry_stale_s=120.0, supervise_poll_s=0.5,
        act_mode="remote", act_kernel="pallas", chaos_spec=spec, chaos_seed=7, **kw))
    sup = local_cluster(cfg, _machines(free_block(6)), max_updates=updates)
    loop = threading.Thread(target=sup.loop, daemon=True)
    loop.start()
    try:
        assert sup.stop_event.wait(180), "the cluster did not finish"
        loop.join(10)
        learner = next(c for c in sup.children if c.name == "learner")
        learner.proc.join(30)
        code, restarts = learner.proc.exitcode, sum(c.restarts for c in sup.children)
    finally:
        sup.stop()
    with open(run / "telemetry.json") as f:
        return code, restarts, json.load(f), run


@pytest.mark.timeout(200)
def test_chaos_cluster_accounts_every_fault(tmp_path):
    """The chip smoke's (X1) plan on the CPU: the learner exits 0 at its
    budget, the killed worker is respawned and audited, every corruption is
    one rejected frame, the relay delayed sends, the service stalled, and
    no worker fell back to local acting."""
    spec = "kill:worker-0-1@t+6s,corrupt:rollout@p=0.02,delay:manager@10ms@p=0.2,stall:inference@5ms"
    code, restarts, tele, run = _cluster(tmp_path, spec, 6, inference_timeout_ms=60_000)
    assert code == 0 and restarts >= 1
    assert _tele_total(tele, "supervisor", "chaos-process-kills") >= 1
    corrupted = _tele_total(tele, "storage", "chaos-corrupted-frames")
    rejected = sum(_tele_total(tele, r, f"{r}-rejected-frames")
                   for r in ("worker", "manager", "storage"))
    assert corrupted >= 1 and corrupted == rejected
    assert _tele_total(tele, "manager", "chaos-delayed-frames") >= 1
    assert _tele_total(tele, "learner", "inference-chaos-stalls") >= 1
    assert _tele_total(tele, "worker", "worker-remote-fallbacks") == 0
    with open(run / "chaos.jsonl") as f:
        rec = [json.loads(line) for line in f]
    assert [(r["ev"], r["action"], r["target"]) for r in rec] == [("chaos", "kill", "worker-0-1")]


@pytest.mark.timeout(200)
def test_refusing_service_makes_workers_fall_back(tmp_path):
    """refuse:inference@p=1 in a cluster: every remote act times out, the
    workers fall back to local acting (re-probing the refusing service) and
    the learner still finishes."""
    code, _restarts, tele, _run = _cluster(
        tmp_path, "refuse:inference@p=1.0", 6, inference_timeout_ms=300, inference_retries=0,
        inference_reprobe_s=0.5, inference_reprobe_max_s=0.5)
    assert code == 0
    assert _tele_total(tele, "worker", "worker-remote-fallbacks") >= 1
    assert _tele_total(tele, "learner", "inference-chaos-refusals") >= 1
