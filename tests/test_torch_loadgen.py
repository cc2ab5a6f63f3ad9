"""The port's load generator (``tpu_rl_torch.loadgen``) on the CPU:
``normalize_schedule`` against ``tpu_rl``'s on the same inputs; one
``LoadDriver.run_stage`` against a port replica, with ``tpu_rl``'s own
driver beside it on the same replica (the stat keys must match); and a
two-driver, two-stage ``run_loadgen`` writing ``loadgen.json`` in
``tpu_rl``'s schema with its SLO verdicts."""

import json
import time

import pytest
import torch

from tests.test_torch_transport import free_block
from tpu_rl.config import Config as JaxConfig
from tpu_rl.loadgen import LoadDriver as JaxLoadDriver
from tpu_rl.loadgen.driver import normalize_schedule as jax_normalize_schedule
from tpu_rl_torch.config import Config
from tpu_rl_torch.fleet import InferenceReplica
from tpu_rl_torch.loadgen import LoadDriver, normalize_schedule, probe_ready, run_loadgen
from tpu_rl_torch.models.families import build_family
from tpu_rl_torch.runtime.transport import Router

_CFG = dict(
    algo="IMPALA", obs_shape=(4,), action_space=2, hidden_size=16, worker_num_envs=1,
    act_mode="remote", act_kernel="pallas", inference_replicas=2, inference_batch=16,
    inference_timeout_ms=1500, inference_hedge_ms=150, inference_retries=1,
    inference_buckets=8,
)

# tpu_rl.loadgen.driver's document: run_loadgen's keys, each stage's, and
# the SLO verdict's (tpu_rl/loadgen/driver.py:503-594, obs/slo.py)
DOC_KEYS = {"n_clients", "n_procs", "rows", "duration_s", "endpoints", "slo_spec", "schedule",
            "stages", "overall"}
STAGE_KEYS = {"offered_rps", "achieved_rps", "duration_s", "sent", "ok", "failed",
              "success_rate", "hedges", "failovers", "dedups", "floor_rejects", "reprobes",
              "version_floor", "p50_ms", "p99_ms", "p999_ms", "slo"}


@pytest.fixture
def replica():
    cfg = Config.from_dict(_CFG)
    port = free_block(1)
    router = Router("*", port, bind=True)
    family = build_family(cfg, device="cpu")
    params = family.init_params(torch.Generator().manual_seed(0))
    svc = InferenceReplica(cfg, family, params, router, version=2, device="cpu").start()
    assert svc.wait_ready(60.0) and svc.error is None, svc.error
    yield cfg, port, svc
    svc.close()
    router.close()


@pytest.mark.parametrize("schedule", [
    [(100, 2), (5000, 1.5), [100.0, 2]],
    [("250", "6")],
    [(0, 1)],
    [],
    [(100,)],
    [(-1, 2)],
    [(10, 0)],
    ["ab"],
])
def test_normalize_schedule_matches_tpu_rl(schedule):
    try:
        want = jax_normalize_schedule(schedule)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            normalize_schedule(schedule)
        assert str(got.value) == str(e)
    else:
        assert normalize_schedule(schedule) == want


def test_run_stage_returns_tpu_rl_stat_keys(replica):
    """One stage of the port's driver and one of tpu_rl's (pyzmq) against the
    same port replica: every request answered at the replica's version, and
    the same stat keys and snapshot series."""
    cfg, port, svc = replica
    endpoints = [("127.0.0.1", port)]
    assert probe_ready(endpoints, cfg, timeout_s=30.0)
    rows = {}
    for name, driver in (
        ("port", LoadDriver(cfg, endpoints, n_clients=500, obs_dim=4, seed=1)),
        ("jax", JaxLoadDriver(JaxConfig.from_dict(_CFG), endpoints, n_clients=500, obs_dim=4,
                              seed=2)),
    ):
        try:
            rows[name] = driver.run_stage(rate_rps=200.0, duration_s=1.0)
        finally:
            driver.close()
    for row in rows.values():
        assert row["sent"] >= 150 and row["ok"] == row["sent"] and row["failed"] == 0
        assert row["version_floor"] == 2
    assert set(rows["port"]) == set(rows["jax"])

    def series(snap):
        return {(kind, entry[0]) for kind in ("counters", "gauges", "hists")
                for entry in snap.get(kind, ())}

    assert series(rows["port"]["snapshot"]) == series(rows["jax"]["snapshot"])
    assert svc.n_flush_deadline == 0 and svc.n_replies >= rows["port"]["ok"] + rows["jax"]["ok"]


@pytest.mark.timeout(120)
def test_run_loadgen_writes_tpu_rl_schema(replica, tmp_path):
    """Two spawned driver processes, two stages: loadgen.json holds
    tpu_rl's keys, every request answered, each stage graded by its own SLO
    engine (the first GREEN)."""
    cfg, port, _svc = replica
    out = tmp_path / "loadgen.json"
    spec = "p99:inference-rtt<250ms@window=60s,counter:loadgen-failures==0"
    doc = run_loadgen(cfg, [("127.0.0.1", port)], n_clients=1000, rates=[100, 200],
                      duration_s=1.0, out_path=str(out), n_procs=2, slo_spec=spec)
    assert json.loads(out.read_text()) == json.loads(json.dumps(doc))
    assert set(doc) == DOC_KEYS and doc["n_procs"] == 2 and doc["schedule"] is None
    assert [s["offered_rps"] for s in doc["stages"]] == [100, 200]
    for stage in doc["stages"]:
        assert set(stage) == STAGE_KEYS
        assert stage["failed"] == 0 and stage["success_rate"] == 1.0
        assert {r["rule"] for r in stage["slo"]["rules"]} == set(spec.split(","))
    assert doc["stages"][0]["slo"]["ok"] is True
    assert doc["overall"]["ok"] == doc["overall"]["sent"] > 0


def test_lane_backoff_survives_a_hedge_storm():
    """A lane benched thousands of times (a sweep far past saturation) keeps
    its backoff at the cap; tpu_rl's float power overflows there."""
    from tpu_rl.loadgen.driver import _Lane as JaxLane
    from tpu_rl_torch.loadgen.driver import _LANE_DEAD_MAX_S, _Lane

    class _NoDealer:
        def close(self):
            pass

    jax_lane, lane = JaxLane(_NoDealer()), _Lane(_NoDealer())
    with pytest.raises(OverflowError):
        for _ in range(2000):
            jax_lane.condemn()
    for _ in range(2000):
        lane.condemn()
    assert 0 < lane.dead_until - time.monotonic() <= _LANE_DEAD_MAX_S
