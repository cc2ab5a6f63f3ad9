"""The port's autopilot and ``obs.top`` against ``tpu_rl``'s, in the same
process: the spec grammar (``tests/test_autopilot.py``'s specs and bad
clauses), the decision engine on the same signal sequences and clocks
(the same decisions and counters), the signal scraper on canned ``/slo``,
``/goodput`` and ``/metrics`` documents (the same signals, meta and
windows), history rehydration, the dashboard frame from the same
documents, and a port ``AutopilotController`` on the CPU that scales one
replica process out and back in under a canned scraper."""

import dataclasses
import json
import threading
import time

import pytest

from tpu_rl.autopilot import policy as JPol
from tpu_rl.autopilot import signals as JSig
from tpu_rl.obs import top as JTop
from tpu_rl_torch.autopilot import policy as TPol
from tpu_rl_torch.autopilot import signals as TSig
from tpu_rl_torch.obs import top as TTop

OUT_RULE = "scale_out:replicas?burn:inference-rtt>0.5@sustain=3@cooldown=10s@max=3"
IN_RULE = "scale_in:replicas?burn:inference-rtt<0.05@sustain=3@cooldown=10s@min=1"
SMOKE_SPEC = (
    "scale_out:replicas?burn:inference-rtt>0.5@sustain=4@cooldown=6s@max=3,"
    "scale_in:replicas?burn:inference-rtt<0.02@sustain=50@cooldown=6s@min=1,limit=12/60s"
)

GOOD_SPECS = [
    f"{OUT_RULE}, {IN_RULE},respawn:worker?straggler:score>8@sustain=10@cooldown=60s,limit=4/30s",
    "  ",
    OUT_RULE,
    IN_RULE,
    f"{OUT_RULE},{IN_RULE}",
    SMOKE_SPEC,
    "scale_in:workers?gauge:idle>0.9@sustain=1",
    "scale_out:replicas?burn:a>0.5@sustain=1@cooldown=1s@max=99,"
    "scale_out:workers?burn:b>0.5@sustain=1@cooldown=1s@max=99,limit=2/100s",
    "scale_out:replicas?burn:x>0.5@sustain=2@cooldown=1s@max=5,"
    "scale_in:replicas?burn:y<0.1@sustain=3@cooldown=1s@min=1",
    "respawn:worker?straggler:score>8@sustain=1",
    "scale_out:workers?counter:fleet-hedge-fired>=10@step=2,scale_in:workers?goodput:worker<=0.2",
    "scale_out:replicas?gauge:queue==3",
]
BAD_CLAUSES = [
    "scale_sideways:replicas?burn:x>1", "scale_out:gpus?burn:x>1",
    "respawn:replicas?straggler:score>8", "scale_out:replicas burn:x>1",
    "scale_out:replicas?burn:x~1", "scale_out:replicas?vibes:x>1", "scale_out:replicas?burn:>1",
    "scale_out:replicas?burn:x>fast", "scale_out:replicas?burn:x>1@volume=11",
    "scale_out:replicas?burn:x>1@sustain=0", "scale_out:replicas?burn:x>1@sustain=two",
    "scale_out:replicas?burn:x>1@cooldown=5", "scale_out:replicas?burn:x>1@step=0",
    "scale_out:replicas?burn:x>1@min=3@max=1", "limit=0/60s", "limit=6/60", "limit=6",
]


def _spec_rows(spec) -> dict:
    return {"rules": [dataclasses.asdict(r) for r in spec.rules],
            "limit": (spec.limit_n, spec.limit_window_s)}


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_spec_parses_as_tpu_rl(spec):
    assert _spec_rows(TPol.AutopilotSpec.parse(spec)) == _spec_rows(JPol.AutopilotSpec.parse(spec))


@pytest.mark.parametrize("clause", BAD_CLAUSES)
def test_bad_clause_refused_as_tpu_rl(clause):
    with pytest.raises(ValueError) as want:
        JPol.AutopilotSpec.parse(f"{OUT_RULE},{clause}")
    with pytest.raises(ValueError) as got:
        TPol.AutopilotSpec.parse(f"{OUT_RULE},{clause}")
    assert str(got.value) == str(want.value) and clause in str(got.value)


def _square(n, hi, lo, key="burn:inference-rtt"):
    return [{key: hi if i % 2 == 0 else lo} for i in range(n)]


# (spec, signal sequence, initial counts, seconds a poll, metas): the
# traces of tests/test_autopilot.py's engine cases, and the smoke's.
SCENARIOS = {
    "slow-drift": (OUT_RULE, _square(50, 0.6, 0.3), {"replicas": 1}, 1.0, None),
    "sustained-burn": (OUT_RULE, [{"burn:inference-rtt": 0.9}] * 25, {"replicas": 1}, 1.0, None),
    "bounds": (OUT_RULE, [{"burn:inference-rtt": 0.9}] * 8, {"replicas": 3}, 1.0, None),
    "scale-in-floor": (IN_RULE, [{"burn:inference-rtt": 0.0}] * 10, {"replicas": 1}, 1.0, None),
    "workers-floor": ("scale_in:workers?gauge:idle>0.9@sustain=1", [{"gauge:idle": 1.0}] * 3,
                      {"workers": 0}, 1.0, None),
    "rate-limit": (GOOD_SPECS[7], [{"burn:a": 1.0, "burn:b": 1.0}] * 10,
                   {"replicas": 1, "workers": 1}, 2.0, None),
    "flapping": (f"{OUT_RULE},{IN_RULE}", _square(100, 0.9, 0.0), {"replicas": 2}, 1.0, None),
    "hysteresis": (GOOD_SPECS[8], [{"burn:x": 0.9, "burn:y": 0.0}] * 2 + [{"burn:y": 0.0}] * 4,
                   {"replicas": 2}, 1.0, None),
    "missing-signal": (OUT_RULE, [{"burn:inference-rtt": 0.9}] * 2 + [{}] +
                       [{"burn:inference-rtt": 0.9}] * 3, {"replicas": 1}, 1.0, None),
    "respawn-wid": ("respawn:worker?straggler:score>8@sustain=1", [{"straggler:score": 9.0}] * 4,
                    {"workers": 2}, 1.0, [None, {"straggler_wid": 7}, {}, {"straggler_wid": 3}]),
    "smoke-diurnal": (SMOKE_SPEC, [{"burn:inference-rtt": b} for b in
                                   [0.0] * 20 + [0.3, 0.6, 0.9, 1.0] * 10 + [0.01] * 70 +
                                   [0.7] * 8 + [0.0] * 60], {"replicas": 1}, 0.5, None),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_match_tpu_rl(name):
    """Both engines on one trace and clock: the same decisions at every
    poll (counts follow each decision's ``to``), the same counters and
    cooldowns."""
    spec, trace, counts0, dt, metas = SCENARIOS[name]
    runs = []
    for mod in (JPol, TPol):
        clock = [0.0]
        eng = mod.DecisionEngine(mod.AutopilotSpec.parse(spec), clock=lambda: clock[0])
        counts = dict(counts0)
        out = []
        for i, sig in enumerate(trace):
            clock[0] += dt
            meta = metas[i] if metas is not None and i < len(metas) else None
            got = eng.decide(dict(sig), dict(counts), now=clock[0], meta=meta)
            for d in got:
                if d["target"] in counts and d["action"] != "respawn":
                    counts[d["target"]] = d["to"]
            out.append(got)
        runs.append((out, eng.n_decisions, eng.n_clamped, eng.n_rate_limited,
                     eng.cooldowns(now=clock[0]), counts))
    assert runs[1] == runs[0]
    if name in ("sustained-burn", "smoke-diurnal", "hysteresis", "respawn-wid"):
        assert runs[1][1] > 0  # the trace fired at least once


def _canned(mod, slo=None, goodput=None, metrics=None, t0=100.0):
    def fetch_json_fn(url, timeout):
        if url.endswith("/slo"):
            return slo
        if url.endswith("/goodput"):
            return goodput
        return None

    def fetch_fn(url, timeout):
        return (None, "refused") if metrics is None else (200, metrics)

    clock = [t0]
    store = mod.SignalStore(clock=lambda: clock[0])
    return mod.SignalScraper("http://x", store=store, fetch_fn=fetch_fn,
                             fetch_json_fn=fetch_json_fn), clock


METRICS = "\n".join([
    "# TYPE worker_frame_rate gauge",
    'worker_frame_rate{wid="1"} 50.0',
    'worker_frame_rate{wid="2"} 80.0',
    "# TYPE fleet_hedge_fired counter",
    'fleet_hedge_fired{wid="1"} 3',
    'fleet_hedge_fired{wid="2"} 4',
    "# TYPE inference_rtt histogram",
    'inference_rtt_bucket{le="0.005"} 4',
    "inference_rtt_count 9",
    "# TYPE learner_mfu gauge",
    "learner_mfu 0.0123",
])
SLO = {"ok": False, "rules": [
    {"rule": "p99:inference-rtt<5ms", "metric": "inference-rtt", "burn_rate": 0.4, "ok": False,
     "value": 0.007, "burn_history": [[98.0, 0.1], [99.0, 0.25]]},
    {"rule": "p50:inference-rtt<1ms", "metric": "inference-rtt", "burn_rate": 0.7, "ok": True,
     "burn_history": []},
    {"rule": "gauge:learner-mfu>0.5", "metric": "learner-mfu", "burn_rate": 1.0, "ok": None},
]}
GOODPUT = {"roles": {"worker/11": {"goodput": 0.4}, "worker/12": {"goodput": 0.8},
                     "storage/1": {"goodput": 0.9}},
           "stragglers": [{"wid": 3, "score": 12.5, "signals": {"frame-rate": 40.0, "rtt": 2.5}},
                          {"wid": 4, "score": 2.0, "signals": {}}]}


@pytest.mark.parametrize("docs", [
    {"slo": SLO, "metrics": ""},
    {"goodput": GOODPUT},
    {"metrics": METRICS},
    {"slo": SLO, "goodput": GOODPUT, "metrics": METRICS},
    {},
], ids=["slo", "goodput", "metrics", "all", "unreachable"])
def test_scraper_signals_match_tpu_rl(docs):
    runs = []
    for mod in (JSig, TSig):
        scraper, clock = _canned(mod, **docs)
        polls = []
        for _ in range(3):
            polls.append(scraper.poll(now=clock[0]))
            clock[0] += 1.0
        store = scraper.store
        runs.append((polls, {k: store.series(k) for k in store.snapshot()}, scraper.n_errors,
                     scraper.n_polls, TSig.signal_channels(store)))
    assert runs[1] == runs[0]


class _Reader:
    """A history reader (``series()`` + ``points()``) over fixed channels."""

    def __init__(self, chans):
        self.chans = chans

    def series(self):
        return list(self.chans)

    def points(self, ch, start=None):
        return [(t, v) for t, v in self.chans[ch] if start is None or t >= start]


def test_rehydration_matches_tpu_rl():
    chans = {"signals/burn:inference-rtt": [(990.0, 0.5), (995.0, 0.7), (1001.0, 0.9)],
             "signals/goodput:worker": [(980.0, 0.3), (999.0, 0.6)],
             "storage/storage-windows": [(999.0, 12.0)]}
    out = []
    for mod in (JSig, TSig):
        store = mod.SignalStore(window_s=15.0, clock=lambda: 500.0)
        n = mod.rehydrate_signals(store, _Reader(chans), now_wall=1000.0, now_mono=500.0)
        out.append((n, {k: store.series(k) for k in store.snapshot()}))
    assert out[1] == out[0] and out[1][0] == 3


def _samples(mod):
    text = "\n".join([
        "# TYPE worker_goodput_ratio gauge",
        'worker_goodput_ratio{wid="0"} 0.62',
        'worker_goodput_ratio{wid="1"} 0.4',
        'worker_time_compute_ratio{wid="0"} 0.62',
        'worker_time_wire_ratio{wid="0"} 0.2',
        'worker_time_idle_ratio{wid="0"} 0.18',
        "learner_goodput_ratio 0.91",
        "learner_time_compute_ratio 0.91",
        "learner_time_queue_wait_ratio 0.09",
        "learner_throughput 51234.5",
        "learner_mfu 0.0123",
        "learner_xla_recompiles 0",
        "learner_diag_entropy 0.6931",
        "learner_diag_approx_kl 0.0012",
        "learner_diag_ess 0.97",
        "learner_diag_clip_frac 0.05",
        "learner_diag_grad_norm_torso 0.0123",
        "learner_diag_grad_norm_cell 0.5",
        'learner_diag_by_stale_ess{stale_bucket="0"} 0.99',
        'learner_diag_by_stale_rows{stale_bucket="0"} 120',
        'learner_diag_by_stale_ess{stale_bucket="2-3"} 0.81',
        'learner_diag_by_stale_ess{stale_bucket="16+"} 0.4',
        'learner_diag_approx_kl_hist_bucket{le="0.01"} 3',
    ])
    return mod.parse_prometheus(text)


AUTOPILOT_DOC = {
    "replicas": 2, "replica_capacity": 3, "workers": 1, "counts": {"actions": 4},
    "actions": [{"action": "scale_out", "target": "replicas", "from": 1, "to": 2,
                 "reason": "burn:inference-rtt > 0.5 sustained 3 polls"}] * 6,
    "cooldowns": {OUT_RULE: 6.5, IN_RULE: 0.0},
}
HISTORY = {"worker wid=0-goodput-ratio": [0.1, 0.5, 0.62], "learner-mfu": [0.0, 0.01, 0.0123],
           "learner-throughput": [1.0, 2.5, 3.0]}


@pytest.mark.parametrize("case", ["empty", "full", "narrow", "no-history"])
def test_top_frame_matches_tpu_rl(case):
    """``build_frame`` renders the same text from the same documents."""
    frames = []
    for mod in (JTop, TTop):
        if case == "empty":
            frame = mod.build_frame([], None, None)
        else:
            kw = dict(autopilot_doc=AUTOPILOT_DOC,
                      history=None if case == "no-history" else HISTORY,
                      width=60 if case == "narrow" else 160)
            frame = mod.build_frame(_samples(mod), GOODPUT, SLO, url="http://h:1/metrics", **kw)
        frames.append(frame)
    assert frames[1] == frames[0]
    assert any("AUTOPILOT" in line for line in frames[1]) == (case != "empty")


def test_top_helpers_match_tpu_rl():
    assert _samples(TTop) == _samples(JTop)
    for vals in ([], [1.0], [0.0, 1.0, 2.0, 3.0], [5.0, 1.0, 4.0, -2.0], list(range(50))):
        assert TTop.sparkline(vals) == JTop.sparkline(vals)
    for frac in (-1.0, 0.0, 0.33, 1.0, 2.0):
        assert TTop.bar(frac) == JTop.bar(frac)

    listing = {"series": [{"name": "worker/worker-goodput-ratio"}, {"name": "learner/learner-mfu"},
                          {"name": "x{a=1}"}, {"name": "storage/storage-windows"}]}

    def fetch(url, timeout):
        if url.endswith("/query"):
            return listing
        return {"points": [[1.0, 0.5], [2.0, 0.75]]}

    assert TTop.collect_history("http://h", fetch_json_fn=fetch) == \
        JTop.collect_history("http://h", fetch_json_fn=fetch)


@pytest.mark.timeout(120)
def test_controller_scales_a_replica_out_and_in(tmp_path):
    """A port AutopilotController on the CPU, its scraper canned: high burn
    until a second replica process exists, then a clean window until the
    controller retires it. Audit lines are schema-valid, the summary is
    ok, and no replica process is left."""
    from tests.test_torch_transport import free_block
    from tpu_rl_torch.autopilot import AutopilotController
    from tpu_rl_torch.config import Config, MachinesConfig
    from tpu_rl_torch.examples.autopilot_smoke import validate_action

    base = free_block(14)
    spec = ("scale_out:replicas?burn:inference-rtt>0.5@sustain=2@cooldown=1s@max=2,"
            "scale_in:replicas?burn:inference-rtt<0.05@sustain=3@cooldown=1s@min=1")
    cfg = Config.from_dict(dict(
        algo="IMPALA", obs_shape=(4,), action_space=2, hidden_size=16, act_mode="remote",
        act_kernel="pallas", learner_device="cpu", inference_replicas=1,
        inference_base_port=base, inference_batch=8, autopilot_spec=spec, autopilot_poll_s=0.2,
        autopilot_drain_s=0.1, result_dir=str(tmp_path), telemetry_interval_s=0.5))
    machines = MachinesConfig(learner_ip="127.0.0.1", learner_port=base + 10)
    ctrl = AutopilotController(cfg, machines=machines, manage_all=True,
                               scrape_url="http://127.0.0.1:9", http_port=0, log=False)

    class Scraper:
        base_url, n_errors, n_polls = "canned", 0, 0

        def poll(self):
            self.n_polls += 1
            n = ctrl.replicas.count
            if ctrl.counts["scale_in"]:
                ctrl.sup.stop_event.set()
            burn = 0.9 if n < 2 and not ctrl.counts["scale_out"] else 0.0
            return {"burn:inference-rtt": burn}, {}

    ctrl.scraper = Scraper()
    result = {}
    th = threading.Thread(target=lambda: result.update(doc=ctrl.run()), daemon=True)
    th.start()
    th.join(100)
    assert not th.is_alive(), "the controller never stopped"
    doc = result["doc"]
    assert doc["ok"] and doc["replicas"] == 1
    assert doc["counts"]["scale_out"] == 1 and doc["counts"]["scale_in"] == 1
    with open(tmp_path / "autopilot.jsonl") as f:
        events = [json.loads(line) for line in f]
    actions = [e for e in events if e["ev"] == "action"]
    assert [(a["action"], a["from"], a["to"]) for a in actions] == [("scale_out", 1, 2),
                                                                     ("scale_in", 2, 1)]
    assert all(validate_action(a) is None for a in actions)
    kinds = [(e["ev"], e.get("index")) for e in events if e["ev"] in ("spawn", "retire")]
    assert kinds == [("spawn", 0), ("spawn", 1), ("retire", 1)]
    assert json.load(open(tmp_path / "autopilot.json"))["ok"] is True
    deadline = time.monotonic() + 10
    while any(c.proc.is_alive() for c in ctrl.sup.children) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not any(c.proc.is_alive() for c in ctrl.sup.children)


def test_autopilot_role_builds_the_controller(tmp_path):
    """The CLI's autopilot role: the port's runner builds the controller
    (it raised NotImplementedError before the operations planes), the
    replica range planned to the spec's max."""
    from tpu_rl_torch.autopilot import AutopilotController
    from tpu_rl_torch.config import Config, MachinesConfig
    from tpu_rl_torch.runtime.runner import autopilot_role

    cfg = Config(autopilot_spec=OUT_RULE, result_dir=str(tmp_path), learner_device="cpu",
                 inference_replicas=1)
    ctrl = autopilot_role(cfg, MachinesConfig(learner_port=41000), manage_all=True)
    try:
        assert isinstance(ctrl, AutopilotController)
        assert (ctrl.replicas.capacity, ctrl.replicas.static, ctrl._initial) == (3, 0, 1)
        assert ctrl.replicas.ports == [41002, 41003, 41004]
        assert ctrl.sup.chaos is None
    finally:
        if ctrl._telem_pub is not None:
            ctrl._telem_pub.close()
