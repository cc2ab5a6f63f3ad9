"""The port's copies of ``tpu_rl.obs``'s stdlib-only modules (registry,
aggregator, exporters, goodput, audit, SLO engine, history store, anomaly
detector) give exactly what ``tpu_rl``'s give on the same inputs: each
scenario below runs once against each package and the two results must be
equal (no tolerance: the arithmetic is the same Python)."""

from __future__ import annotations

import json
import os

import pytest

import tpu_rl.obs as J
import tpu_rl_torch.obs as T
from tpu_rl.obs import audit as J_audit
from tpu_rl.obs import goodput as J_goodput
from tpu_rl.obs import history as J_history
from tpu_rl.obs import slo as J_slo
from tpu_rl_torch.obs import audit as T_audit
from tpu_rl_torch.obs import goodput as T_goodput
from tpu_rl_torch.obs import history as T_history
from tpu_rl_torch.obs import slo as T_slo

PACKAGES = {
    "tpu_rl": dict(obs=J, audit=J_audit, goodput=J_goodput, history=J_history, slo=J_slo),
    "tpu_rl_torch": dict(obs=T, audit=T_audit, goodput=T_goodput, history=T_history, slo=T_slo),
}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _registry(obs, role="learner"):
    """A registry with counters, gauges, labeled series and histograms."""
    reg = obs.MetricsRegistry(role=role, pid=7, host="h")
    reg.counter("frames").inc(12)
    reg.counter("frames", labels={"wid": "3"}).set_total(5)
    reg.gauge("learner-mfu").set(0.0125)
    reg.gauge("queue-depth", labels={"kind": 'a"b'}).set(3.0)
    h = reg.histogram("inference-rtt")
    for v in (1e-4, 3e-4, 2e-3, 2e-3, 0.5, 7.0, 3e6):
        h.observe(v)
    reg.histogram("inference-bucket-rows").observe_n(64, 9)
    return reg


def _strip_ts(snap: dict) -> dict:
    return {k: v for k, v in snap.items() if k != "ts"}


# ------------------------------------------------------------- scenarios
def sc_prometheus_and_healthz(p, tmp):
    obs = p["obs"]
    agg = obs.TelemetryAggregator(registry=_registry(obs), stale_after_s=30.0)
    agg.ingest({**_registry(obs, "worker").snapshot(), "pid": 9, "ts": 100.0}, now=100.0)
    text = obs.render_prometheus(agg, now=101.0)
    return text, obs.render_healthz(agg, now=101.0), obs.render_healthz(agg, now=200.0)


def sc_hist_quantile(p, tmp):
    obs = p["obs"]
    n = len(obs.HIST_BUCKETS) + 1
    vectors = [[0] * n, [1] * n, [0] * 10 + [1] + [0] * (n - 11), [i % 5 for i in range(n)]]
    return [[obs.hist_quantile(c, q) for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0)] for c in vectors]


def sc_merge_and_diff(p, tmp):
    obs = p["obs"]
    a = _registry(obs)
    b = _registry(obs)
    b.counter("frames").inc(3)
    b.histogram("inference-rtt").observe(0.25)
    sa, sb = _strip_ts(a.snapshot()), _strip_ts(b.snapshot())
    return obs.merge_snapshots(sa, sb), obs.diff_snapshots(sb, sa)


def sc_periodic_snapshot(p, tmp):
    obs = p["obs"]
    sent = []
    clock = FakeClock(0.0)
    per = obs.PeriodicSnapshot(_registry(obs), lambda s: sent.append(_strip_ts(s)),
                               interval_s=5.0, clock=clock)
    out = []
    for t in (0.0, 1.0, 5.0, 9.9, 10.0):
        clock.t = t
        out.append((per.due(), per.maybe_emit()))
    return out, sent


def _slo_fixture(obs, t: int):
    reg = obs.MetricsRegistry(role="w", pid=0, host="h")
    h = reg.histogram("inference-rtt")
    for v in [1.0] * 99 + [2.0 + t]:
        h.observe(v / 1e3)
    reg.counter("transport-rejected-frames").set_total(2.0 * t)
    reg.gauge("learner-mfu").set(0.01 if t < 3 else 0.001)
    return [_strip_ts(reg.snapshot())]


def sc_slo_golden_and_burn(p, tmp):
    obs, slo = p["obs"], p["slo"]
    spec = ("p99:inference-rtt<5ms@window=30s,gauge:learner-mfu>0.002,"
            "rate:transport-rejected-frames<1/s")
    eng = slo.SloEngine(spec)
    verdicts = [eng.evaluate(_slo_fixture(obs, t), now=float(t)) for t in range(6)]
    rules = [vars(r) for r in slo.parse_slo_spec(spec)]
    return verdicts, eng.failed, eng.report(), rules


def sc_history_store(p, tmp):
    obs, hist = p["obs"], p["history"]
    clock = FakeClock(100.0)
    store = obs.TimeSeriesStore(str(tmp), chunk_s=10.0, retention_s=25.0, clock=clock,
                                anomaly=obs.AnomalyDetector())
    agg = obs.TelemetryAggregator(registry=_registry(obs))
    for i in range(6):
        clock.t = 100.0 + 10.0 * i
        agg.registry.gauge("learner-mfu").set(0.01 * i)
        store.record(agg)
        store.append({"r/x": float(i)}, kinds={"r/x": "gauge"})
    pts = store.points("r/x")
    mfu = store.points("learner/learner-mfu")
    q = store.http_query({"metric": "learner/learner-mfu", "step": "20"})
    listing = store.http_query({})
    store.close()
    reader = obs.HistoryReader(str(tmp))
    samples, kinds = obs.flatten_snapshots([(_strip_ts(_registry(obs).snapshot()), 0.0)])
    return (pts, mfu, q, listing, store.n_rotated, store.n_gc, sorted(os.listdir(tmp)),
            reader.series(), reader.points("r/x"), samples, kinds,
            obs.downsample([(0.0, 1.0), (1.0, 3.0), (2.5, 5.0), (3.0, 7.0)], 2.0, start=0.0),
            obs.channel_name("worker", "fr", {"pid": "7", "wid": "3", "b": "1"}),
            hist.history_path(type("C", (), dict(history_dir=None, result_dir=str(tmp)))()))


def sc_anomaly(p, tmp):
    obs = p["obs"]
    det = obs.AnomalyDetector()
    reg = obs.MetricsRegistry(role="storage", pid=0, host="h")
    kinds = {"r/x": "gauge", "r/c": "counter"}
    events = []
    for i in range(30):
        events.append(det.observe({"r/x": 100.0 + (i % 3) * 0.5, "r/c": float(i)}, kinds,
                                  registry=reg))
    for v in [102.5] * 8 + [1e4, 100.0]:
        events.append(det.observe({"r/x": v, "r/c": 0.0}, kinds, registry=reg))
    return events, _strip_ts(reg.snapshot())


def sc_goodput(p, tmp):
    gp = p["goodput"]
    clock = FakeClock(10.0)
    led = gp.GoodputLedger("colocated", clock=clock)
    for bucket, secs in ((gp.COMPUTE, 1.5), (gp.CKPT, 0.25), (gp.IDLE, 0.5), (gp.WIRE, 0.125)):
        led.add(bucket, secs)
    clock.t = 13.0
    snap = led.snapshot()
    reg = p["obs"].MetricsRegistry(role="colocated", pid=0, host="h")
    led.publish(reg)
    clock.t = 11.0  # overcommitted: more attributed than elapsed
    over = led.snapshot()
    rates = {0: 100.0, 1: 98.0, 2: 101.0, 3: 20.0, 4: 99.5}
    return (snap, over, _strip_ts(reg.snapshot()), gp.robust_z(rates),
            gp.robust_z({0: 1.0, 1: 1.0, 2: 9.0}, floor=1.0),
            gp.straggler_report(rates, {0: 0.0, 1: 1.0, 2: 0.0, 3: 12.0}, {4: 0.2}, k=3),
            gp.BUCKETS, gp.maybe_ledger("x", False))


def sc_audit_resume(p, tmp):
    audit = p["audit"]
    audit.append_resume(str(tmp), 17, 2)
    audit.append_jsonl(str(tmp), "x.jsonl", {"a": 1, "t": 7.0})
    recs = [json.loads(x) for x in (tmp / "learner_resume.jsonl").read_text().splitlines()]
    return [{k: v for k, v in r.items() if k != "t"} for r in recs], sorted(recs[0]), \
        (tmp / "x.jsonl").read_text(), audit.append_resume(None, 1, 1)


SCENARIOS = {
    "prometheus_and_healthz": sc_prometheus_and_healthz,
    "hist_quantile": sc_hist_quantile,
    "merge_and_diff": sc_merge_and_diff,
    "periodic_snapshot": sc_periodic_snapshot,
    "slo_golden_and_burn": sc_slo_golden_and_burn,
    "history_store": sc_history_store,
    "anomaly": sc_anomaly,
    "goodput": sc_goodput,
    "audit_resume": sc_audit_resume,
}


def _normalize(x, tmp_dirs):
    """Replace each package's own temp dir in the result by a marker, so
    paths compare equal."""
    text = json.dumps(x, sort_keys=True, default=repr)
    for d in sorted(tmp_dirs, key=lambda d: -len(str(d))):
        text = text.replace(str(d), "<tmp>")
    return json.loads(text)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_copied_module_matches_tpu_rl(name, tmp_path):
    results, dirs = {}, []
    for pkg, mods in PACKAGES.items():
        d = tmp_path / pkg
        d.mkdir()
        dirs.append(d)
        results[pkg] = SCENARIOS[name](mods, d)
    a, b = (_normalize(results[k], dirs) for k in PACKAGES)
    assert a == b


def test_scenarios_exercise_what_they_name(tmp_path):
    """The parity scenarios see real data (a failing SLO verdict, a spike,
    an overcommitted ledger, a rotated and collected store), so an equality
    of two empty results cannot pass them."""
    text, ok, stale = sc_prometheus_and_healthz(PACKAGES["tpu_rl_torch"], tmp_path)
    assert 'frames{host="h",pid="7",role="learner",wid="3"} 5' in text
    assert "inference_rtt_bucket" in text and ok[0] == 200 and stale[0] == 503
    verdicts, failed, _report, rules = sc_slo_golden_and_burn(PACKAGES["tpu_rl_torch"], tmp_path)
    assert verdicts[0]["ok"] is True and verdicts[-1]["ok"] is False and failed
    assert len(rules) == 3
    burns = [r["burn_rate"] for r in verdicts[-1]["rules"]]
    assert max(burns) > 0
    events, snap = sc_anomaly(PACKAGES["tpu_rl_torch"], tmp_path)
    assert ("r/x", "spike") in sum(events, []) and ("r/x", "level-shift") in sum(events, [])
    (snap, over, *_rest) = sc_goodput(PACKAGES["tpu_rl_torch"], tmp_path)
    assert over["overcommit_s"] > 0 and snap["buckets"]["compute"] == 1.5
    store = sc_history_store(PACKAGES["tpu_rl_torch"], tmp_path / "h")
    assert store[4] >= 4 and store[5] >= 1 and [v for _t, v in store[0]][-1] == 5.0


# ------------------------------------------------------------------- spans
# obs.trace.span, the port's one way to open a span inside the program
# (no counterpart in tpu_rl): off by default, one shared no-op while off.
@pytest.fixture
def spans():
    from tpu_rl_torch.obs import trace

    before = trace.set_spans(False)
    trace.reset_counters()
    yield trace
    trace.set_spans(*before)
    trace.reset_counters()


def _refuse(*args, **kwargs):
    raise AssertionError("record_function entered")


def test_spans_off_are_one_shared_noop(spans, monkeypatch):
    import torch

    assert spans.span("a", update=1) is spans.span("b") is spans.NO_SPAN
    assert not spans.spans_on()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        monkeypatch.setattr(torch.profiler, "record_function", _refuse)
        with spans.span("a", update=1) as s:
            torch.ones(2) + 1
        monkeypatch.undo()
    assert s is None
    assert not [e for e in prof.events() if e.name == "a"]
    assert spans.counters() == {"spans": {}, "counts": {}}


def test_spans_on_total_their_time_profile_and_fill_the_ring(spans, monkeypatch):
    import torch

    ring = T.TraceRecorder(capacity=16, pid=3, role="learner", host="h")
    assert spans.set_spans(True, ring) == (False, None)
    # no profiler recording: no record_function (a dispatcher call) is entered
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    with spans.span("outer", update=3):
        with spans.span("outer.inner"):
            pass
    monkeypatch.undo()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("outer", update=4):
            torch.ones(2) + 1
    totals = spans.counters()["spans"]
    assert totals["outer"]["count"] == 2 and totals["outer.inner"]["count"] == 1
    assert totals["outer"]["seconds"] >= totals["outer.inner"]["seconds"] > 0
    outer = [e for e in prof.events() if e.name == "outer"]
    add = [e for e in prof.events() if e.name == "aten::add"]
    assert len(outer) == 1 and len(add) == 1
    assert outer[0].time_range.start <= add[0].time_range.start
    assert add[0].time_range.end <= outer[0].time_range.end
    done = [e for e in ring.to_chrome()["traceEvents"] if e["ph"] == "X"]
    assert [(e["name"], e.get("args")) for e in done] == [
        ("outer.inner", None), ("outer", {"update": 3}), ("outer", {"update": 4})]
    assert spans.set_spans(False) == (True, ring)


def test_device_counters_add_on_their_device_and_read_once(spans):
    import torch

    one = torch.tensor(3)
    spans.add_count("n", one)
    spans.add_count("n", one)
    spans.add_count("m", torch.tensor(5))
    assert int(one) == 3  # the counter is a copy
    assert spans.counters()["counts"] == {"n": 6, "m": 5}
    spans.reset_counters()
    assert spans.counters() == {"spans": {}, "counts": {}}
