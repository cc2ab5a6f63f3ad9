"""The spans pass (``portbench.phases``): device operations and idle gaps
charged to the innermost span on synthetic events, the launch found by
correlation id, and a traced run on the CPU, where the program's spans
exist but no device does."""

import json
from types import SimpleNamespace

import pytest

from portbench import phases
from portbench.phases import OUTSIDE, STEP, charge, from_events, kineto_rows
from portbench.tests.test_portbench_run import CELLS, run_here

# one update: the root 0-10 s, forward 1-4, backward 4-7 (with a nested span
# of the program's own 5-6), optimizer 7-9, the root's own time 9-10
SPANS = [(0.0, 10.0, "train_step"), (1.0, 4.0, "train_step.forward"),
         (4.0, 7.0, "train_step.backward"), (5.0, 6.0, "train_step.backward.x"),
         (7.0, 9.0, "train_step.optimizer")]


def test_an_operation_goes_to_the_innermost_span_of_its_launch():
    ops = [  # (start, end, launch, name): the device runs behind the host
        (2.0, 3.0, 1.5, "sgemm_nn"),  # forward
        (5.5, 6.5, 5.5, "flash_f32_bwd_dq"),  # launched in the nested span
        (7.0, 7.5, 6.9, "elementwise"),  # launched in backward, after the nested span closed
        (8.0, 9.5, 9.5, "reduce"),  # the root's own time
        (10.5, 11.0, 10.2, "lstm_fwd_streamed"),  # after the step
    ]
    split = charge(ops, SPANS, updates=1)
    assert split.device_s["forward"] == 1.0
    assert split.device_s["backward.x"] == 1.0
    assert split.device_s["backward"] == 0.5
    assert split.device_s[STEP] == 1.5
    assert split.device_s[OUTSIDE] == 0.5
    assert split.device_s["optimizer"] == split.device_s["diag"] == 0.0
    assert sum(split.device_s.values()) == pytest.approx(sum(b - a for a, b, *_ in ops))
    assert split.by_kind_s == {"forward": {"products": 1.0}, "backward.x": {"b4": 1.0},
                               "backward": {"other": 0.5}, STEP: {"other": 1.5},
                               OUTSIDE: {"b12": 0.5}}


def test_a_gap_goes_to_the_span_open_when_it_began():
    ops = [(a, b, t, "op") for a, b, t in (
        (0.5, 1.5, 0.1), (3.5, 4.5, 3.0), (4.5, 6.0, 4.2), (7.5, 9.0, 7.1), (10.5, 11.0, 10.2))]
    split = charge(ops, SPANS, updates=2)
    # gaps: 1.5-3.5 (forward), 6.0-7.5 (the nested span closed at 6: backward),
    # 9.0-10.5 (the root's own time)
    assert split.idle_s["forward"] == 2.0
    assert split.idle_s["backward"] == 1.5
    assert split.idle_s[STEP] == 1.5
    assert split.idle_s[OUTSIDE] == 0.0
    assert split.gaps_s == pytest.approx(sum(split.idle_s.values()))
    assert split.busy_s == pytest.approx(sum(b - a for a, b, *_ in ops))
    # between two steps a gap is outside the step
    later = charge([(0.5, 10.5, 0.2, "op"), (12.0, 13.0, 11.0, "op")], SPANS, updates=1)
    assert later.idle_s[OUTSIDE] == 1.5 and later.idle_s[STEP] == 0.0


def test_the_launch_is_found_by_correlation_id():
    rows = [  # name, on the device, correlation id, linked id, start, end (s)
        ("train_step", False, 1, 0, 0.0, 100.0),
        ("aten::mm", False, 7, 0, 10.0, 20.0),
        ("cudaLaunchKernel", False, 501, 7, 12.0, 14.0),
        ("gemm", True, 501, 7, 30.0, 40.0),  # its runtime call: at 12
        ("elementwise", True, 999, 7, 50.0, 60.0),  # no runtime call: its op's 10
        ("memset", True, 998, 0, 70.0, 80.0),  # neither: its own 70
    ]
    ops, spans, found = from_events(rows)
    assert spans == [(0.0, 100.0, "train_step")]
    assert ops == [(30.0, 40.0, 12.0, "gemm"), (50.0, 60.0, 10.0, "elementwise"),
                   (70.0, 80.0, 70.0, "memset")]
    assert found == {"runtime": 1, "host": 1, "none": 1}


def test_the_rows_come_from_the_profilers_raw_results():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_rl_torch.obs import trace

    before = trace.set_spans(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("train_step"), trace.span("train_step.forward"):
                torch.ones(3) + 1
    finally:
        trace.set_spans(*before)
        trace.reset_counters()
    rows = kineto_rows(prof)
    names = {r[0] for r in rows}
    assert {"train_step", "train_step.forward", "aten::add"} <= names
    assert not any(r[1] for r in rows)  # no device
    _ops, spans, _found = from_events(rows)
    (a, b, root), (c, d, fwd) = sorted(spans)
    assert (root, fwd) == ("train_step", "train_step.forward") and a <= c < d <= b


def test_without_the_programs_spans_there_is_no_pass(monkeypatch):
    from tpu_rl_torch.obs import trace

    monkeypatch.delattr(trace, "set_spans")
    run = SimpleNamespace(trace=object())
    assert phases.read(run) is None and run.spans is None
    assert phases.device_ms(run, "forward") is None and phases.idle_ms(run, "diag") is None


@pytest.mark.parametrize("cell,metric", [(CELLS[0], "host_enqueue_ms.tf"),
                                         (CELLS[1], "host_enqueue_ms.lstm")])
def test_a_traced_cpu_run_keeps_its_metrics_and_runs_the_spans_pass(tiny, cell, metric, capsys):
    r = run_here(tiny, cell, trace=1)
    assert r["correct"]
    # the CPU has no device trace: of the per-layer metrics, host enqueue
    # alone, as before; the new device and idle readers give None
    assert set(r["metrics"]) == {metric}
    line = [x for x in capsys.readouterr().err.splitlines() if x.startswith("portbench: spans ")]
    assert len(line) == 1
    got = json.loads(line[0][len("portbench: spans "):])
    assert got["updates"] >= 5 and got["ops"] == 0 and got["visited"] is None
