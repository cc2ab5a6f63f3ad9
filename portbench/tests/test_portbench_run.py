"""Whole runs of the cells at small sizes on the CPU: the result line, and
``correct`` false for every fault the check has to catch."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import spec
from portbench.run import parse_args, run

CELLS = ["tf-longctx-f32.long-episodes", "lstm-wide-impala.cartpole-episodes",
         "tf-longctx-f32.short-episodes"]


def run_here(root, cell, *extra, trace=0, seconds=0.5):
    """A run of ``cell`` in this process, past the look for a card."""
    args = parse_args(["--workload", cell, "--seed", "2147483911", "--seconds", str(seconds),
                       "--trace", str(trace), "--device", "cpu", *extra])
    bench = spec.load_benchmark(root)
    return run(args, bench, spec.find(bench["workloads"], cell, "workload"),
               torch.device("cpu"), time.time(), root)


def run_command(root, cell, *extra, seconds=0.5):
    """The command itself, in the tiny checkout, on the CPU."""
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", "5", "--seconds",
         str(seconds), "--trace", "0", "--device", "cpu", *extra],
        cwd=root, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    return p


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_contract_line(tiny, cell):
    r = run_here(tiny, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    bench = spec.load_benchmark(tiny)
    want = {m["name"] for m in spec.cell_metrics(bench, cell, "end_to_end")}
    assert set(r["metrics"]) == want
    assert r["metrics"]["setup_s"]["value"] > 0
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"loss_gap", "grad_gap", "change_gap", "nonfinite_updates"}


def test_a_traced_run_reports_per_layer_metrics_only(tiny):
    r = run_here(tiny, CELLS[1], trace=1)
    assert r["correct"]
    assert set(r["metrics"]) == {"host_enqueue_ms.lstm"}  # the CPU has no device trace
    assert r["device"]["window_s"] > 0 and "breakdown" in r


@pytest.mark.parametrize("cell", CELLS[:2])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(tiny, cell, fault):
    r = run_here(tiny, cell, "--fault", fault)
    assert not r["correct"], r["checks"]


def test_the_command_prints_the_checks_last(tiny):
    p = run_command(tiny, CELLS[1])
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["count"] == 1
    lines = p.stderr.strip().splitlines()
    assert lines[-1].startswith("check nonfinite_updates")


def test_a_cell_on_several_cards_is_refused(tiny, tmp_path):
    import shutil

    root = tmp_path / "checkout"
    shutil.copytree(tiny, root, symlinks=True)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(bench["workloads"][1], name="four-cards", chips=4))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    p = run_command(root, "four-cards")
    assert p.returncode == 2 and p.stdout == ""


def test_no_card_no_result(tiny):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[1], "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=tiny, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""


def test_without_the_program_no_result(tmp_path):
    import shutil

    from portbench.tests.conftest import PORTBENCH, REPO

    shutil.copytree(PORTBENCH, tmp_path / "portbench")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[1], "--seed",
                        "1", "--seconds", "1", "--trace", "0", "--device", "cpu"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
