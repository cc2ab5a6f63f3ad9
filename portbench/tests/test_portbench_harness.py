"""The harness is driven by data: BENCHMARK.json keeps the contract's
shape, and a configuration, a mix and a metric that come as new files are
found by name."""

import json
import re
import shutil
import time

import torch

from portbench import spec
from portbench.run import parse_args, run
from portbench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_the_benchmark_keeps_the_contracts_shape():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    cells = {w["name"]: w for w in bench["workloads"]}
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    for w in cells.values():
        assert w["config"] in configs and len(w["why"]) <= 200
        assert (REPO / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for cell in cells:
        reported = {m["name"] for m in spec.cell_metrics(bench, cell, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.cell_metrics(bench, cell, "per_layer")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and len(m["layer"]) <= 200
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert spec.metric_reader(m["name"]) is not None


def test_a_new_configuration_mix_and_metric_are_found_by_name(tiny, tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(tiny, root, symlinks=True)
    pb = root / "portbench"
    conf = json.loads((pb / "configs" / "lstm-wide-impala.json").read_text())
    conf["config"]["hidden_size"] = 16
    (pb / "configs" / "lstm-narrow.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "cartpole-episodes.json").read_text())
    (pb / "traffic" / "long-resets.json").write_text(
        json.dumps(dict(mix, episode_lengths=[[3, 1], [9, 2]])))
    (pb / "metrics" / "rows_seen.py").write_text(
        "def read(run):\n    return float(run.config['batch_size'] * len(run.window.update_s))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="lstm-narrow", source="test", file="portbench/configs/"
                                 "lstm-narrow.json", reduced=[], why="test"))
    cell = dict(name="lstm-narrow.long-resets", config="lstm-narrow", traffic="long-resets",
                chips=1, why="test")
    bench["workloads"].append(cell)
    bench["end_to_end"].append(dict(name="rows_seen.narrow", unit="rows", better="higher",
                                    bound=0.01, source="host_clock", workloads=[cell["name"]]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    args = parse_args(["--workload", cell["name"], "--seed", "3", "--seconds", "0.3",
                       "--trace", "0", "--device", "cpu"])
    r = run(args, spec.load_benchmark(root), cell, torch.device("cpu"), time.time(), root)
    assert r["correct"]
    assert set(r["metrics"]) == {"rows_seen.narrow", "setup_s"}
    assert r["metrics"]["rows_seen.narrow"]["value"] == 16.0 * r["attempted"]
