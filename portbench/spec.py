"""What ``BENCHMARK.json`` names, found by name: a cell's configuration
(``configs/<name>.json``), its traffic mix (``traffic/<name>.json``) and
the reader of each metric (``metrics/<name>.py``, or, for a metric split by
suffix, ``metrics/<name before the first dot>.py``). A later cell or metric
comes as new files and entries; no file here changes for it."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout: BENCHMARK.json and the program


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; known: {sorted(e['name'] for e in entries)}")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = find(bench["configs"], name, "configuration")
    return json.loads((root / entry["file"]).read_text())


def load_traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / HERE.name / "traffic" / f"{name}.json").read_text())


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    whose ``workloads`` list it, and those with no such list."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(run) -> float | None`` of the metric ``name``."""
    base = root / HERE.name / "metrics"
    for stem in (name, name.split(".")[0]):
        path = base / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location("portbench_metric_" + stem.replace(".", "_"), path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {base}")
