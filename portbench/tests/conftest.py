"""Fixtures of the benchmark's CPU tests: a tiny checkout (the harness's
files, the program, and the cells at small sizes) to run cells in."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
PORTBENCH = HERE.parent
REPO = PORTBENCH.parent

# The cells' configurations and mixes at sizes the CPU runs in seconds; every
# other key as the benchmark states it.
TINY = {
    "tf-longctx-f32": dict(batch_size=4, seq_len=128, hidden_size=64, n_heads=2, n_layers=2,
                           obs_shape=[8]),
    "lstm-wide-impala": dict(batch_size=16, seq_len=8, hidden_size=32, obs_shape=[8]),
}
# The long mix's episodes outlast a tiny row; these give its rows seams.
TINY_MIX = {"long-episodes": dict(episode_lengths=[[60, 1], [300, 1], [600, 1]]),
            "short-episodes": {}, "cartpole-episodes": {}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips, with its reason, where there is none")


def make_tiny(root: Path) -> Path:
    shutil.copytree(PORTBENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "tpu_rl_torch").symlink_to(REPO / "tpu_rl_torch")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, sizes in TINY.items():
        path = root / "portbench" / "configs" / f"{name}.json"
        conf = json.loads(path.read_text())
        conf["config"].update(sizes)
        conf["check"]["block_rows"] = 2
        path.write_text(json.dumps(conf))
    for name, over in TINY_MIX.items():
        path = root / "portbench" / "traffic" / f"{name}.json"
        mix = json.loads(path.read_text())
        mix.update(over, pool_mib=0)
        path.write_text(json.dumps(mix))
    return root


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("checkout"))
