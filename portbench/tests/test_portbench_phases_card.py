"""On the card, at each cell's own size: a traced run prints the spans
pass's metrics, and the pass's accounting closes. Run on a machine with a
card:

    python3 -m pytest portbench/tests/test_portbench_phases_card.py -m card
"""

import json
import subprocess
import sys

import pytest
import torch

from portbench.tests.conftest import REPO


PHASE_CELLS = ["tf-longctx-f32.long-episodes", "lstm-wide-impala.cartpole-episodes",
               "tf-longctx-f32.short-episodes"]


@pytest.mark.card
@pytest.mark.parametrize("cell", PHASE_CELLS)
def test_the_spans_pass_reports_every_phase_and_its_sums_close(cell):
    """A traced run prints the eight per-phase metrics of its suffix (and
    ``b4_tile_yield`` on the transformer); the four phases' device time and
    the device time outside the step sum to the pass's busy time within 1%,
    and the idle charged to each span sums to the pass's idle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spans pass charges the card's operations")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", "2147483977",
         "--seconds", "3", "--trace", "1"], cwd=REPO, capture_output=True, text=True,
        timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    suffix = "lstm" if cell.startswith("lstm") else "tf"
    want = {f"{ph}_{kind}_ms.{suffix}" for ph in ("forward", "backward", "optimizer", "diag")
            for kind in ("device", "idle")}
    if suffix == "tf":
        want.add("b4_tile_yield")
    assert want <= set(got["metrics"]), sorted(got["metrics"])
    line = [x for x in p.stderr.splitlines() if x.startswith("portbench: spans ")][-1]
    split = json.loads(line[len("portbench: spans "):])
    dev, idle = split["device_ms"], split["idle_ms"]
    phases = sum(dev[ph] for ph in ("forward", "backward", "optimizer", "diag"))
    assert abs(phases + dev["outside"] - split["busy_ms"]) <= 0.01 * split["busy_ms"], split
    assert abs(sum(idle.values()) - split["gaps_ms"]) <= 0.01 * split["gaps_ms"] + 1e-9, split
    assert 0 < got["metrics"].get("b4_tile_yield", {"value": 50})["value"] <= 100
