"""On the card, at each configuration's own size: the port's first updates
pass the check's limits and the control (the reference in TF32) fails
them. Run on a machine with a card:

    python3 -m pytest portbench/tests/test_portbench_card.py -m card
"""

import json
import subprocess
import sys

import pytest
import torch

from portbench import check, spec
from portbench.tests.conftest import REPO

CELLS = ["tf-longctx-f32.long-episodes", "lstm-wide-impala.cartpole-episodes"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails_at_full_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the check is calibrated at the cells' sizes on the card")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.calibrate", "--workload", cell, "--seeds", "21",
         "--program", "--control"], cwd=REPO, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    bench = spec.load_benchmark()
    limits = spec.load_config(
        bench, spec.find(bench["workloads"], cell, "workload")["config"])["check"]["limits"]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert check.passed(check.judge(got["program"], limits)), got
    assert not check.passed(check.judge(got["control"], limits)), got
