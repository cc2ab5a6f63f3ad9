"""No module a run loads is JAX's or the JAX package's: the top-level name,
the part before the first dot, compared whole (``tpu_rl_torch`` is not
``tpu_rl``)."""

import subprocess
import sys

from portbench.run import BANNED, banned_modules

PROBE = """
import sys, time
import torch
from portbench import spec
from portbench.run import parse_args, run
bench = spec.load_benchmark()
for cell in ("tf-longctx-f32.long-episodes", "lstm-wide-impala.cartpole-episodes"):
    args = parse_args(["--workload", cell, "--seed", "1", "--seconds", "0.2", "--trace", "1",
                       "--device", "cpu"])
    run(args, bench, spec.find(bench["workloads"], cell, "workload"), torch.device("cpu"),
        time.time())
import portbench.calibrate
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny):
    p = subprocess.run([sys.executable, "-c", PROBE], cwd=tiny, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(p.stdout.split())
    assert "tpu_rl_torch" in loaded and "portbench" in loaded
    assert not loaded & set(BANNED), loaded & set(BANNED)


def test_the_names_are_compared_whole():
    loaded = ["tpu_rl_torch", "tpu_rl_torch.ops.lstm", "jaxtyping", "flaxen", "portbench.run"]
    assert banned_modules(loaded) == []
    assert banned_modules([*loaded, "tpu_rl.config", "jax.numpy", "flax"]) == [
        "flax", "jax", "tpu_rl"]
