"""The cost of the train step's phase spans (``tpu_rl_torch.obs.trace``)
while they are on and no profiler records: windows of updates with spans
off and on in turns (off, on, on, off, ...), in one process on one card,
on a ``portbench`` cell's configuration, weights and batch pool.

    python3 lab/spans_lab.py --workload lstm-wide-impala.cartpole-episodes \\
        --seed 1 --seconds 5 --runs 6

Prints one JSON line a window (spans on or off, samples/s, the median host
enqueue and the median update, ms) and, last, each side's medians and the
change from off to on.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--runs", type=int, default=6, help="windows on each side")
    args = p.parse_args(argv)

    import torch

    from portbench import spec
    from portbench.program import Program
    from portbench.traffic import make_batch, pool_size
    from portbench.weights import make_weights
    from portbench.window import run_window
    from tpu_rl_torch.obs import trace

    if not torch.cuda.is_available():
        print("spans_lab: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = spec.load_benchmark()
    cell = spec.find(bench["workloads"], args.workload, "workload")
    conf = spec.load_config(bench, cell["config"])
    mix = spec.load_traffic(cell["traffic"])
    cfg = conf["config"]
    program = Program(cfg, make_weights(cfg, conf["architecture"], args.seed, device), device)
    first = make_batch(cfg, mix, args.seed, 0, device)
    fields = [first] + [make_batch(cfg, mix, args.seed, i, device)
                        for i in range(1, pool_size(first, mix))]
    batches = [program.batch(f) for f in fields]
    del fields, first
    _w, nxt = run_window(program, batches, 0, 0.0, device, count=3)
    samples = cfg["batch_size"] * cfg["seq_len"]
    rows = {False: [], True: []}
    for i in range(2 * args.runs):
        on = i % 4 in (1, 2)
        before = trace.set_spans(on)
        try:
            w, nxt = run_window(program, batches, nxt, args.seconds, device)
        finally:
            trace.set_spans(*before)
            trace.reset_counters()
        row = {"spans": on, "samples_per_s": len(w.update_s) * samples / w.seconds,
               "enqueue_ms": statistics.median(w.enqueue_s) * 1e3,
               "update_ms": statistics.median(w.update_s) * 1e3}
        rows[on].append(row)
        print(json.dumps(row), flush=True)
    summary = {"device": torch.cuda.get_device_name(device), "workload": args.workload}
    for key in ("samples_per_s", "enqueue_ms", "update_ms"):
        off, on = (statistics.median(r[key] for r in rows[s]) for s in (False, True))
        summary[key] = {"off": off, "on": on, "change": on / off - 1.0}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
