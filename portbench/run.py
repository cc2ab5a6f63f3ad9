"""One run of one cell of the benchmark of ``tpu_rl_torch``:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run builds the port's learner step for the cell's configuration, makes
its weights and a pool of distinct batches from the seed on the device,
drives the step through its first updates (the ones the check compares),
then times updates for ``--seconds`` seconds. With ``--trace 1`` it then
runs a fixed number of updates under the profiler and reports the cell's
per-layer metrics instead of its end-to-end ones. Once the window has
closed and the program's state is freed, the plain reference repeats the
first updates and decides ``correct``. The last line of standard output is
one JSON object; the numbers compared, each beside its limit, are the last
lines of standard error.

The run refuses (exit 2, no result) without a CUDA card, or for a cell on
more cards than one (this harness drives one card), and fails (exit 1, no result) if JAX or the JAX package is
loaded once the window has closed. Nothing here reads ``BENCH_RUN``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
# Every kernel cache at a fixed place inside the checkout, so that only a
# checkout's first run builds; the port's own nvcc builds go to
# tpu_rl_torch/_build/ (kernels/build.py).
CACHE_ENV = {
    "TRITON_CACHE_DIR": CACHE / "triton",
    "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
    "CUDA_CACHE_PATH": CACHE / "nv",
}
BANNED = ("jax", "jaxlib", "flax", "tpu_rl")  # top-level module names, compared whole
CHECKED = 3  # the first updates; the configuration says how many of them are compared
TRACE_SECONDS = 1.0  # about how long the traced updates run


def process_start() -> float:
    """The wall-clock time at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Set by the harness's tests.
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def say(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def banned_modules(names=None) -> list[str]:
    """The top-level names of ``BANNED`` among the loaded modules (or
    ``names``)."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(BANNED))


def reference_rows(fields: dict) -> dict:
    """A batch as the reference reads it: one entry per step, the carry at
    the row's start."""
    return {
        "obs": fields["obs"], "act": fields["act"][..., 0].long(), "rew": fields["rew"][..., 0],
        "log_prob": fields["log_prob"][..., 0], "is_fir": fields["is_fir"][..., 0],
        "hx0": fields["hx"][:, 0], "cx0": fields["cx"][:, 0],
    }


def reference(conf: dict, mix: dict, seed: int, weights: dict, device, precision: str) -> dict:
    """The reference's first updates (as many as are compared) on the
    run's batches, with TF32 off in the backends (and the flags put back
    after)."""
    import torch

    from portbench.reference.step import train
    from portbench.traffic import make_batch

    cfg = conf["config"]
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        batches = [reference_rows(make_batch(cfg, mix, seed, i, device))
                   for i in range(conf["check"]["updates"])]
        return train(weights, batches, cfg, conf["architecture"], precision,
                     conf["check"]["block_rows"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def first_updates(program, batches: list, weights: dict, compared: int):
    """The first updates, through the window's own call and feed: each
    one's reported loss, the first gradient's norms leaf by leaf (from the
    optimizer's state after it) and the parameters' change over the first
    ``compared`` of them."""
    from portbench.check import change_norms

    losses = []
    for i in range(CHECKED):
        losses.append(float(program.update(batches[i])["loss"]))
        if i == 0:
            grads = program.first_grad_norms()
        if i + 1 == compared:
            changes = change_norms(program.params(), weights)
    return losses, grads, changes


def run(args, bench: dict, cell: dict, device, t_start: float, root: Path = ROOT) -> dict:
    """The run. Returns its result line."""
    import torch

    from portbench import check, spec
    from portbench.program import Program
    from portbench.trace import breakdown, traced_updates
    from portbench.traffic import make_batch, pool_size
    from portbench.weights import make_weights
    from portbench.window import run_window

    cuda = device.type == "cuda"
    conf = spec.load_config(bench, cell["config"], root)
    mix = spec.load_traffic(cell["traffic"], root)
    cfg = conf["config"]

    weights = make_weights(cfg, conf["architecture"], args.seed, device)
    program = Program(cfg, weights, device, args.fault)
    fields = [make_batch(cfg, mix, args.seed, 0, device)]
    fields += [make_batch(cfg, mix, args.seed, i, device)
               for i in range(1, pool_size(fields[0], mix))]
    batches = [program.batch(f) for f in fields]
    firsts = [f["is_fir"][..., 0] for f in fields]
    del fields

    losses, grads, changes = first_updates(program, batches, weights, conf["check"]["updates"])
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    started = time.time()
    say(f"set-up {started - t_start:.3f} s: {len(batches)} batches in the pool, "
        f"first losses {losses}")
    window, nxt = run_window(program, batches, CHECKED, args.seconds, device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    tr = None
    if args.trace:
        count = max(5, round(TRACE_SECONDS / statistics.median(window.update_s)))
        t0 = time.time()
        tr, nxt = traced_updates(program, batches, nxt, count, device)
        say(f"traced {count} updates in {tr.seconds:.3f} s, read in {time.time() - t0:.3f} s")
    del program, batches
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    say(f"window: {len(window.update_s)} updates in {window.seconds:.3f} s")
    t0 = time.time()
    ref = reference(conf, mix, args.seed, weights, device, "float32")
    say(f"reference: {time.time() - t0:.3f} s, {ref['kinks']} kink(s), "
        f"losses {ref['variants'][0]['loss']}")
    values = check.readings(losses, grads, changes, ref)
    checks = check.judge(values, conf["check"]["limits"])
    checks["nonfinite_updates"] = {"value": window.nonfinite, "limit": 0.0}

    kind = "per_layer" if args.trace else "end_to_end"
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    peaks = json.loads((spec.HERE / "peaks.json").read_text()).get(name)
    # What a metric's reader reads: the cell, its configuration and mix, the
    # timed window, the traced updates, the device's peaks and each pool
    # batch's episode starts.
    record = SimpleNamespace(
        cell=cell, config=cfg, architecture=conf["architecture"], mix=mix,
        setup_s=started - t_start, window=window, window_peak_bytes=window_peak, trace=tr,
        peaks=peaks, firsts=firsts)
    metrics = {}
    for m in spec.cell_metrics(bench, cell["name"], kind):
        value = spec.metric_reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1,
           "memory_peak_bytes": max(peak, window_peak)}
    result = {"correct": check.passed(checks), "attempted": len(window.update_s),
              "failed": round(window.nonfinite), "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.seconds
        result["breakdown"] = breakdown(tr)
    result["checks"] = checks
    return result


def main(argv: list[str] | None = None) -> int:
    t_start = process_start()
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    for k, v in CACHE_ENV.items():
        os.environ[k] = str(v)
    import torch

    from portbench import spec

    bench = spec.load_benchmark()
    cell = spec.find(bench["workloads"], args.workload, "workload")
    if cell["chips"] != 1:
        say(f"{args.workload} asks for {cell['chips']} cards; this harness drives one")
        return 2
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        say(f"{args.workload} needs a CUDA card; none is available")
        return 2
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    result = run(args, bench, cell, device, t_start)
    found = banned_modules()
    if found:
        print(f"portbench: modules {found} are loaded; the run may load none of {BANNED}",
              file=sys.stderr)
        return 1
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
