"""The spans pass of a ``--trace 1`` run: about a second of updates under
``torch.profiler`` with the program's phase spans on
(``tpu_rl_torch.obs.trace.span``). Each device operation is charged to the
innermost ``train_step*`` span open on the host when its launch was issued
(the runtime call that launched it, found by the operation's correlation
id), and each idle gap of the device to the innermost span open on the host
when the gap began. Outside every span is "outside". Each charged operation
is also classed by name as the traced pass's metrics class it (:func:`kind`:
products, B4, B1/B2, other). B4's device counter of visited score elements
is read over the same updates.

The readers of the per-phase metrics (``metrics/<phase>_device_ms.py``,
``metrics/<phase>_idle_ms.py``) and of ``b4_tile_yield`` call the functions
at the end; the first call runs the pass and keeps it on the run's record as
``record.spans``. The pass drives a program of its own, built once the run's
window, traced pass and check are over, from the run's configuration, with
the episode seams of the run's own batch pool (the other fields and the
weights come from ``SEED``: no launch depends on their values). So every
metric read from the run's traced pass, which runs with spans off, reads
what it read before this pass existed. Where the program has no spans (a
commit before them), the pass is None and so is every reader's value.
"""

from __future__ import annotations

import bisect
import gc
import json
import statistics
import sys
import time
from dataclasses import dataclass, field

from portbench.trace import union_s

ROOT = "train_step"
PHASES = ("forward", "backward", "optimizer", "diag")
OUTSIDE = "outside"  # device work launched, or idle begun, outside every span
STEP = "step"  # the root span's own part, outside its four phases
SEED = 0  # the spans pass's weights and every batch field but the seams
WARMUP = 3  # updates before the profiled ones: the allocator fills
POOL = 8  # at most this many distinct batches, cycled


def kind(name: str) -> str:
    """What a device operation is, by its name, as the per-layer metrics of
    the traced pass name them: products, B4, B1/B2 or other."""
    from portbench.metrics.b4_roofline import KERNELS
    from portbench.metrics.products_device_ms import PATTERNS

    low = name.lower()
    if any(p in low for p in PATTERNS):
        return "products"
    if any(prefix in name for prefix, _peak in KERNELS.values()):
        return "b4"
    if "lstm_fwd_" in name or "lstm_bwd_" in name:
        return "b12"
    return "other"


@dataclass
class Split:
    """What the spans pass measured, in seconds over ``updates`` updates."""

    updates: int = 0
    device_s: dict[str, float] = field(default_factory=dict)  # by bucket: phase, STEP, OUTSIDE
    idle_s: dict[str, float] = field(default_factory=dict)
    ops: int = 0  # device operations
    busy_s: float = 0.0  # the union of their intervals
    gaps_s: float = 0.0  # the gaps between them
    launched_by: dict[str, int] = field(default_factory=dict)  # how each op's launch was found
    by_kind_s: dict[str, dict[str, float]] = field(default_factory=dict)  # bucket -> kind -> s
    visited: int | None = None  # B4's visited score elements (its counter)
    kept: int | None = None  # (query, key) pairs x heads B4's forwards keep


def bucket(name: str) -> str:
    """The bucket of a span name: a phase, the root's own part, or the
    unknown name itself."""
    if name == ROOT:
        return STEP
    return name[len(ROOT) + 1:] if name.startswith(ROOT + ".") else name


def innermost(spans: list[tuple[float, float, str]], starts: list[float], t: float) -> str:
    """The innermost of ``spans`` (start, end, name; sorted by start, with
    ``starts`` their starts) open at ``t``: of those that began by ``t`` and
    had not ended, the one that began last; ``OUTSIDE`` if none."""
    j = bisect.bisect_right(starts, t) - 1
    while j >= 0:
        a, b, name = spans[j]
        if b > t:
            return name
        j -= 1
    return OUTSIDE


def charge(ops: list[tuple[float, float, float, str]], spans: list[tuple[float, float, str]],
           updates: int) -> Split:
    """Charge device operations (start, end, launch time, name) and the
    device's idle gaps between them to the innermost span (start, end,
    name) open on the host at the launch, or at the gap's start."""
    spans = sorted(spans)
    starts = [s[0] for s in spans]
    split = Split(updates=updates, ops=len(ops))
    buckets = (*PHASES, STEP, OUTSIDE)
    split.device_s = dict.fromkeys(buckets, 0.0)
    split.idle_s = dict.fromkeys(buckets, 0.0)
    for a, b, launched, name in ops:
        k = bucket(innermost(spans, starts, launched))
        split.device_s[k] = split.device_s.get(k, 0.0) + (b - a)
        kinds, c = split.by_kind_s.setdefault(k, {}), kind(name)
        kinds[c] = kinds.get(c, 0.0) + (b - a)
    split.busy_s, gaps = union_s([(a, b) for a, b, *_ in ops])
    for a, b in gaps:
        k = bucket(innermost(spans, starts, a))
        split.idle_s[k] = split.idle_s.get(k, 0.0) + (b - a)
        split.gaps_s += b - a
    return split


def kineto_rows(prof) -> list[tuple]:
    """The profile's events as rows (name, on the device, correlation id,
    linked correlation id, start s, end s), read from the profiler's raw
    results: the parse into ``FunctionEvent`` objects takes seconds. A
    span's own mark on the device's timeline (a user annotation) is left
    out."""
    from torch.autograd import DeviceType

    raw = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() in (DeviceType.CPU, DeviceType.CUDA)]
    base = min((e.start_ns() for e in raw), default=0)
    return [(e.name(), e.device_type() == DeviceType.CUDA, e.correlation_id(),
             e.linked_correlation_id(), (e.start_ns() - base) / 1e9, (e.end_ns() - base) / 1e9)
            for e in raw
            if not (e.device_type() == DeviceType.CUDA
                    and getattr(e, "is_user_annotation", lambda: False)())]


def from_events(rows: list[tuple]) -> tuple[list, list, dict[str, int]]:
    """The device operations (start, end, launch time, name) and the host's
    ``train_step*`` spans (start, end, name) of :func:`kineto_rows`. An
    operation's launch is the host start of the runtime call with its
    correlation id (``cuda*``/``cu*``); failing that, of the host operation
    it is linked to; failing both, its own start."""
    runtime, host, device, spans = {}, {}, [], []
    for name, on_device, corr, linked, a, b in rows:
        if on_device:
            device.append((corr, linked, a, b, name))
            continue
        if name == ROOT or name.startswith(ROOT + "."):
            spans.append((a, b, name))
        (runtime if name.startswith("cu") else host)[corr] = a
    ops, found = [], {"runtime": 0, "host": 0, "none": 0}
    for corr, linked, a, b, name in device:
        if corr in runtime:
            t, how = runtime[corr], "runtime"
        elif linked in host:
            t, how = host[linked], "host"
        else:
            t, how = a, "none"
        found[how] += 1
        ops.append((a, b, t, name))
    return ops, spans, found


def kept_pairs(run, batch_ids: list[int]) -> int:
    """The (query, key) pairs x heads that B4's forwards keep in the
    updates on pool batches ``batch_ids``: every layer, every epoch."""
    from portbench.counts import attention_pairs

    cfg = run.config
    per = cfg["n_heads"] * cfg["n_layers"] * cfg["K_epoch"]
    return per * sum(attention_pairs(run.firsts[i]) for i in batch_ids)


def spans_pass(run) -> Split | None:
    """Run the pass (see the module's doc). None where the run was not
    traced or the program has no spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_rl_torch.obs import trace as program_trace
    from tpu_rl_torch.ops import attention

    if run.trace is None or not hasattr(program_trace, "set_spans"):
        return None
    from portbench.program import Program
    from portbench.run import TRACE_SECONDS
    from portbench.traffic import make_batch
    from portbench.weights import make_weights
    from portbench.window import run_window

    t0 = time.perf_counter()
    cfg = run.config
    device = run.firsts[0].device
    program = Program(cfg, make_weights(cfg, run.architecture, SEED, device), device)
    batches = []
    for i in range(min(POOL, len(run.firsts))):
        fields = make_batch(cfg, run.mix, SEED, i, device)
        fields["is_fir"] = run.firsts[i][..., None]
        batches.append(program.batch(fields))
    count = max(5, round(TRACE_SECONDS / statistics.median(run.window.update_s)))
    _w, nxt = run_window(program, batches, 0, 0.0, device, count=WARMUP)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    program_trace.reset_counters()
    before = program_trace.set_spans(True)
    try:
        with profile(activities=activities) as prof:
            w, _ = run_window(program, batches, nxt, 0.0, device, count=count)
    finally:
        program_trace.set_spans(*before)
    counters = program_trace.counters()
    program_trace.reset_counters()
    visited = counters["counts"].get(getattr(attention, "VISITED", None))
    del program, batches
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ops, spans, found = from_events(kineto_rows(prof))
    split = charge(ops, spans, sum(1 for s in spans if s[2] == ROOT))
    split.launched_by = found
    if visited:
        split.visited = visited
        split.kept = kept_pairs(run, w.batch_ids)
    n = max(split.updates, 1)
    print("portbench: spans " + json.dumps({
        "updates": split.updates, "ops": split.ops, "launched_by": found,
        "device_ms": {k: v / n * 1e3 for k, v in split.device_s.items()},
        "idle_ms": {k: v / n * 1e3 for k, v in split.idle_s.items()},
        "busy_ms": split.busy_s / n * 1e3, "gaps_ms": split.gaps_s / n * 1e3,
        "host_ms": {bucket(k): v["seconds"] / n * 1e3 for k, v in counters["spans"].items()},
        "device_ms_by_kind": {k: {c: v / n * 1e3 for c, v in kinds.items()}
                              for k, kinds in split.by_kind_s.items()},
        "seconds": time.perf_counter() - t0,
        "visited": split.visited, "kept": split.kept}), file=sys.stderr, flush=True)
    return split


def read(run) -> Split | None:
    """The run's spans pass, run on the first call and kept on ``run``."""
    if not hasattr(run, "spans"):
        run.spans = spans_pass(run)
    return run.spans


def device_ms(run, phase: str) -> float | None:
    """Device milliseconds an update launched in ``phase``'s span."""
    split = read(run)
    if split is None or not split.ops or not split.updates:
        return None
    return split.device_s.get(phase, 0.0) / split.updates * 1e3


def idle_ms(run, phase: str) -> float | None:
    """Milliseconds an update that the device sat idle in gaps that began
    while the host was in ``phase``'s span."""
    split = read(run)
    if split is None or not split.ops or not split.updates:
        return None
    return split.idle_s.get(phase, 0.0) / split.updates * 1e3
