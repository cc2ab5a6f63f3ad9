"""The traced part of a ``--trace 1`` run: a fixed number of updates under
``torch.profiler``, reduced to the device's operations (name, start,
duration), the union of their intervals (the device's busy time) and the
longest idle gaps, each named by what the host was doing as it began.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

from portbench.window import run_window

TOP = 10  # entries of each list of the breakdown
GAPS_LABELLED = 500  # the longest idle gaps that are named


@dataclass
class Trace:
    seconds: float = 0.0  # the traced window, host clock
    updates: int = 0
    batch_ids: list[int] = field(default_factory=list)
    ops: list[tuple[str, float, float]] = field(default_factory=list)  # device: name, start, end (s)
    busy_s: float = 0.0
    idle_gaps: list[tuple[str, float]] = field(default_factory=list)


def union_s(intervals: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """Seconds covered by the intervals, and the gaps between them."""
    total, gaps, end = 0.0, [], None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total, gaps


def host_at(cpu: list[tuple[float, float, str]], starts: list[float], t: float) -> str:
    """The innermost host operation running at ``t``: of those that began
    by ``t`` and had not ended, the one that began last."""
    j = bisect.bisect_right(starts, t) - 1
    while j >= 0:
        a, b, name = cpu[j]
        if b > t:
            return name
        j -= 1
    return "(no host operation)"


def traced_updates(program, batches: list, first: int, count: int, device):
    """``count`` updates under the profiler. Returns the trace and the next
    pool index."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        w, nxt = run_window(program, batches, first, 0.0, device, count=count)
        seconds = time.perf_counter() - t0
    tr = Trace(seconds=seconds, updates=count, batch_ids=w.batch_ids)
    cpu = []
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            # a span a library annotates on the device's timeline (NCCL's
            # "nccl:all_reduce") covers kernels listed in their own right
            if not getattr(e, "is_user_annotation", False):
                tr.ops.append((e.name, a, b))
        elif e.device_type == DeviceType.CPU and not e.name.startswith("ProfilerStep"):
            cpu.append((a, b, e.name))
    tr.busy_s, gaps = union_s([(a, b) for _, a, b in tr.ops])
    cpu.sort()
    starts = [c[0] for c in cpu]
    by_host = defaultdict(float)
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_LABELLED]:
        by_host[host_at(cpu, starts, a)] += b - a
    tr.idle_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return tr, nxt


def breakdown(tr: Trace) -> dict:
    per_op = defaultdict(float)
    for name, a, b in tr.ops:
        per_op[name] += b - a
    return {
        "device_ops": [[k, v] for k, v in sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[k, v] for k, v in tr.idle_gaps],
    }


def device_ms_per_update(tr: Trace | None, match) -> float | None:
    """Device milliseconds an update in the operations whose name ``match``
    accepts; None where the trace holds none of them."""
    if tr is None:
        return None
    spans = [b - a for name, a, b in tr.ops if match(name)]
    return sum(spans) / tr.updates * 1e3 if spans else None
