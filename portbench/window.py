"""The timed window: updates back to back for a fixed time, each on the
next batch of the pool, with no synchronisation inside.

On the card an update's time runs from the event recorded on the compute
stream at the end of the update before it (or at the window's start) to
the one recorded at its own end; the window's length runs from a
synchronised start to the ``torch.cuda.synchronize()`` that ends it. Off
the card (the harness's own tests) the updates run synchronously and the
host clock times them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class Window:
    seconds: float = 0.0
    batch_ids: list[int] = field(default_factory=list)
    enqueue_s: list[float] = field(default_factory=list)  # host time until the update returned
    update_s: list[float] = field(default_factory=list)  # end of the update before to its own end
    nonfinite: float = 0.0  # updates the program's guard skipped


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_window(program, batches: list, first: int, seconds: float, device,
               count: int | None = None) -> tuple[Window, int]:
    """Updates from pool index ``first`` on, for ``seconds`` (or exactly
    ``count`` updates). Returns the window and the next pool index."""
    cuda = torch.device(device).type == "cuda"
    w = Window()
    skipped = []
    marks = []
    sync(device)
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    i, n = first, 0
    while True:
        if n >= count if count is not None else time.perf_counter() - t0 >= seconds:
            break
        t1 = time.perf_counter()
        metrics = program.update(batches[i % len(batches)])
        t2 = time.perf_counter()
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(t2)
        skipped.append(metrics["nonfinite-updates"])
        w.enqueue_s.append(t2 - t1)
        w.batch_ids.append(i % len(batches))
        i, n = i + 1, n + 1
    sync(device)
    w.seconds = time.perf_counter() - t0
    if cuda:
        prev = start
        for ev in marks:
            w.update_s.append(prev.elapsed_time(ev) / 1e3)
            prev = ev
    else:
        w.update_s = [b - a for a, b in zip([t0, *marks[:-1]], marks)]
    w.nonfinite = float(torch.stack([s.reshape(()) for s in skipped]).sum()) if skipped else 0.0
    return w, i
