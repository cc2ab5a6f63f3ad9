"""Span tracing for the learner batch timeline, and the port's one way to
open a span inside the program.

:class:`TraceRecorder` is the port's own copy of ``tpu_rl.obs.trace``,
unchanged in behaviour. :func:`span` (below it) is the port's addition.

The ExecutionTimer answers "how long does X take on average"; it cannot
answer "where did THIS batch's time go" — whether queue-wait happened
because the feeder was assembling, blocked on shm, or idle. A
:class:`TraceRecorder` is the missing instrument: a bounded ring of
complete spans (name, start, duration, thread lane) covering
assemble -> queue-wait -> H2D -> train_step -> broadcast, exported as
Chrome trace-event JSON (the ``chrome://tracing`` / Perfetto "X" phase
format) so the learner's pipeline overlap is visible on a real timeline.

Cost model: recording a span is a ``perf_counter`` pair + one deque append
under a lock — safe from the feeder thread and the hot loop concurrently,
and bounded by ``capacity`` spans of memory. When tracing is disabled the
recorder is never constructed (``LearnerService`` guards on ``is None``),
so the hot loop carries no per-update cost.

The deep-dive companion is the torch.profiler window that already exists
(``Config.profile_dir`` / ``profile_start`` / ``profile_steps``): this ring
shows the host-side pipeline shape continuously; the profiler hook captures
device internals for a configured update window on top.

:func:`span` marks a phase of the program (the train step's ``train_step``,
``train_step.forward``, ``.backward``, ``.optimizer``, ``.diag``; the
learner's ``learner-dispatch``). Spans are off by default, and then
``span`` returns one shared no-op context: no clock reading, no profiler
call, no record. :func:`set_spans` turns them on; each span then adds its
host time to a per-name total, opens ``torch.profiler.record_function``
while a profiler is recording (so it lies on the profiler's timeline, the
clock the device's operations share), and appends itself to the ring that
``set_spans`` installed, if any. Device counters (:func:`add_count`, such
as B4's visited score elements) count while spans are on, on the device;
:func:`counters` reads them once, after the caller has synchronised.
"""

from __future__ import annotations

import contextlib
import json
import socket
import threading
import time
from collections import deque


class TraceRecorder:
    """Ring buffer of completed spans, exportable as Chrome trace events."""

    def __init__(
        self,
        capacity: int = 4096,
        pid: int = 0,
        role: str = "",
        host: str | None = None,
    ):
        self.capacity = int(capacity)
        self.pid = int(pid)
        self.role = role
        self.host = socket.gethostname() if host is None else host
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.n_recorded = 0
        # One shared epoch so timestamps from every thread share an axis —
        # paired with a wall-clock anchor taken at the same instant so dumps
        # from different processes can be merged onto ONE fleet axis
        # (tpu_rl_torch.obs.merge): a span's wall time is wall_anchor_ns + rel.
        self._t0 = time.perf_counter()
        self.wall_anchor_ns = time.time_ns()

    # ---------------------------------------------------------------- record
    def add(
        self,
        name: str,
        start: float,
        dur: float,
        tid: str = "main",
        args: dict | None = None,
    ) -> None:
        """One completed span; ``start`` is a ``perf_counter`` reading."""
        with self._lock:
            self._events.append((name, start - self._t0, dur, tid, args))
            self.n_recorded += 1

    @contextlib.contextmanager
    def span(self, name: str, tid: str = "main", args: dict | None = None):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.add(name, t0, time.perf_counter() - t0, tid=tid, args=args)

    def __len__(self) -> int:
        return len(self._events)

    # ---------------------------------------------------------------- export
    def to_chrome(self, extra_meta: dict | None = None) -> dict:
        """Chrome trace-event JSON object format: complete ("X") events with
        microsecond timestamps, one named lane per recording thread. The
        top-level ``meta`` block (role/pid/host + the wall-clock anchor of
        the perf_counter epoch) is what makes dumps from different processes
        mergeable in principle — without it a ring's timestamps are an
        offset-unknown local axis."""
        with self._lock:
            events = list(self._events)
        trace_events: list[dict] = []
        tids: dict[str, int] = {}
        for name, rel, dur, tid, args in events:
            tid_i = tids.setdefault(tid, len(tids))
            ev = {
                "name": name,
                "ph": "X",
                "ts": rel * 1e6,
                "dur": dur * 1e6,
                "pid": self.pid,
                "tid": tid_i,
            }
            if args:
                ev["args"] = args
            trace_events.append(ev)
        if self.role:
            trace_events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": self.pid,
                    "tid": 0,
                    "args": {"name": f"{self.role} {self.host}/{self.pid}"},
                }
            )
        # Thread-name metadata so the viewer shows "main"/"feeder" lanes.
        for tname, tid_i in tids.items():
            trace_events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": self.pid,
                    "tid": tid_i,
                    "args": {"name": tname},
                }
            )
        meta = {
            "role": self.role,
            "pid": self.pid,
            "host": self.host,
            "wall_anchor_ns": self.wall_anchor_ns,
        }
        if extra_meta:
            meta.update(extra_meta)
        return {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "meta": meta,
        }

    def dump(self, path: str, extra_meta: dict | None = None) -> None:
        """Atomic write (tmp + rename) so a viewer never loads a torn file."""
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome(extra_meta), f)
        os.replace(tmp, path)


# ------------------------------------------------------------------ spans
class _NoSpan:
    """The span while spans are off: one shared context that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()

_on = False  # the switch: span() tests only this while spans are off
_ring: TraceRecorder | None = None
_lock = threading.Lock()
_totals: dict[str, list] = {}  # name -> [spans closed, host seconds]
_counts: dict = {}  # name -> 0-d int64 tensor on the device it counts


class _Span:
    __slots__ = ("name", "args", "rf", "t0")

    def __init__(self, name: str, args: dict):
        self.name, self.args, self.rf = name, args, None

    def __enter__(self):
        import torch

        # record_function costs a dispatcher call even with no profiler
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(
                self.name, json.dumps(self.args) if self.args else None)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        with _lock:
            total = _totals.setdefault(self.name, [0, 0.0])
            total[0] += 1
            total[1] += dur
        ring = _ring
        if ring is not None:
            ring.add(self.name, self.t0, dur, args=self.args or None)
        return False


def span(name: str, **args):
    """A context that marks one phase ``name`` (with JSON-able ``args``)
    while spans are on, and :data:`NO_SPAN` while they are off."""
    if not _on:
        return NO_SPAN
    return _Span(name, args)


def set_spans(on: bool, ring: TraceRecorder | None = None) -> tuple[bool, TraceRecorder | None]:
    """Turn spans on or off and install ``ring`` (or none) to receive them.
    Returns the switch and ring it replaced, to be put back after."""
    global _on, _ring
    old = _on, _ring
    _on, _ring = bool(on), ring
    return old


def spans_on() -> bool:
    return _on


def add_count(name: str, value) -> None:
    """Add the integer 0-d tensor ``value`` to the device counter ``name``,
    on the tensor's device: no host read. Call only while spans are on."""
    with _lock:
        acc = _counts.get(name)
        if acc is None:
            _counts[name] = value.detach().clone()
        else:
            acc.add_(value)


def counters() -> dict:
    """``{"spans": {name: {"count", "seconds"}}, "counts": {name: int}}``:
    the spans' host totals and each device counter, read once (a host
    read: call after synchronising)."""
    with _lock:
        spans = {k: {"count": n, "seconds": s} for k, (n, s) in _totals.items()}
        counts = dict(_counts)
    return {"spans": spans, "counts": {k: int(v) for k, v in counts.items()}}


def reset_counters() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()
