"""Span tracing for the learner batch timeline.

The port's own copy of ``tpu_rl.obs.trace``, unchanged in behaviour.

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
