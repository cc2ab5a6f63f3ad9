"""Wall-clock instrumentation — the port's own copy of
``tpu_rl.utils.timer.ExecutionTimer``: named spans and gauges kept in bounded
windows and reduced to means (``<name>-elapsed-mean-sec``,
``<name>-transition-per-secs``, ``<name>-mean``)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque


class ExecutionTimer:
    def __init__(self, num_transition: int = 0, window: int = 100):
        self.num_transition = num_transition  # seq_len * batch_size
        self.elapsed: dict[str, deque] = defaultdict(lambda: deque(maxlen=window))
        self.throughput: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window)
        )
        self.gauges: dict[str, deque] = defaultdict(lambda: deque(maxlen=window))

    @contextlib.contextmanager
    def timer(self, name: str, check_throughput: bool = False):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.record(name, time.perf_counter() - t0, check_throughput)

    def record(self, name: str, dt: float, check_throughput: bool = False) -> None:
        """Record an externally measured duration."""
        self.elapsed[name].append(dt)
        if check_throughput and self.num_transition and dt > 0:
            self.throughput[name].append(self.num_transition / dt)

    def record_gauge(self, name: str, value: float) -> None:
        """Record a unitless instantaneous value (e.g. a flushed batch size)."""
        self.gauges[name].append(float(value))

    def mean_elapsed(self, name: str) -> float | None:
        q = self.elapsed.get(name)
        return sum(q) / len(q) if q else None

    def mean_throughput(self, name: str) -> float | None:
        q = self.throughput.get(name)
        return sum(q) / len(q) if q else None

    def mean_gauge(self, name: str) -> float | None:
        q = self.gauges.get(name)
        return sum(q) / len(q) if q else None

    def scalars(self) -> dict[str, float]:
        """All windows reduced to means, keyed with the tensorboard naming
        (gauges get a plain ``-mean`` suffix: they are not durations)."""
        out = {}
        for name in self.elapsed:
            m = self.mean_elapsed(name)
            if m is not None:
                out[f"{name}-elapsed-mean-sec"] = m
        for name in self.throughput:
            m = self.mean_throughput(name)
            if m is not None:
                out[f"{name}-transition-per-secs"] = m
        for name in self.gauges:
            m = self.mean_gauge(name)
            if m is not None:
                out[f"{name}-mean"] = m
        return out
