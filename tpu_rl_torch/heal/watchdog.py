"""Host-side divergence watchdog and windowed rollback budget.

The port's own copy of ``tpu_rl.heal.watchdog``, unchanged in behaviour.

The learner feeds the watchdog its loss-log-cadence observables (loss,
grad-norm, fleet mean return) plus the cumulative on-device non-finite
update count. Two independent trigger channels:

- **z-score channel**: per-signal EWMA mean + EWMA variance (alpha =
  2/(window+1)); a sample further than ``z_max`` standard deviations from
  its running mean is anomalous. Anomalous samples are *not* folded into
  the running statistics (a robust detector: a divergence can't drag its
  own baseline up). A trigger needs ``sustain`` consecutive anomalous
  checks — one bad minibatch is noise, a streak is a trend.
- **non-finite channel**: the in-jit guards already contained the bad
  updates (params untouched), so this channel fires immediately once the
  *cumulative* skipped-update count since the last rollback reaches
  ``nonfinite_max`` — sustained NaN production means the data stream or
  the optimizer state is poisoned and only a rollback + fence helps.

Pure stdlib + math so unit tests on synthetic traces are exact; the
guards of the train step live in :mod:`tpu_rl_torch.heal.guards`.
"""

from __future__ import annotations

import math
import time
from typing import Callable

_EPS = 1e-12


class _Ewma:
    """EWMA mean + EWMA variance over one scalar signal."""

    __slots__ = ("alpha", "mean", "var", "n")

    def __init__(self, window: int):
        self.alpha = 2.0 / (float(window) + 1.0)
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def zscore(self, x: float) -> float:
        """|z| of ``x`` against the current stats (0.0 while warming up)."""
        if self.n < 1:
            return 0.0
        return abs(x - self.mean) / math.sqrt(self.var + _EPS)

    def update(self, x: float) -> None:
        if self.n == 0:
            self.mean = x
        else:
            delta = x - self.mean
            self.mean += self.alpha * delta
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * delta * delta)
        self.n += 1


class DivergenceWatchdog:
    """Sustained-anomaly detector over named scalar training signals.

    ``observe({"loss": ..., "grad-norm": ...})`` returns True when the
    anomaly streak reaches ``sustain``; ``note_nonfinite(total)`` returns
    True when the cumulative guard-skip count reaches ``nonfinite_max``.
    After a rollback the learner calls :meth:`reset` so detection restarts
    from the restored trajectory's statistics.
    """

    def __init__(
        self,
        window: int = 32,
        z_max: float = 6.0,
        sustain: int = 3,
        nonfinite_max: int = 3,
    ):
        self.window = int(window)
        self.z_max = float(z_max)
        self.sustain = int(sustain)
        self.nonfinite_max = int(nonfinite_max)
        self._stats: dict[str, _Ewma] = {}
        self._streak = 0
        self.last_reason = ""

    def observe(self, signals: dict[str, float]) -> bool:
        """One check over a dict of named scalars; True = sustained anomaly."""
        anomalies = []
        for name, value in signals.items():
            stat = self._stats.get(name)
            if stat is None:
                stat = self._stats[name] = _Ewma(self.window)
            if not math.isfinite(value):
                # Non-finite host observations are anomalous regardless of
                # warmup and never enter the statistics.
                anomalies.append(f"{name}=non-finite")
                continue
            if stat.n >= self.window:
                z = stat.zscore(value)
                if z > self.z_max:
                    anomalies.append(f"{name} z={z:.1f}")
                    continue  # robust: anomaly excluded from the EWMA
            stat.update(value)
        if anomalies:
            self._streak += 1
            self.last_reason = (
                f"sustained anomaly x{self._streak}: " + ", ".join(anomalies)
            )
        else:
            self._streak = 0
        return self._streak >= self.sustain

    def note_nonfinite(self, total: float) -> bool:
        """Cumulative guard-skipped updates since last reset; True = trip."""
        if total >= self.nonfinite_max:
            self.last_reason = f"nonfinite updates {total:g} >= {self.nonfinite_max}"
            return True
        return False

    def reset(self) -> None:
        """Forget all statistics and streaks (post-rollback restart)."""
        self._stats = {}
        self._streak = 0


class RollbackBudget:
    """Sliding-window rollback allowance (the PR 6 restart-budget shape).

    At most ``max_rollbacks`` rollbacks inside any trailing
    ``window_s``-second window; an exhausted budget means the run is
    genuinely broken and the learner exits cleanly instead of looping.
    """

    def __init__(
        self,
        max_rollbacks: int = 3,
        window_s: float = 600.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_rollbacks = int(max_rollbacks)
        self.window_s = float(window_s)
        self._clock = clock
        self._times: list[float] = []

    def _prune(self) -> None:
        now = self._clock()
        self._times = [t for t in self._times if now - t <= self.window_s]

    def exhausted(self) -> bool:
        self._prune()
        return len(self._times) >= self.max_rollbacks

    def record(self) -> None:
        self._times.append(self._clock())

    @property
    def used(self) -> int:
        self._prune()
        return len(self._times)
