"""Tensorboard scalars — the port's copy of ``tpu_rl.utils.metrics``
(``make_writer``, ``NullWriter`` and the learner's ``LearnerLogger``).

:func:`make_writer` returns a tensorboardX ``SummaryWriter`` on
``result_dir``, or a :class:`NullWriter` when there is no ``result_dir`` or
tensorboardX is not installed; the second case is said once on stderr, so
a run that asked for event files and writes none says why.
"""

from __future__ import annotations

import sys
from typing import Mapping


class NullWriter:
    def add_scalar(self, *a, **kw) -> None: ...

    def flush(self) -> None: ...

    def close(self) -> None: ...


_warned_no_tensorboard = False


def make_writer(result_dir: str | None):
    global _warned_no_tensorboard
    if result_dir is None:
        return NullWriter()
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(result_dir)
    except Exception as e:
        # A result_dir was requested but no event files will appear — say
        # why, once, instead of silently degrading.
        if not _warned_no_tensorboard:
            _warned_no_tensorboard = True
            print(
                f"[metrics] tensorboardX unavailable "
                f"({type(e).__name__}: {e}); writing no event files "
                f"(NullWriter) for result_dir={result_dir!r}",
                file=sys.stderr,
                flush=True,
            )
        return NullWriter()


class LearnerLogger:
    """Scalar fan-out for the learner loop (names follow the reference so
    dashboards transfer)."""

    def __init__(self, writer, algo: str):
        self.w = writer
        self.algo = algo

    def log_losses(self, step: int, metrics: Mapping[str, float]) -> None:
        for name, val in metrics.items():
            self.w.add_scalar(f"{self.algo}/{name}", float(val), step)

    def log_timers(self, step: int, timer) -> None:
        for name, val in timer.scalars().items():
            self.w.add_scalar(f"perf/{name}", float(val), step)

    def log_stat(self, game_count: int, mean_rew: float) -> None:
        self.w.add_scalar(
            "50-game-mean-stat-of-epi-rew", float(mean_rew), game_count
        )

    def flush(self) -> None:
        self.w.flush()
