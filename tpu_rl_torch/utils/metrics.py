"""Tensorboard scalars — the port's copy of ``make_writer`` and
``NullWriter`` from ``tpu_rl.utils.metrics``.

:func:`make_writer` returns a tensorboardX ``SummaryWriter`` on
``result_dir``, or a :class:`NullWriter` when there is no ``result_dir`` or
tensorboardX is not installed; the second case is said once on stderr, so
a run that asked for event files and writes none says why.
"""

from __future__ import annotations

import sys


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
