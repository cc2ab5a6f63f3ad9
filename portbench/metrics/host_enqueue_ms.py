"""The median host time until ``train_step`` returns, over the untraced
window: what the host spends issuing an update. Near the update's own time
the host paces the step."""

import statistics


def read(run):
    return statistics.median(run.window.enqueue_s) * 1e3
