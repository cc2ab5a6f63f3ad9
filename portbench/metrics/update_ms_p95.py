"""The 95th percentile of the time of every update in the window, from the
end of the update before it to its own end, by events on the compute
stream: the tail of the gap between the policy versions the
learner publishes."""

import statistics


def read(run):
    times = run.window.update_s
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=100, method="inclusive")[94] * 1e3
