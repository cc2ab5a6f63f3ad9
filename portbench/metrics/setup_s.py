"""Seconds from the process's start to the first timed update: imports,
kernel builds (the first run of a checkout), weights, the batch pool and
the first updates."""


def read(run):
    return run.setup_s
