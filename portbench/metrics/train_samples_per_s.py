"""Samples (rows x steps of the global batch) trained per second: the
updates completed in the window over the window's seconds, host clock, the
window ending in ``torch.cuda.synchronize()``."""


def read(run):
    w = run.window
    return len(w.update_s) * run.config["batch_size"] * run.config["seq_len"] / w.seconds
