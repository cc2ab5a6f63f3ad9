"""B1/B2's share of their roofline: the least time of the traced updates'
calls (``portbench.counts.b12_work``) over the device time of the
``lstm_fwd_*`` and ``lstm_bwd_*`` kernels, in %, against the dense TF32
rate (B1/B2's split-precision f32 products run on the tensor cores)."""

from portbench.counts import b12_work, least_s


def read(run):
    cfg, tr = run.config, run.trace
    if tr is None or run.peaks is None:
        return None
    spent = sum(b - a for name, a, b in tr.ops if "lstm_fwd_" in name or "lstm_bwd_" in name)
    if spent <= 0:
        return None
    work = b12_work(cfg["batch_size"], cfg["seq_len"], cfg["hidden_size"])
    per_update = cfg["K_epoch"] * sum(
        least_s(w, run.peaks["tf32_flops_per_s"], run.peaks["hbm_bytes_per_s"])
        for w in work.values())
    return 100.0 * per_update * tr.updates / spent
