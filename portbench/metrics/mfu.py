"""The whole step's share of the card's peak: the model FLOPs of the
untraced window's updates (``portbench.counts.model_flops``) over the
window's seconds times the card's peak, in %.
The peak for f32 compute is the dense TF32 rate, for bf16 the dense bf16
rate."""

from portbench.counts import model_flops

PEAK = {"float32": "tf32_flops_per_s", "bfloat16": "bf16_flops_per_s"}


def read(run):
    if run.peaks is None:
        return None
    cfg = run.config
    ids = run.window.batch_ids
    per_batch = {i: model_flops(cfg, run.architecture, run.firsts[i]) for i in set(ids)}
    flops = cfg["K_epoch"] * sum(per_batch[i] for i in ids)
    return 100.0 * flops / (run.window.seconds * run.peaks[PEAK[cfg["compute_dtype"]]])
