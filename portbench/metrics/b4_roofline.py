"""B4's share of its roofline: the least time of the traced updates' B4
calls (``portbench.counts.b4_work`` on each batch's own episode seams,
forward and backward on every layer) over the device time of B4's kernels
(``flash_f32_*`` at f32, ``flash_tc_*`` at bf16, wherever the name
places them), in %. The peak for f32 is
the dense TF32 rate, which no f32-accurate tensor-core product exceeds."""

from portbench.counts import attention_pairs, b4_work, least_s

KERNELS = {"float32": ("flash_f32_", "tf32_flops_per_s"),
           "bfloat16": ("flash_tc_", "bf16_flops_per_s")}


def read(run):
    cfg, tr = run.config, run.trace
    if tr is None or run.peaks is None:
        return None
    prefix, peak = KERNELS[cfg["compute_dtype"]]
    spent = sum(b - a for name, a, b in tr.ops if prefix in name)
    if spent <= 0:
        return None
    d, H = cfg["hidden_size"], cfg["n_heads"]
    elt = 4 if cfg["compute_dtype"] == "float32" else 2
    least = 0.0
    for i in tr.batch_ids:
        f = run.firsts[i]
        work = b4_work(f.shape[0], f.shape[1], H, d // H, attention_pairs(f), elt)
        least += cfg["n_layers"] * cfg["K_epoch"] * sum(
            least_s(w, run.peaks[peak], run.peaks["hbm_bytes_per_s"]) for w in work.values())
    return 100.0 * least / spent
