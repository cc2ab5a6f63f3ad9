"""Device milliseconds an update in matrix-product kernels (cuBLAS's and
CUTLASS's), by name, over the traced updates."""

from portbench.trace import device_ms_per_update

PATTERNS = ("gemm", "xmma", "nvjet", "cutlass")


def read(run):
    return device_ms_per_update(run.trace, lambda n: any(p in n.lower() for p in PATTERNS))
