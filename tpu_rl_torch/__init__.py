"""tpu_rl_torch — the PyTorch/CUDA port of ``tpu_rl`` for one NVIDIA H100.

The package mirrors ``tpu_rl``'s module layout so each counterpart is easy to
find, but it imports only ``torch`` (and numpy): never ``jax`` and never a
module of ``tpu_rl``. What it needs from ``tpu_rl`` it keeps as its own copy.

Entry points (:func:`tpu_rl_torch.models.families.build_family`,
:class:`tpu_rl_torch.runtime.inference_service.InferenceService`,
``tpu_rl_torch.algos.registry.get_algo(...).build``,
:class:`tpu_rl_torch.runtime.colocated.ColocatedLoop`) run on
``device="cuda"`` unless the caller passes ``device="cpu"``; on a machine
without CUDA they raise instead of quietly running on the CPU. Each
hand-written CUDA kernel keeps a plain PyTorch version beside it, which is
taken only for tensors that already lie on the CPU.
"""

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller asked
    for another. Raises when CUDA is asked for (explicitly or by default) and
    none is present, so nothing silently drops to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_rl_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_card(fn: str, t: torch.Tensor) -> bool:
    """Where the kernel wrapper ``fn`` runs for ``t``: False for a CPU tensor
    (its plain version), True for a CUDA tensor on the current device (the
    kernel: a C entry launches on the calling thread's current device). Any
    other device, or another card than the current one, raises: a wrapper
    never falls back."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{fn}: tensors on {t.device}, current device is cuda:{torch.cuda.current_device()}"
        )
    return True
