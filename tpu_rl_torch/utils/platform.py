"""Device placement of the runtime's processes — the torch counterpart of
``tpu_rl.utils.platform``.

Only the learner touches the card. Worker, manager and storage processes
are host roles: each would otherwise cost a CUDA context (~0.5 GB of device
memory) and race the learner for the card. :func:`force_cpu` hides every
card from the process before CUDA initialises; the supervisor also sets
``CUDA_VISIBLE_DEVICES=""`` in a host child's environment before it starts
(:data:`HOST_ENV`), so nothing the child imports can see a card.

``tpu_rl``'s ``ensure_accelerator_or_cpu`` (a probe that quietly degrades
the learner to the CPU when the accelerator does not answer) has no
counterpart: ``learner_device="auto"`` means the card, and without one the
learner raises (:func:`learner_device`).
"""

from __future__ import annotations

import os

# Environment of a host child (set before the spawn so the child starts
# with it): no card is visible.
HOST_ENV = {"CUDA_VISIBLE_DEVICES": ""}


def force_cpu() -> None:
    """Hide every CUDA device from this process. Effective only before the
    process's first CUDA call; raises if CUDA is already initialised here,
    since a context can no longer be given back."""
    import torch

    if torch.cuda.is_initialized():
        raise RuntimeError("force_cpu: CUDA is already initialised in this process")
    os.environ.update(HOST_ENV)


def host_role(threads: int = 1) -> None:
    """Set up a host-role process: no card, and ``threads`` intra-op
    threads (N processes x every core of intra-op threads would
    oversubscribe the host)."""
    import torch

    force_cpu()
    torch.set_num_threads(max(1, int(threads)))


def learner_device(cfg) -> str:
    """The learner's torch device for ``cfg.learner_device``: ``"cpu"`` is
    the CPU; ``"auto"`` is the card, and raises when there is none (never a
    silent CPU run)."""
    if cfg.learner_device == "cpu":
        return "cpu"
    from tpu_rl_torch import resolve_device

    return str(resolve_device("cuda"))
