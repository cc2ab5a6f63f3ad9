"""The weights both sides start from, made on the device from the seed.

Every 2-D weight is drawn ``N(0, 1/fan_in)`` (LeCun normal, untruncated),
all of them from one draw of one generator; biases start at 0 and
LayerNorm scales at 1. The reference's parameter list names and sizes them
(:func:`portbench.reference.step.param_shapes`); the harness hands the
program these same tensors under the same names.
"""

from __future__ import annotations

import torch

from portbench.reference.step import MODELS, param_shapes
from portbench.traffic import batch_generator

WEIGHTS_STREAM = 1 << 40  # the generator index of the weights, apart from every batch's


def make_weights(cfg: dict, arch: dict, seed: int, device) -> dict[str, torch.Tensor]:
    shapes = param_shapes(cfg, arch)
    input_major = MODELS[cfg["model"]].INPUT_MAJOR
    drawn = {k: s for k, s in shapes.items() if len(s) == 2}
    total = sum(s[0] * s[1] for s in drawn.values())
    flat = torch.randn(total, generator=batch_generator(seed, WEIGHTS_STREAM, device),
                       device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        if len(shape) == 2:
            n = shape[0] * shape[1]
            fan_in = shape[0] if name in input_major else shape[1]
            out[name] = flat[off:off + n].view(shape) * fan_in ** -0.5
            off += n
        elif name.endswith(".bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out
