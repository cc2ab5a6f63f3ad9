"""The reference's train steps: the loss of a whole batch and its gradient,
the clip of the gradient by its global norm, the update guard and RMSprop
(decay 0.99, epsilon 1e-5 outside the square root, nu starting at 0).

The loss and the gradient are summed over blocks of rows, each block's
weighted by its share of the rows, so that the step fits in memory at the
sizes the program is timed at. Nothing here keeps a block's activations
past its own backward pass.
"""

from __future__ import annotations

import itertools
import math

import torch

from portbench.reference import losses, lstm, transformer

MODELS = {"transformer": transformer, "lstm": lstm}
RMS_DECAY, RMS_EPS = 0.99, 1e-5
MAX_KINKS = 8  # the first update's kinks; every one of the 2**k ways they fall is worked out


def param_shapes(cfg: dict, arch: dict) -> dict[str, tuple[int, ...]]:
    return MODELS[cfg["model"]].param_shapes(cfg, arch)


def _block_loss(p, rows: dict, cfg: dict, arch: dict, precision: str) -> torch.Tensor:
    if cfg["model"] == "transformer":
        logp, value = transformer.forward(p, rows["obs"], rows["is_fir"], cfg, arch, precision)
    else:
        logp, value = lstm.forward(p, rows["obs"], rows["is_fir"], rows["hx0"], rows["cx0"], cfg,
                                   arch, precision)
    return losses.LOSSES[cfg["algo"]](logp, value[..., 0], rows, cfg)  # loss, scale, kinks


def loss_and_grads(params: dict, batch: dict, cfg: dict, arch: dict, precision: str,
                   block_rows: int) -> tuple[float, float, dict, list[dict]]:
    """The batch's loss, its scale, its gradient with respect to
    ``params``, and the gradient of each of its kinks (what the gradient
    gains if that kink's term falls on the other side)."""
    B = batch["obs"].shape[0]
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    kinks = []
    total = scale = 0.0
    for b0 in range(0, B, block_rows):
        rows = {k: v[b0:b0 + block_rows] for k, v in batch.items()}
        share = rows["obs"].shape[0] / B
        loss, magnitude, block_kinks = _block_loss(leaves, rows, cfg, arch, precision)
        for c in block_kinks:
            g = torch.autograd.grad(c * share, list(leaves.values()), retain_graph=True,
                                    allow_unused=True)
            kinks.append({k: torch.zeros_like(v) if gk is None else gk
                          for (k, v), gk in zip(leaves.items(), g)})
        for k, g in zip(leaves, torch.autograd.grad(loss * share, list(leaves.values()))):
            grads[k] += g
        total += float(loss.detach()) * share
        scale += float(magnitude) * share
    return total, scale, grads, kinks


def _rmsprop(g: torch.Tensor, nu: torch.Tensor, lr: float):
    """RMSprop's step for gradient ``g``: (the parameters' change, new nu)."""
    nu = (1.0 - RMS_DECAY) * g * g + RMS_DECAY * nu
    return -lr * g / (torch.sqrt(nu) + RMS_EPS), nu


def _update(params: dict, nu: dict, grads: dict, loss: float, cfg: dict):
    """One update from the loss's raw gradient: the clip by the global norm,
    the update guard (a non-finite update is skipped) and RMSprop. Returns
    the clipped gradient, the new parameters and the new nu."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    clip = min(1.0, cfg["max_grad_norm"] / (float(norm) + 1e-6))
    grads = {k: g * clip for k, g in grads.items()}
    if not (math.isfinite(loss) and math.isfinite(float(norm))):
        return grads, params, nu
    params, nu = dict(params), dict(nu)
    for k, g in grads.items():
        change, nu[k] = _rmsprop(g, nu[k], cfg["lr"])
        params[k] = params[k] + change
    return grads, params, nu


def _norms(tree: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def train(params0: dict, batches: list[dict], cfg: dict, arch: dict, precision: str,
          block_rows: int) -> dict:
    """``len(batches)`` updates from ``params0``, once for every way the
    first update's kinks can fall (the reference's own way first). Returns
    the number of kinks and, for each way, each update's loss and its scale,
    the norms of the first update's clipped gradient (what the optimizer
    got) and of each parameter's change over the updates, leaf by leaf.
    Kinks of the later updates fall as the reference puts them."""
    loss, scale, raw, kinks = loss_and_grads(params0, batches[0], cfg, arch, precision,
                                             block_rows)
    if len(kinks) > MAX_KINKS:
        raise ValueError(f"{len(kinks)} kinks in the first update; the reference works out "
                         f"the ways of at most {MAX_KINKS}")
    nu0 = {k: torch.zeros_like(v) for k, v in params0.items()}
    variants = []
    for falls in itertools.product((False, True), repeat=len(kinks)):
        grads = {k: g + sum((kink[k] for kink, f in zip(kinks, falls) if f), torch.zeros_like(g))
                 for k, g in raw.items()}
        first, params, nu = _update(params0, nu0, grads, loss, cfg)
        way = {"loss": [loss], "scale": [scale], "grad_norms": _norms(first)}
        for batch in batches[1:]:
            l, sc, grads, _ = loss_and_grads(params, batch, cfg, arch, precision, block_rows)
            _, params, nu = _update(params, nu, grads, l, cfg)
            way["loss"].append(l)
            way["scale"].append(sc)
        way["change_norms"] = _norms({k: params[k] - params0[k] for k in params})
        variants.append(way)
    return {"kinks": len(kinks), "variants": variants}
