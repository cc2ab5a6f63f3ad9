"""The work the cells' inputs need, counted from the configuration's shapes
and the batch's own episode starts, the same whatever implements it:
FLOPs (a multiply-add is 2) and bytes (each input read once, each output
written once, 4 bytes an f32 element). Recomputed work is not counted, and
neither are tiles a kernel visits.
"""

from __future__ import annotations

import torch

F32 = 4


def attention_pairs(firsts: torch.Tensor) -> int:
    """(query, key) pairs that causal attention within an episode keeps in
    rows with episode starts ``firsts`` (B, T): c(c+1)/2 for each episode
    piece of c steps in a row."""
    B, T = firsts.shape
    piece = torch.cumsum(firsts.long(), dim=1) + (T + 1) * torch.arange(
        B, device=firsts.device)[:, None]
    c = torch.bincount(piece.flatten(), minlength=B * (T + 1)).double()
    return int((c * (c + 1) / 2).sum())


def b4_work(B: int, T: int, H: int, D: int, pairs: int, elt: int = F32) -> dict:
    """B4's forward and backward on one layer: 4·D FLOPs a kept pair a head
    forward (scores and P·V), 8·D backward (dV, dP, dQ, dK). Forward reads
    q, k, v and the segment ids and writes o and the row log-sum-exp;
    backward reads q, k, v, o, do, the log-sum-exp and the ids and writes
    dq, dk, dv. ``pairs`` counts the batch's pairs (each head sees them
    all)."""
    n = B * T * H * D * elt
    seg, lse = 4 * B * T, F32 * B * H * T
    return {"fwd": {"flops": 4 * D * H * pairs, "bytes": 4 * n + seg + lse},
            "bwd": {"flops": 8 * D * H * pairs, "bytes": 8 * n + seg + lse}}


def b12_work(B: int, S: int, H: int) -> dict:
    """B1 and B2: the S recurrent products of B rows, 2·B·S·H·4H FLOPs each
    way. B1 reads the input projection (B,S,4H), the recurrent weight
    (H,4H), the initial carries and the reset mask and writes h and c of
    every step; B2 reads what B1 read and both outputs' cotangents and
    writes the projection's gradient and the initial carries'."""
    xp, w, carry, keep, seq = B * S * 4 * H, H * 4 * H, 2 * B * H, B * S, 2 * B * S * H
    flops = 2 * B * S * H * 4 * H
    return {"fwd": {"flops": flops, "bytes": F32 * (xp + w + carry + keep + seq)},
            "bwd": {"flops": flops, "bytes": F32 * (xp + w + carry + keep + seq + xp + carry)}}


def least_s(work: dict, flops_per_s: float, bytes_per_s: float) -> float:
    """The least time of a call: the larger of its FLOPs over the peak and
    its bytes over the memory's rate."""
    return max(work["flops"] / flops_per_s, work["bytes"] / bytes_per_s)


def model_flops(cfg: dict, arch: dict, firsts: torch.Tensor) -> float:
    """The model's forward and backward FLOPs on one batch (rows
    ``firsts``): every weight product once forward and twice backward
    (6 FLOPs a weight a token), and for the transformer the kept attention
    pairs at 12·d a pair (4·d forward, 8·d backward over the heads)."""
    B, S = firsts.shape
    obs, A = cfg["obs_shape"][0], cfg["action_space"]
    if cfg["model"] == "transformer":
        d, ff = cfg["hidden_size"], arch["ff_mult"] * cfg["hidden_size"]
        weights = obs * d + cfg["n_layers"] * (4 * d * d + 2 * d * ff) + d * (A + 1)
        attention = cfg["n_layers"] * 12 * d * attention_pairs(firsts)
    else:
        H = cfg["hidden_size"]
        weights = obs * H + 2 * H * 4 * H + H * (A + 1)
        attention = 0
    return 6.0 * weights * B * S + attention
