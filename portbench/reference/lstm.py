"""The LSTM actor-critic, written out plainly.

``x = relu(body(obs))``; per step t, the carry is zeroed on the rows where
an episode starts at t, then ``z = x_proj(x_t) + h @ W`` (W stored (H, 4H),
gates i, f, g, o), ``c = σ(f)·c + σ(i)·tanh(g)``, ``h = σ(o)·tanh(c)``; a
log-softmax policy head and a value head on every step's h. The carry at
the row's start is the batch's stored one.
"""

from __future__ import annotations

import torch

from portbench.reference.matmul import linear, matmul


# Weights stored (in, out), used as ``h @ W``; every other 2-D weight is (out, in).
INPUT_MAJOR = {"cell.recurrent_kernel"}


def param_shapes(cfg: dict, arch: dict) -> dict[str, tuple[int, ...]]:
    H, obs, A = cfg["hidden_size"], cfg["obs_shape"][0], cfg["action_space"]
    return {
        "body.weight": (H, obs), "body.bias": (H,),
        "cell.x_proj.weight": (4 * H, H), "cell.x_proj.bias": (4 * H,),
        "cell.recurrent_kernel": (H, 4 * H),
        "logits.weight": (A, H), "logits.bias": (A,),
        "value.weight": (1, H), "value.bias": (1,),
    }


def forward(p: dict, obs: torch.Tensor, firsts: torch.Tensor, h0: torch.Tensor,
            c0: torch.Tensor, cfg: dict, arch: dict, precision: str):
    """Log-probabilities (B, S, A) and values (B, S, 1)."""
    x = torch.relu(linear(obs, p["body.weight"], p["body.bias"], precision))
    xp = linear(x, p["cell.x_proj.weight"], p["cell.x_proj.bias"], precision)
    h, c = h0, c0
    hs = []
    for t in range(obs.shape[1]):
        keep = (firsts[:, t] == 0).to(h.dtype)[:, None]
        h, c = h * keep, c * keep
        i, f, g, o = (xp[:, t] + matmul(h, p["cell.recurrent_kernel"], precision)).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    hs = torch.stack(hs, dim=1)
    logp = torch.log_softmax(linear(hs, p["logits.weight"], p["logits.bias"], precision), -1)
    return logp, linear(hs, p["value.weight"], p["value.bias"], precision)
