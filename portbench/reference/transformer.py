"""The decoder-only actor-critic transformer, written out plainly.

Per token: ``x = embed(obs) + sinusoid(pos)``; per block
``x += out(attn(ln1(x)))`` then ``x += ff2(gelu_tanh(ff1(ln2(x))))``; then
``ln_f``, a log-softmax policy head and a value head. Attention is causal
within an episode: query t sees key s iff s <= t and no episode starts in
(s, t]. Positions count from the last episode start in the row (or from
the row's start). LayerNorm: epsilon from the configuration, biased
variance. GELU: the tanh approximation. The qkv projection's output columns
are (3, heads, head width) in that order. Weights are stored (out, in).
"""

from __future__ import annotations

import math

import torch

from portbench.reference.matmul import linear, matmul


# Every 2-D weight is stored (out, in).
INPUT_MAJOR: set[str] = set()


def param_shapes(cfg: dict, arch: dict) -> dict[str, tuple[int, ...]]:
    d, obs, A = cfg["hidden_size"], cfg["obs_shape"][0], cfg["action_space"]
    ff = arch["ff_mult"] * d
    shapes = {"embed.weight": (d, obs), "embed.bias": (d,)}
    for i in range(cfg["n_layers"]):
        p = f"block{i}."
        shapes.update({
            p + "attn.qkv.weight": (3 * d, d), p + "attn.qkv.bias": (3 * d,),
            p + "attn.out.weight": (d, d), p + "attn.out.bias": (d,),
            p + "ln1.weight": (d,), p + "ln1.bias": (d,),
            p + "ln2.weight": (d,), p + "ln2.bias": (d,),
            p + "ff1.weight": (ff, d), p + "ff1.bias": (ff,),
            p + "ff2.weight": (d, ff), p + "ff2.bias": (d,),
        })
    shapes.update({"ln_f.weight": (d,), "ln_f.bias": (d,), "logits.weight": (A, d),
                   "logits.bias": (A,), "value.weight": (1, d), "value.bias": (1,)})
    return shapes


def _layer_norm(x, w, b, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _sinusoid(pos: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0) * torch.arange(half, dtype=torch.float64, device=pos.device)
        / max(half - 1, 1)
    ).float()
    ang = pos[..., None].float() * freqs
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return torch.nn.functional.pad(emb, (0, dim % 2))


def episode_index(firsts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T) episode number within the row and position within the episode,
    from the (B, T) 0/1 episode-start flags."""
    B, T = firsts.shape
    episode = torch.cumsum(firsts.long(), dim=1)
    t = torch.arange(T, device=firsts.device).expand(B, T)
    last_start = torch.cummax(torch.where(firsts > 0, t, torch.zeros_like(t)), dim=1).values
    return episode, t - last_start


def _attention(x, p, prefix, heads, visible, precision):
    B, T, d = x.shape
    D = d // heads
    qkv = linear(x, p[prefix + "qkv.weight"], p[prefix + "qkv.bias"], precision)
    qkv = qkv.reshape(B, T, 3, heads, D).permute(2, 0, 3, 1, 4)  # (3, B, H, T, D)
    q, k, v = (t.reshape(B * heads, T, D) for t in qkv)
    s = matmul(q, k.transpose(1, 2), precision) / math.sqrt(D)
    s = s.reshape(B, heads, T, T).masked_fill(~visible[:, None], float("-inf"))
    w = torch.softmax(s, dim=-1).reshape(B * heads, T, T)
    o = matmul(w, v, precision).reshape(B, heads, T, D).transpose(1, 2).reshape(B, T, d)
    return linear(o, p[prefix + "out.weight"], p[prefix + "out.bias"], precision)


def forward(p: dict, obs: torch.Tensor, firsts: torch.Tensor, cfg: dict, arch: dict,
            precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Log-probabilities of every action (B, T, A) and values (B, T, 1) of
    the rows ``obs`` (B, T, obs) with episode starts ``firsts`` (B, T)."""
    T = obs.shape[1]
    eps, heads = arch["layer_norm_eps"], cfg["n_heads"]
    episode, pos = episode_index(firsts)
    causal = torch.ones(T, T, dtype=torch.bool, device=obs.device).tril()
    visible = causal[None] & (episode[:, :, None] == episode[:, None, :])
    x = linear(obs, p["embed.weight"], p["embed.bias"], precision)
    x = x + _sinusoid(pos, x.shape[-1])
    for i in range(cfg["n_layers"]):
        b = f"block{i}."
        h = _layer_norm(x, p[b + "ln1.weight"], p[b + "ln1.bias"], eps)
        x = x + _attention(h, p, b + "attn.", heads, visible, precision)
        h = _layer_norm(x, p[b + "ln2.weight"], p[b + "ln2.bias"], eps)
        h = _gelu_tanh(linear(h, p[b + "ff1.weight"], p[b + "ff1.bias"], precision))
        x = x + linear(h, p[b + "ff2.weight"], p[b + "ff2.bias"], precision)
    h = _layer_norm(x, p["ln_f.weight"], p["ln_f.bias"], eps)
    logp = torch.log_softmax(linear(h, p["logits.weight"], p["logits.bias"], precision), dim=-1)
    return logp, linear(h, p["value.weight"], p["value.bias"], precision)
