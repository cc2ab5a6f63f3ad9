"""Transformer actor-critic — the port of ``tpu_rl.models.transformer``.

A decoder-only causal transformer with categorical and value heads, with
the unroll contract of ``DiscreteActorCritic``: ``(obs, carry0, firsts) ->
(log-softmax logits (B,T,A), value (B,T,1), carry0)``; the carry passes
through untouched. Episode seams (``firsts``) become segment ids, and the
positions restart at each seam. Acting runs :meth:`TransformerActorCritic.decode`
over per-layer K/V caches.

Submodule names follow flax's tree (``embed``, ``block{i}/attn/{qkv,out}``,
``block{i}/{ln1,ln2,ff1,ff2}``, ``ln_f``, ``logits``, ``value``), so the
state_dict keys follow the flax paths, and the ``qkv`` projection keeps the
(B,T,3,H,D) column order: the weight bridge stays a plain transpose.

flax's numerics are kept: ``nn.LayerNorm`` (epsilon 1e-6, fast variance,
statistics in f32, an f32 result for f32 params whatever the input),
``nn.gelu`` (the tanh approximation) and ``nn.Dense`` with a compute dtype
(input, kernel and bias cast to it). Under ``dtype=torch.bfloat16`` the
residual stream is bf16, the LayerNorm outputs are f32 and the heads are f32.
``tpu_rl``'s bf16 products accumulate in f32; cuBLAS does so only with
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False``,
so building a bf16 :class:`TransformerActorCritic` sets that process-wide
flag (it makes every bf16 product of the process reduce in f32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpu_rl_torch.models.cells import dense, init_dense_, reduce_bf16_in_f32
from tpu_rl_torch.parallel.sequence import ATTENTION_IMPLS, segment_ids_from_firsts


def sinusoidal_embedding(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """(B, T) int positions -> (B, T, dim) f32 sinusoidal embeddings."""
    half = dim // 2
    # float64 then float32, as numpy computes tpu_rl's; made on pos's device
    # (a pageable host-to-device copy would synchronize the stream)
    steps = torch.arange(half, dtype=torch.float64, device=pos.device)
    freqs = torch.exp(-math.log(10000.0) * steps / max(half - 1, 1)).float()
    ang = pos[..., None].float() * freqs
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` with f32 params: ``weight`` is flax's
    ``scale``."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mean * mean, 0.0)
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class MultiHeadAttention(nn.Module):
    """Causal segment-masked MHA through ``ATTENTION_IMPLS[attention_impl]``,
    plus the single-token cached :meth:`decode`."""

    def __init__(self, hidden: int, n_heads: int, attention_impl: str = "full", dtype=None):
        super().__init__()
        assert hidden % n_heads == 0, f"d_model {hidden} not divisible by heads {n_heads}"
        self.n_heads = n_heads
        self.attention_impl = attention_impl
        self.dtype = dtype
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x, pos, seg):
        B, T, C = x.shape
        H = self.n_heads
        qkv = dense(self.qkv, x, self.dtype).reshape(B, T, 3, H, C // H)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        o = ATTENTION_IMPLS[self.attention_impl](q, k, v, pos, seg, causal=True)
        return dense(self.out, o.reshape(B, T, C), self.dtype)

    def decode(self, x_t, k_cache, v_cache, count):
        """One step for the newest token x_t (B,1,C): ring-write its K/V at
        ``count % ctx`` (per row), then attend over the cache entries
        ``arange(ctx) <= count``. The caches are f32; they are read in the
        compute dtype."""
        B, _, C = x_t.shape
        H = self.n_heads
        ctx = k_cache.shape[1]
        qkv = dense(self.qkv, x_t, self.dtype).reshape(B, 1, 3, H, C // H)
        q, k_new, v_new = qkv[:, 0, 0], qkv[:, 0, 1], qkv[:, 0, 2]  # (B,H,D)
        slots = torch.arange(ctx, device=x_t.device)
        # A select, not a blend: a NaN projection cannot poison other slots.
        write = (slots[None, :] == torch.remainder(count, ctx)[:, None])[:, :, None, None]
        k_cache = torch.where(write, k_new.to(k_cache.dtype)[:, None], k_cache)
        v_cache = torch.where(write, v_new.to(v_cache.dtype)[:, None], v_cache)
        valid = slots[None, :] <= count[:, None]  # (B, ctx)
        # compute-dtype operands, f32 accumulation and softmax
        kc = k_cache.to(q.dtype).float()
        vc = v_cache.to(q.dtype).float()
        scores = torch.einsum("bhd,bthd->bht", q.float(), kc) * (1.0 / math.sqrt(C / H))
        scores = torch.where(valid[:, None, :], scores, -torch.inf)
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum("bht,bthd->bhd", w, vc)
        return dense(self.out, o.reshape(B, 1, C), self.dtype), k_cache, v_cache


class Block(nn.Module):
    def __init__(self, hidden: int, n_heads: int, ff_mult: int = 4, attention_impl: str = "full",
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.attn = MultiHeadAttention(hidden, n_heads, attention_impl, dtype)
        self.ln1 = LayerNorm(hidden)
        self.ln2 = LayerNorm(hidden)
        self.ff1 = nn.Linear(hidden, ff_mult * hidden)
        self.ff2 = nn.Linear(ff_mult * hidden, hidden)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_dense_(self.attn.qkv, generator)
        init_dense_(self.attn.out, generator)
        self.ln1.reset_parameters()
        self.ln2.reset_parameters()
        init_dense_(self.ff1, generator)
        init_dense_(self.ff2, generator)

    def _ff(self, x):
        h = F.gelu(dense(self.ff1, self.ln2(x), self.dtype), approximate="tanh")
        return dense(self.ff2, h, self.dtype)

    def forward(self, x, pos, seg):
        x = x + self.attn(self.ln1(x), pos, seg)
        return x + self._ff(x)

    def decode(self, x_t, k_cache, v_cache, count):
        a, k_cache, v_cache = self.attn.decode(self.ln1(x_t), k_cache, v_cache, count)
        x_t = x_t + a
        return x_t + self._ff(x_t), k_cache, v_cache


class TransformerActorCritic(nn.Module):
    """Decoder-only causal transformer with categorical and value heads.
    Params stay f32; ``dtype`` is the compute dtype (None = f32)."""

    def __init__(self, obs_dim: int, n_actions: int, hidden: int = 64, n_heads: int = 4,
                 n_layers: int = 2, ff_mult: int = 4, attention_impl: str = "full", dtype=None):
        super().__init__()
        reduce_bf16_in_f32(dtype)
        self.n_actions = n_actions
        self.hidden = hidden
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.dtype = dtype
        self.embed = nn.Linear(obs_dim, hidden)
        for i in range(n_layers):
            self.add_module(f"block{i}", Block(hidden, n_heads, ff_mult, attention_impl, dtype))
        self.ln_f = LayerNorm(hidden)
        self.logits = nn.Linear(hidden, n_actions)
        self.value = nn.Linear(hidden, 1)

    @property
    def blocks(self) -> list[Block]:
        return [getattr(self, f"block{i}") for i in range(self.n_layers)]

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """flax's init: lecun_normal Dense kernels, zero biases, LayerNorm
        ones and zeros, drawn in module order."""
        init_dense_(self.embed, generator)
        for block in self.blocks:
            block.reset_parameters(generator)
        self.ln_f.reset_parameters()
        init_dense_(self.logits, generator)
        init_dense_(self.value, generator)

    def _heads(self, x):
        h = self.ln_f(x)  # f32: log-probs and values feed the loss math
        return torch.log_softmax(dense(self.logits, h, None), dim=-1), dense(self.value, h, None)

    def unroll(self, obs, carry0, firsts, pos=None, seg=None):
        B, T = obs.shape[0], obs.shape[1]
        if seg is None:
            seg = segment_ids_from_firsts(firsts)
        if pos is None:
            # Segment-relative positions, restarting at episode seams, as
            # the acting positions count from the episode start.
            idx = torch.arange(T, dtype=torch.int32, device=obs.device).expand(B, T)
            seam = torch.cummax(torch.where(firsts[..., 0] > 0, idx, 0), dim=1).values
            pos = idx - seam
        x = dense(self.embed, obs, self.dtype)
        x = x + sinusoidal_embedding(pos, self.hidden).to(x.dtype)
        for block in self.blocks:
            x = block(x, pos, seg)
        logits, value = self._heads(x)
        return logits, value, carry0

    def decode(self, obs_t, k_caches, v_caches, count):
        """One acting step: obs_t (B, obs_dim), caches (B, n_layers, ctx, H,
        D) f32, count (B,) int32 tokens already cached per row (the
        episode-relative position). Returns (logits (B,A), value (B,1),
        k_caches', v_caches')."""
        pos = count[:, None].to(torch.int32)
        x = dense(self.embed, obs_t[:, None, :], self.dtype)
        x = x + sinusoidal_embedding(pos, self.hidden).to(x.dtype)
        new_k, new_v = [], []
        for i, block in enumerate(self.blocks):
            x, k_i, v_i = block.decode(x, k_caches[:, i], v_caches[:, i], count)
            new_k.append(k_i)
            new_v.append(v_i)
        logits, value = self._heads(x)
        return logits[:, 0], value[:, 0], torch.stack(new_k, dim=1), torch.stack(new_v, dim=1)

    def forward(self, obs, carry, firsts=None, pos=None, seg=None):
        """``torch.func.functional_call`` calls ``forward``: one decode step
        without ``firsts`` (``carry = (k_caches, v_caches, count)``), the
        sequence unroll with them (and, optionally, explicit positions and
        segment ids)."""
        if firsts is None:
            return self.decode(obs, *carry)
        return self.unroll(obs, carry, firsts, pos, seg)
