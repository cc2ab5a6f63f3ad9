"""Single-device attention of the transformer family — the port of part of
``tpu_rl.parallel.sequence``.

Every primitive has ``tpu_rl``'s contract: ``(q, k, v, q_pos, seg,
axis_name=None, causal=True) -> o``, with q, k, v (B,T,H,D), global
positions q_pos and segment ids seg (B,T), and o (B,T,H,D) in q's dtype.

- :func:`full_attention`: the reference. Masks by positions and segments
  (query i sees key j iff ``seg_i == seg_j`` and, causally, ``pos_i >=
  pos_j``) with ``tpu_rl``'s finite -inf, and keeps its mixed-precision rule:
  contraction operands in the input's dtype, f32 accumulation, f32 softmax,
  and a backward that contracts the same way (``_make_mp_einsum``). A bf16
  product with f32 accumulation is written as the bf16 operands upcast to
  f32 and multiplied in f32: the same exact products and an f32 sum, on the
  CPU and on the card (a bare bf16 ``torch.matmul`` would round its output).
- :func:`flash_attention`: kernel B4 (:mod:`tpu_rl_torch.ops.attention`),
  the counterpart of ``flash_attention_tpu``. Like the TPU kernel it masks
  causally by index, not by position, and takes the positions only to
  ignore them; with segment-relative positions the two masks are the same.
- :func:`blockwise_attention`: exact attention that never holds the (T, T)
  scores, a loop over (Q tile, K tile) pairs with the online softmax, and a
  backward that recomputes each tile's probabilities from the saved row
  log-sum-exp. It is plain PyTorch, as ``tpu_rl``'s is plain JAX (a
  ``lax.scan`` of einsums): its tile products are cuBLAS's on the card
  (``ops.matmul.mm_f32``: bf16 operands with an f32 result, as ``mixed_dot``).

Not here yet: the ring and Ulysses schemes, which need
``torch.distributed`` (see ``ROADMAP.md``). ``tpu_rl``'s mesh, ``shard_map``
islands and Pallas block-size rule are TPU matters and do not come over.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tpu_rl_torch.ops.attention import flash_attn
from tpu_rl_torch.ops.matmul import mm_f32

_NEG_INF = -1e30  # finite -inf stand-in: keeps exp()/max() NaN-free


def segment_ids_from_firsts(firsts: torch.Tensor) -> torch.Tensor:
    """Segment ids from episode-first flags: (B, T, 1) -> (B, T) int32."""
    return torch.cumsum(firsts[..., 0].to(torch.int32), dim=1, dtype=torch.int32)


def _contract_dtype(x: torch.Tensor) -> torch.dtype:
    """Dtype of attention contraction operands: bf16 for bf16 inputs, else
    f32. Accumulation and softmax are f32 either way."""
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def _in(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held in f32 for an f32-accumulating
    product."""
    return x.to(dtype).float()


class _MPEinsum(torch.autograd.Function):
    """Bilinear einsum with ``tpu_rl``'s mixed-precision VJP: operands and
    the incoming cotangent rounded to ``dtype``, f32 accumulation, each
    cotangent returned in its primal's dtype. For f32 inputs it is the plain
    einsum. ``specs = (spec, da_spec, db_spec, db_primal_first)``."""

    @staticmethod
    def forward(ctx, a, b, dtype, specs):
        ad, bd = _in(a, dtype), _in(b, dtype)
        ctx.save_for_backward(ad, bd)
        ctx.dtype, ctx.specs, ctx.primal = dtype, specs, (a.dtype, b.dtype)
        return torch.einsum(specs[0], ad, bd)

    @staticmethod
    def backward(ctx, g):
        ad, bd = ctx.saved_tensors
        _spec, da_spec, db_spec, db_primal_first = ctx.specs
        gd = _in(g, ctx.dtype)
        da = torch.einsum(da_spec, gd, bd)
        db = torch.einsum(db_spec, *((ad, gd) if db_primal_first else (gd, ad)))
        return da.to(ctx.primal[0]), db.to(ctx.primal[1]), None, None


# scores = einsum('bqhd,bkhd->bhqk', q, k)
_QK = ("bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd", "bhqk,bqhd->bkhd", False)
# out = einsum('bhqk,bkhd->bqhd', p, v)
_PV = ("bhqk,bkhd->bqhd", "bqhd,bkhd->bhqk", "bhqk,bqhd->bkhd", True)


def _masked_block_scores(q, k, q_pos, k_pos, q_seg, k_seg, scale, causal):
    """(B, H, Tq, Tk) masked f32 logits."""
    scores = _MPEinsum.apply(q, k, _contract_dtype(q), _QK) * scale
    mask = q_seg[:, None, :, None] == k_seg[:, None, None, :]
    if causal:
        mask = mask & (q_pos[:, None, :, None] >= k_pos[:, None, None, :])
    return torch.where(mask, scores, _NEG_INF)


def full_attention(q, k, v, q_pos, seg, axis_name=None, causal=True):
    """Single-device reference attention; materializes the (B,H,T,T)
    scores."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _masked_block_scores(q, k, q_pos, q_pos, seg, seg, scale, causal)
    p = torch.softmax(scores, dim=-1)
    return _MPEinsum.apply(p, v, _contract_dtype(v), _PV).to(q.dtype)


def flash_attention(q, k, v, q_pos, seg, axis_name=None, causal=True):
    """Causal, segment-masked attention through kernel B4 (forward and
    backward). ``q_pos`` is ignored: the kernel masks causally by index."""
    if not causal:
        raise NotImplementedError("flash_attention: kernel B4 is causal only")
    return flash_attn(q, k, v, seg.to(torch.int32).contiguous())


# ------------------------------------------------------- blockwise (1 GPU)
# Default tile: (B, H, 512, 512) f32 score transients per tile pair.
BLOCKWISE_BLOCK = 512


def _tile_scores(q_i, k_j, pos_i, pos_j, seg_i, seg_j, scale, causal):
    """(B, H, Tq, Tk) masked f32 logits of one (Q tile, K tile) pair; q_i and
    k_j (B, H, T, D) in the contraction dtype."""
    scores = mm_f32(q_i, k_j.transpose(-1, -2)) * scale
    mask = seg_i[:, None, :, None] == seg_j[:, None, None, :]
    if causal:
        mask = mask & (pos_i[:, None, :, None] >= pos_j[:, None, None, :])
    return torch.where(mask, scores, _NEG_INF)


def _heads_major(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, T, H, D) -> contiguous (B, H, T, D) in ``dtype``."""
    return x.to(dtype).transpose(1, 2).contiguous()


class _Blockwise(torch.autograd.Function):
    """``tpu_rl``'s ``_blockwise_vjp`` over tiles of ``block`` rows (T a
    multiple of it): the forward keeps a running max, normaliser and output
    per Q tile over the K tiles; the backward recomputes each tile's
    probabilities from the saved log-sum-exp, accumulating dK/dV over Q
    tiles and dQ over K tiles. Every tile pair is visited: the mask is by
    position and segment, so no pair can be skipped on its indices."""

    @staticmethod
    def forward(ctx, q, k, v, pos, seg, block, causal):
        B, T, H, D = q.shape
        scale = 1.0 / math.sqrt(D)
        cd, cdv = _contract_dtype(q), _contract_dtype(v)
        qh, kh, vh = _heads_major(q, cd), _heads_major(k, cd), _heads_major(v, cdv)
        tiles = [slice(s, s + block) for s in range(0, T, block)]
        outs, lses = [], []
        for qs in tiles:
            o = torch.zeros((B, H, block, D), dtype=torch.float32, device=q.device)
            m = torch.full((B, H, block), _NEG_INF, dtype=torch.float32, device=q.device)
            l = torch.zeros((B, H, block), dtype=torch.float32, device=q.device)
            for ks in tiles:
                scores = _tile_scores(qh[:, :, qs], kh[:, :, ks], pos[:, qs], pos[:, ks],
                                      seg[:, qs], seg[:, ks], scale, causal)
                m_new = torch.maximum(m, scores.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(scores - m_new[..., None])
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + mm_f32(p.to(cdv), vh[:, :, ks])
                m = m_new
            l = torch.clamp_min(l, 1e-30)
            lses.append(m + torch.log(l))
            outs.append((o / l[..., None]).to(q.dtype))
        out = torch.cat(outs, dim=2).transpose(1, 2).contiguous()
        lse = torch.cat(lses, dim=2)  # (B, H, T)
        ctx.save_for_backward(q, k, v, pos, seg, out, lse)
        ctx.block, ctx.causal = block, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, pos, seg, out, lse = ctx.saved_tensors
        block, causal = ctx.block, ctx.causal
        T, D = q.shape[1], q.shape[3]
        scale = 1.0 / math.sqrt(D)
        # contraction operands in the input's dtype, f32 sums and elementwise
        cd = _contract_dtype(q)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)  # (B, H, T)
        qh, kh, vh, doh = (_heads_major(x, cd) for x in (q, k, v, do))
        dk = torch.zeros(kh.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(vh.shape, dtype=torch.float32, device=q.device)
        tiles = [slice(s, s + block) for s in range(0, T, block)]
        dqs = []
        for qs in tiles:
            q_i, do_i, lse_i, delta_i = qh[:, :, qs], doh[:, :, qs], lse[:, :, qs], delta[:, :, qs]
            dq_i = torch.zeros(q_i.shape, dtype=torch.float32, device=q.device)
            for ks in tiles:
                k_j, v_j = kh[:, :, ks], vh[:, :, ks]
                scores = _tile_scores(q_i, k_j, pos[:, qs], pos[:, ks], seg[:, qs], seg[:, ks],
                                      scale, causal)
                p = torch.where(scores <= _NEG_INF * 0.5, 0.0, torch.exp(scores - lse_i[..., None]))
                dv[:, :, ks] += mm_f32(p.to(cd).transpose(-1, -2), do_i)
                dp = mm_f32(do_i, v_j.transpose(-1, -2))
                ds = (p * (dp - delta_i[..., None]) * scale).to(cd)
                dq_i += mm_f32(ds, k_j)
                dk[:, :, ks] += mm_f32(ds.transpose(-1, -2), q_i)
            dqs.append(dq_i)
        dq = torch.cat(dqs, dim=2).transpose(1, 2).to(q.dtype)
        return (dq, dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype),
                None, None, None, None)


def blockwise_attention(q, k, v, q_pos, seg, axis_name=None, causal=True,
                        block: int = BLOCKWISE_BLOCK):
    """Exact single-device attention over (Q tile, K tile) pairs that never
    holds the (B, H, T, T) scores; memory O(T·D + block²). ``T % block``
    need not be 0: the sequence is padded up to ``nb`` tiles of
    ``ceil(T / nb)`` rows with segment id -1 (no real row's), and the
    padding is sliced off the output. Padding and slicing sit outside the
    autograd Function, so autograd drops the padding's cotangent."""
    T = q.shape[1]
    nb = max(1, -(-T // block))
    blk = -(-T // nb)  # nb tiles of blk >= T rows
    pad = nb * blk - T
    if not pad:
        return _Blockwise.apply(q, k, v, q_pos, seg, blk, bool(causal))
    q_p, k_p, v_p = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
    pos_p = F.pad(q_pos, (0, pad))
    seg_p = F.pad(seg, (0, pad), value=-1)
    return _Blockwise.apply(q_p, k_p, v_p, pos_p, seg_p, blk, bool(causal))[:, :T]


ATTENTION_IMPLS = {"full": full_attention, "flash": flash_attention,
                   "blockwise": blockwise_attention}
