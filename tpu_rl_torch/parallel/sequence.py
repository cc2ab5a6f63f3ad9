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

Not here yet: ``blockwise_attention`` and the ring and Ulysses schemes,
which need ``torch.distributed`` (see ``ROADMAP.md``). ``tpu_rl``'s mesh,
``shard_map`` islands and Pallas block-size rule are TPU matters and do not
come over.
"""

from __future__ import annotations

import math

import torch

from tpu_rl_torch.ops.attention import flash_attn

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


ATTENTION_IMPLS = {"full": full_attention, "flash": flash_attention}
