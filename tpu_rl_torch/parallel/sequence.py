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

- :func:`ring_attention` and :func:`ulysses_attention`: the
  sequence-parallel schemes over the ``"seq"`` group of a rank mesh
  (:func:`make_sp_mesh`), each rank holding ``T / n_seq`` tokens. The ring
  rotates K/V blocks with ``batch_isend_irecv`` under the online softmax,
  and its backward is a second ring pass that rotates K/V with their dK/dV
  accumulators home, so residuals scale with the shard, not the ring.
  Ulysses re-shards from sequence to heads with ``all_to_all_single``, runs
  full attention on its ``H / n_seq`` heads, and re-shards back. Both are
  plain PyTorch, as ``tpu_rl``'s are plain JAX (no Pallas kernel there).
  Positions and segment ids are global, computed before the split.

``tpu_rl``'s ``shard_map`` islands and Pallas block-size rule are TPU
matters and do not come over.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tpu_rl_torch.ops.attention import flash_attn
from tpu_rl_torch.ops.matmul import mm_f32
from tpu_rl_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, make_sp_mesh  # noqa: F401

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


# ----------------------------------------------- sequence parallel (ranks)
def _online_update(o, m, l, scores, v_blk):
    """Online-softmax accumulation of one K/V block. o (B,H,Tq,D) f32;
    m, l (B,H,Tq); scores (B,H,Tq,Tk); v_blk (B,H,Tk,D) in its contraction
    dtype."""
    m_new = torch.maximum(m, scores.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l = l * alpha + p.sum(-1)
    o = o * alpha[..., None] + mm_f32(p.to(v_blk.dtype), v_blk)
    return o, m_new, l


def _rotate(mesh, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """One hop of the ring over ``mesh``'s seq group: every tensor goes to
    the next seq rank and comes from the previous one (as ``ppermute`` with
    ``(i, i + 1 mod n)``)."""
    import torch.distributed as dist

    n = mesh.n_seq
    r = mesh.seq_index
    group = mesh.groups[SEQ_AXIS]
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    sends = [mesh.stage(t.contiguous()) for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    ops = []
    for s, rv in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, s, nxt, group))
        ops.append(dist.P2POp(dist.irecv, rv, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [mesh.unstage(rv, t) for rv, t in zip(recvs, tensors)]


def _ring_forward(mesh, causal, q, k, v, q_pos, seg):
    """One rotation of the ring: this rank's queries against every K/V
    block. Returns the output (B,Tl,H,D) in q's dtype and the per-row
    log-sum-exp (B,H,Tl)."""
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    cd, cdv = _contract_dtype(q), _contract_dtype(v)
    qh = _heads_major(q, cd)
    kb, vb = _heads_major(k, cd), _heads_major(v, cdv)
    kpos, kseg = q_pos, seg
    o = torch.zeros((B, H, T, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    for step in range(mesh.n_seq):
        scores = _tile_scores(qh, kb, q_pos, kpos, seg, kseg, scale, causal)
        o, m, l = _online_update(o, m, l, scores, vb)
        if step + 1 < mesh.n_seq:
            kb, vb, kpos, kseg = _rotate(mesh, [kb, vb, kpos, kseg])
    l = torch.clamp_min(l, 1e-30)
    lse = m + torch.log(l)
    out = (o / l[..., None]).transpose(1, 2).contiguous().to(q.dtype)
    return out, lse


class _Ring(torch.autograd.Function):
    """``tpu_rl``'s ``_ring_attention_vjp``: the forward keeps q, k, v, the
    output and the row log-sum-exp (all O(T / n_seq)); the backward is a
    second ring pass in which each K/V block travels with its dK/dV
    accumulators, and after ``n_seq`` hops every block is home with the
    contributions of every query shard."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, seg, mesh, causal):
        out, lse = _ring_forward(mesh, causal, q, k, v, q_pos, seg)
        ctx.save_for_backward(q, k, v, q_pos, seg, out, lse)
        ctx.mesh, ctx.causal = mesh, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, seg, out, lse = ctx.saved_tensors
        mesh, causal = ctx.mesh, ctx.causal
        D = q.shape[3]
        scale = 1.0 / math.sqrt(D)
        cd = _contract_dtype(q)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)  # (B, H, Tl)
        qh, doh = _heads_major(q, cd), _heads_major(do, cd)
        kb, vb = _heads_major(k, cd), _heads_major(v, cd)
        kpos, kseg = q_pos, seg
        dq = torch.zeros(qh.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(kb.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(vb.shape, dtype=torch.float32, device=q.device)
        n = mesh.n_seq
        for step in range(n):
            scores = _tile_scores(qh, kb, q_pos, kpos, seg, kseg, scale, causal)
            p = torch.where(scores <= _NEG_INF * 0.5, 0.0, torch.exp(scores - lse[..., None]))
            dv = dv + mm_f32(p.to(cd).transpose(-1, -2), doh)
            dp = mm_f32(doh, vb.transpose(-1, -2))
            ds = (p * (dp - delta[..., None]) * scale).to(cd)
            dq = dq + mm_f32(ds, kb)
            dk = dk + mm_f32(ds.transpose(-1, -2), qh)
            # the last hop brings each block and its accumulators home
            if step + 1 < n:
                kb, vb, kpos, kseg, dk, dv = _rotate(mesh, [kb, vb, kpos, kseg, dk, dv])
            else:
                dk, dv = _rotate(mesh, [dk, dv]) if n > 1 else (dk, dv)
        return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
                dv.transpose(1, 2).to(v.dtype), None, None, None, None)


def ring_attention(q, k, v, q_pos, seg, axis_name=SEQ_AXIS, causal=True, mesh=None):
    """Exact attention over a sequence split on ``mesh``'s seq group.

    Args (this rank's shard): q, k, v (B, Tl, H, D); q_pos (B, Tl) global
    positions of its rows; seg (B, Tl) global segment ids. Returns
    (B, Tl, H, D) in q's dtype."""
    if mesh is None:
        raise ValueError("ring_attention needs the rank mesh (make_sp_mesh)")
    return _Ring.apply(q, k, v, q_pos, seg, mesh, bool(causal))


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over the seq group along a leading chunk axis
    of ``n_seq``; its own inverse, so the backward is the same exchange."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_to_all(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(ctx.mesh, g), None


def _all_to_all(mesh, x: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    s = mesh.stage(x.contiguous())
    out = torch.empty_like(s)
    dist.all_to_all_single(out, s, group=mesh.groups[SEQ_AXIS])
    return mesh.unstage(out, x)


def ulysses_attention(q, k, v, q_pos, seg, axis_name=SEQ_AXIS, causal=True, mesh=None):
    """Exact attention by all-to-all head re-sharding (DeepSpeed-Ulysses);
    same contract as :func:`ring_attention`; needs ``H % n_seq == 0``."""
    if mesh is None:
        raise ValueError("ulysses_attention needs the rank mesh (make_sp_mesh)")
    n = mesh.n_seq
    B, Tl, H, D = q.shape
    if H % n:
        raise ValueError(f"ulysses needs n_heads ({H}) divisible by the seq axis ({n})")

    def to_heads(x):
        # (B, Tl, H, D) -> chunk j of the heads to seq rank j -> received
        # blocks in rank order = global sequence order: (B, n*Tl, H/n, D)
        xc = x.reshape(B, Tl, n, H // n, D).permute(2, 0, 1, 3, 4)
        y = _AllToAll.apply(xc, mesh)  # (n, B, Tl, H/n, D): y[j] from rank j
        return y.permute(1, 0, 2, 3, 4).reshape(B, n * Tl, H // n, D)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    pos_full = _all_gather_seq(q_pos, mesh)
    seg_full = _all_gather_seq(seg, mesh)
    oh = full_attention(qh, kh, vh, pos_full, seg_full, causal=causal)
    # back: (B, n*Tl, H/n, D) -> (B, Tl, H, D), the inverse exchange
    oc = oh.reshape(B, n, Tl, H // n, D).permute(1, 0, 2, 3, 4)
    y = _AllToAll.apply(oc, mesh)  # (n, B, Tl, H/n, D): head chunk j from rank j
    return y.permute(1, 2, 0, 3, 4).reshape(B, Tl, H, D)


def _all_gather_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """(B, Tl) -> (B, T) concatenated in ring order (no gradient)."""
    return mesh.all_gather(x, SEQ_AXIS, dim=1)


class _GatherSeq(torch.autograd.Function):
    """All-gather along dim 1 over the seq group, with the all-gather's
    adjoint: the cotangent summed over the group, this rank's slice kept
    (every seq rank computes the same loss on the gathered tensor, so each
    rank's tokens collect ``n_seq`` copies of their gradient, which the
    world mean of :meth:`~tpu_rl_torch.parallel.mesh.Mesh.grads` divides
    back out)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.tl = mesh, x.shape[1]
        return mesh.all_gather(x, SEQ_AXIS, dim=1)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous().clone()
        mesh.all_reduce_(g, axis=SEQ_AXIS)
        r = mesh.seq_index
        return g[:, r * ctx.tl:(r + 1) * ctx.tl], None


def gather_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """Per-token outputs (B, Tl, ...) of every seq rank -> (B, T, ...), with
    autograd: what the losses' scans over the whole window read."""
    return _GatherSeq.apply(x, mesh)


ATTENTION_IMPLS = {"full": full_attention, "flash": flash_attention,
                   "blockwise": blockwise_attention, "ring": ring_attention,
                   "ulysses": ulysses_attention}
