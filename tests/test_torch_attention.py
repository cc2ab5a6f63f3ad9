"""The port's attention (``tpu_rl_torch.parallel.sequence`` and kernel B4's
plain versions in ``tpu_rl_torch.ops.attention``) against ``tpu_rl``'s on
the CPU, from the same numpy inputs.

- ``segment_ids_from_firsts`` exactly;
- ``full_attention`` forward and gradients against ``jax.grad``: f32 at
  1e-5 / 3e-5; bf16 within one bf16 ulp of the largest reference entry
  forward (2**-7 * max|ref|) and two on gradients, for the rounding of the
  bf16 probabilities and cotangents at another sum order;
- B4's plain forward (o and lse) and backward against ``tpu_rl``'s
  ``full_attention`` with segment-relative positions and its ``jax.grad``,
  f32 at 1e-5 / 3e-5: the index-causal contract of the kernel equals the
  position contract;
- ``flash_attention`` (the autograd Function, CPU path) against ``tpu_rl``'s
  ``flash_attention_tpu``, which takes ``full_attention`` off the TPU;
- the bf16 kernels' tile-skip rule (``visited_tiles``) against the dense
  mask, their launch plan, and the wrappers' checks;
- a torch emulation of the bf16 kernels' arithmetic (online softmax over
  64-key tiles, P and dS fed to the products as hi/lo bf16 pairs, f32
  accumulation) against the plain versions at ``chip_smoke.attn_check``'s
  per-element bar.

Shapes have B, H > 1, several segments per row and ragged T."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_rl.parallel import sequence as JS
from tpu_rl_torch.ops import attention as A
from tpu_rl_torch.parallel import sequence as S

FWD_ATOL, GRAD_ATOL = 1e-5, 3e-5
BF16_ULP = 2.0**-7  # bf16 spacing at 1.0
SHAPES = [(2, 37, 3, 8), (3, 64, 2, 16), (2, 100, 4, 32)]


def _firsts(B, T, rng, seams_per_row=4):
    firsts = (rng.random((B, T, 1)) < seams_per_row / T).astype(np.float32)
    firsts[:, 0] = 1.0
    firsts[0, T // 2] = 1.0
    return firsts


def _relative_pos(firsts):
    T = firsts.shape[1]
    idx = np.broadcast_to(np.arange(T, dtype=np.int32), firsts.shape[:2])
    return (idx - np.maximum.accumulate(np.where(firsts[..., 0] > 0, idx, 0), axis=1)).astype(np.int32)


def _inputs(shape, seed):
    B, T, H, D = shape
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    firsts = _firsts(B, T, rng)
    return q, k, v, do, firsts


def _t(*arrays, dtype=torch.float32, grad=False):
    return [torch.from_numpy(np.asarray(a)).to(dtype).requires_grad_(grad) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _close(got, want, atol, what):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(jnp.asarray(want).astype(jnp.float32)),
        atol=atol, rtol=0, err_msg=what,
    )


def _jax_grads(fn, q, k, v, do):
    _o, vjp = jax.vjp(fn, q, k, v)
    return vjp(do.astype(q.dtype))


@pytest.mark.parametrize("shape", [(2, 9), (4, 50)])
def test_segment_ids_match(shape):
    firsts = _firsts(*shape, np.random.default_rng(0))
    got = S.segment_ids_from_firsts(torch.from_numpy(firsts))
    want = JS.segment_ids_from_firsts(jnp.asarray(firsts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_full_attention_matches(shape, dtype):
    """Forward and gradients of full_attention with the mixed-precision rule
    against tpu_rl's, with position-plus-segment masks."""
    q, k, v, do, firsts = _inputs(shape, 1)
    pos, seg = _relative_pos(firsts), np.array(JS.segment_ids_from_firsts(jnp.asarray(firsts)))
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    jq, jk, jv = _j(q, k, v, dtype=jdt)
    fn = lambda a, b, c: JS.full_attention(a, b, c, jnp.asarray(pos), jnp.asarray(seg))  # noqa: E731
    want = fn(jq, jk, jv)
    wgrads = _jax_grads(fn, jq, jk, jv, jnp.asarray(do))
    tq, tk, tv = _t(q, k, v, dtype=tdt, grad=True)
    got = S.full_attention(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(seg))
    assert got.dtype == tdt and got.shape == shape
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do).to(tdt))
    if dtype == "float32":
        fwd_tol = FWD_ATOL
        grad_tols = [GRAD_ATOL] * 3
    else:
        fwd_tol = BF16_ULP * float(jnp.abs(want.astype(jnp.float32)).max())
        grad_tols = [2 * BF16_ULP * float(jnp.abs(w.astype(jnp.float32)).max()) for w in wgrads]
    _close(got, want, fwd_tol, "o")
    for g, w, tol, name in zip(grads, wgrads, grad_tols, ("dq", "dk", "dv"), strict=True):
        assert g.dtype == tdt
        _close(g, w, tol, name)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_b4_matches_tpu_rl_full_attention(shape):
    """B4's contract (causal by index, plus segment ids) against tpu_rl's
    full_attention with segment-relative positions: o, the row log-sum-exp
    and all three gradients, f32."""
    q, k, v, do, firsts = _inputs(shape, 2)
    pos, seg = _relative_pos(firsts), np.array(JS.segment_ids_from_firsts(jnp.asarray(firsts)))
    jq, jk, jv = _j(q, k, v)
    jpos, jseg = jnp.asarray(pos), jnp.asarray(seg)
    fn = lambda a, b, c: JS.full_attention(a, b, c, jpos, jseg)  # noqa: E731
    want = fn(jq, jk, jv)
    wgrads = _jax_grads(fn, jq, jk, jv, jnp.asarray(do))
    scores = JS._masked_block_scores(jq, jk, jpos, jpos, jseg, jseg, 1.0 / np.sqrt(shape[-1]), True)
    want_lse = jax.nn.logsumexp(scores, axis=-1)

    tq, tk, tv, tdo = _t(q, k, v, do)
    tseg = torch.from_numpy(seg)
    o, lse = A.flash_attention_forward_plain(tq, tk, tv, tseg)
    assert lse.shape == (shape[0], shape[2], shape[1]) and lse.dtype == torch.float32
    _close(o, want, FWD_ATOL, "o")
    _close(lse, want_lse, FWD_ATOL, "lse")
    grads = A.flash_attention_backward_plain(tq, tk, tv, tseg, o, lse, tdo)
    for g, w, name in zip(grads, wgrads, ("dq", "dk", "dv"), strict=True):
        _close(g, w, GRAD_ATOL, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attention_matches_tpu_rl_flash(shape, dtype):
    """The port's flash_attention (autograd Function over B4's CPU path)
    against tpu_rl's flash_attention_tpu (full_attention off the TPU), in
    f32 at 1e-5 / 3e-5 and in bf16 at the bf16 tolerances above. The
    positions handed in are segment-relative, as the transformer makes
    them; B4 ignores them."""
    q, k, v, do, firsts = _inputs(shape, 3)
    pos, seg = _relative_pos(firsts), np.array(JS.segment_ids_from_firsts(jnp.asarray(firsts)))
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    jq, jk, jv = _j(q, k, v, dtype=jdt)
    fn = lambda a, b, c: JS.flash_attention_tpu(a, b, c, jnp.asarray(pos), jnp.asarray(seg))  # noqa: E731
    want = fn(jq, jk, jv)
    wgrads = _jax_grads(fn, jq, jk, jv, jnp.asarray(do))
    tq, tk, tv = _t(q, k, v, dtype=tdt, grad=True)
    # int64 segment ids, as torch.cumsum gives them: the wrapper casts
    got = S.flash_attention(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(seg).long())
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do).to(tdt))
    if dtype == "float32":
        fwd_tol, grad_tols = FWD_ATOL, [GRAD_ATOL] * 3
    else:
        fwd_tol = BF16_ULP * float(jnp.abs(want.astype(jnp.float32)).max())
        grad_tols = [2 * BF16_ULP * float(jnp.abs(w.astype(jnp.float32)).max()) for w in wgrads]
    assert got.dtype == tdt
    _close(got, want, fwd_tol, "o")
    for g, w, tol, name in zip(grads, wgrads, grad_tols, ("dq", "dk", "dv"), strict=True):
        _close(g, w, tol, name)


def test_plain_versions_chunk_over_the_batch(monkeypatch):
    """The plain versions give the same result when the batch goes through
    in chunks (as they do at the main path's size)."""
    q, k, v, do, firsts = _inputs((5, 20, 2, 8), 4)
    tq, tk, tv, tdo = _t(q, k, v, do)
    seg = S.segment_ids_from_firsts(torch.from_numpy(firsts))
    whole = A.flash_attention_forward_plain(tq, tk, tv, seg)
    gwhole = A.flash_attention_backward_plain(tq, tk, tv, seg, *whole, tdo)
    monkeypatch.setattr(A, "_PLAIN_CHUNK", 2 * 2 * 20 * 20)  # two rows per chunk
    assert len(A._chunks(5, 2, 20)) == 3
    parts = A.flash_attention_forward_plain(tq, tk, tv, seg)
    gparts = A.flash_attention_backward_plain(tq, tk, tv, seg, *parts, tdo)
    for x, y in zip((*whole, *gwhole), (*parts, *gparts), strict=True):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises; the
    plain version is never taken for it, and CPU calls count no launch."""
    f0, b0 = A.FLASH_FWD_LAUNCHES, A.FLASH_BWD_LAUNCHES
    q, k, v, do, firsts = _inputs((2, 16, 2, 8), 5)
    meta = [torch.from_numpy(a).to("meta") for a in (q, k, v, do)]
    seg = torch.zeros((2, 16), dtype=torch.int32, device="meta")
    lse = torch.zeros((2, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        A.flash_fwd(meta[0], meta[1], meta[2], seg)
    with pytest.raises(ValueError, match="unsupported device"):
        A.flash_bwd(meta[0], meta[1], meta[2], seg, meta[0], lse, meta[3])
    # the bf16 path (the tensor-core kernels) raises the same way
    mb = [t.to(torch.bfloat16) for t in meta]
    with pytest.raises(ValueError, match="unsupported device"):
        A.flash_fwd(mb[0], mb[1], mb[2], seg)
    with pytest.raises(ValueError, match="unsupported device"):
        A.flash_bwd(mb[0], mb[1], mb[2], seg, mb[0], lse, mb[3])
    tq, tk, tv = _t(q, k, v, grad=True)
    S.flash_attention(tq, tk, tv, None, S.segment_ids_from_firsts(torch.from_numpy(firsts))).sum().backward()
    assert (A.FLASH_FWD_LAUNCHES, A.FLASH_BWD_LAUNCHES) == (f0, b0)


@pytest.mark.parametrize("D, dtype, match", [
    (128, torch.float32, "built for D in"), (16, torch.float32, "built for D in"),
    (32, torch.float16, "float32 or bfloat16"),
])
def test_kernel_checks_refuse_what_it_was_not_built_for(D, dtype, match):
    """The kernels are built for D in {32, 64} and float32/bfloat16 loads;
    the wrappers' checks raise for anything else before a launch."""
    q = torch.zeros((2, 8, 2, D), dtype=dtype)
    seg = torch.ones((2, 8), dtype=torch.int32)
    with pytest.raises((ValueError, TypeError), match=match):
        A._check("flash_fwd", q, q, q, seg, {})


def test_flash_attention_is_causal_only():
    q = torch.zeros((1, 4, 1, 8))
    with pytest.raises(NotImplementedError, match="causal only"):
        S.flash_attention(q, q, q, None, torch.zeros((1, 4), dtype=torch.int32), causal=False)
    assert set(S.ATTENTION_IMPLS) == {"full", "flash"}


# ------------------------------------------------- the bf16 kernels' tile rule
def _segments(kind, B, T, rng):
    if kind == "one":
        return np.ones((B, T), np.int32)
    ids = np.cumsum(_firsts(B, T, rng, seams_per_row=6)[..., 0], axis=1).astype(np.int32)
    if kind == "shuffled":  # segments interleave; ids not monotone
        ids = np.stack([rng.permutation(row) for row in ids])
    return ids


@pytest.mark.parametrize("tiles", [(64, 64), (128, 64)])
@pytest.mark.parametrize("T", [256, 200])
@pytest.mark.parametrize("kind", ["cumsum", "shuffled", "one"])
def test_tile_skip_rule_visits_every_visible_pair(kind, T, tiles):
    """visited_tiles (the kernels' skip rule, at their 64-row tiles and at
    unequal query/key tiles) visits every tile pair that holds a pair the
    dense mask keeps, never one wholly above the diagonal, and, for the
    monotone ids of segment_ids_from_firsts, nothing else."""
    q_tile, k_tile = tiles
    seg = torch.from_numpy(_segments(kind, 3, T, np.random.default_rng(T)))
    visited = A.visited_tiles(A.tile_ranges(seg, q_tile), A.tile_ranges(seg, k_tile), q_tile, k_tile)
    nq, nk = -(-T // q_tile), -(-T // k_tile)
    assert visited.shape == (3, nq, nk)
    dense = torch.zeros((3, nq * q_tile, nk * k_tile), dtype=torch.bool)
    dense[:, :T, :T] = A._visible(seg)[:, 0]
    holds = dense.reshape(3, nq, q_tile, nk, k_tile).any(4).any(2)
    assert bool((holds & ~visited).sum() == 0), "a tile pair with a visible element is skipped"
    qi, kj = torch.arange(nq)[:, None], torch.arange(nk)[None, :]
    assert not bool((visited & (kj * k_tile > qi * q_tile + q_tile - 1)).any()), "above the diagonal"
    if kind != "shuffled":
        assert torch.equal(visited, holds)
    else:
        assert int(visited.sum()) >= int(holds.sum())


def test_tile_plan_orders_the_most_visited_tiles_first():
    """tile_plan: int32 per-tile ranges and, for query tiles and key tiles,
    a permutation of every (batch row, tile) sorted by visited tiles, most
    first (stable)."""
    seg = torch.from_numpy(_segments("cumsum", 3, 1000, np.random.default_rng(3)))
    plan = A.tile_plan(seg)
    n = -(-1000 // A.TILE)
    visited = A.visited_tiles((plan.tile_min, plan.tile_max), (plan.tile_min, plan.tile_max))
    assert plan.tile_min.dtype == torch.int32 and plan.tile_min.shape == (3, n)
    for order, counts in ((plan.order_q, visited.sum(2)), (plan.order_k, visited.sum(1))):
        assert order.dtype == torch.int32 and order.shape == (3 * n,)
        assert sorted(order.tolist()) == list(range(3 * n))
        c = counts.flatten()[order.long()]
        assert bool((c[:-1] >= c[1:]).all())
    assert int(visited.sum()) < 3 * n * (n + 1) // 2  # seams skip tiles


def _strided_bf16(W, offset, B=2, T=8, H=2, D=32):
    buf = torch.zeros((B, T, W), dtype=torch.bfloat16)
    q, k, v = (buf[:, :, offset + i * H * D: offset + (i + 1) * H * D].unflatten(2, (H, D))
               for i in range(3))
    return q, k, v, torch.ones((B, T), dtype=torch.int32)


@pytest.mark.parametrize("W, offset, match", [
    (3 * 64 + 4, 0, "multiples of 8 elements"),    # rows 2 * 196 bytes apart
    (3 * 64 + 8, 1, "16-byte boundary"),            # q, k, v start 2 bytes in
])
def test_bf16_checks_refuse_what_cp_async_cannot_copy(W, offset, match):
    """The tensor-core kernels copy 16-byte pieces: the wrappers' check
    refuses bf16 views whose rows or starts are not 16-byte aligned, with
    a message that says so; float32 views of the same layout pass."""
    q, k, v, seg = _strided_bf16(W, offset)
    with pytest.raises(ValueError, match=match):
        A._check("flash_fwd", q, k, v, seg, {})
    A._check("flash_fwd", *(t.float() if t.dtype == torch.bfloat16 else t for t in (q, k, v)), seg, {})
    aligned = _strided_bf16(3 * 64, 0)
    assert A._check("flash_fwd", *aligned, {}) == (2, 8, 2, 32)


# --------------------------------------- the bf16 kernels' arithmetic, emulated
_LOG2E, _LN2 = 1.0 / math.log(2.0), math.log(2.0)


def _product(a, b, split):
    """a @ b with a rounded to bf16 as the kernels feed it: hi + lo (two
    products into one f32 sum) or, with split=False, one rounding."""
    hi = a.to(torch.bfloat16).float()
    out = hi @ b
    return out + (a - hi).to(torch.bfloat16).float() @ b if split else out


def _emulated_forward(q, k, v, seg, split=True):
    """flash_attn_tc_fwd.cu's arithmetic: online softmax in log2 units over
    64-key tiles, P fed to the PV product as hi/lo bf16, f32 accumulation."""
    B, T, H, D = q.shape
    sl = _LOG2E / math.sqrt(D)
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    vis = A._visible(seg)
    m = torch.full((B, H, T), -1e30)
    l, acc = torch.zeros((B, H, T)), torch.zeros((B, H, T, D))
    for k0 in range(0, T, A.TILE):
        keep = vis[..., k0:k0 + A.TILE]
        s = torch.where(keep, qf @ kf[:, :, k0:k0 + A.TILE].transpose(-1, -2), -1e30)
        mn = torch.maximum(m, s.amax(-1) * sl)
        alpha = torch.exp2(m - mn)
        p = torch.where(keep, torch.exp2(s * sl - mn[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _product(p, vf[:, :, k0:k0 + A.TILE], split)
        m = mn
    l = l.clamp_min(1e-30)
    return (acc / l[..., None]).transpose(1, 2).to(q.dtype), (m + torch.log2(l)) * _LN2


def _emulated_backward(q, k, v, seg, o, lse, do, split=True):
    """flash_attn_tc_bwd.cu's arithmetic: delta, P and dS recomputed in f32
    from exact bf16 products, fed to the dV, dK and dQ products as hi/lo
    bf16, f32 accumulation."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, of, dof = (x.float().transpose(1, 2) for x in (q, k, v, o, do))
    delta = (dof * of).sum(-1)
    s = qf @ kf.transpose(-1, -2)
    p = torch.where(A._visible(seg), torch.exp2(s * (scale * _LOG2E) - lse[..., None] * _LOG2E), 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None]) * scale
    grads = (_product(ds, kf, split), _product(ds.transpose(-1, -2), qf, split),
             _product(p.transpose(-1, -2), dof, split))
    return tuple(g.transpose(1, 2).to(q.dtype) for g in grads)


def _bar_shares(split):
    q, k, v, seg, do = chip_smoke.attn_inputs(2, 512, 2, 64, torch.bfloat16, 6, 7, device="cpu")
    o, lse = _emulated_forward(q, k, v, seg, split)
    o_p, lse_p = A.flash_attention_forward_plain(q, k, v, seg)
    grads = _emulated_backward(q, k, v, seg, o, lse, do, split)
    grads_p = A.flash_attention_backward_plain(q, k, v, seg, o, lse, do)
    checks = chip_smoke.attn_check(
        dict(o=o, lse=lse, dq=grads[0], dk=grads[1], dv=grads[2]),
        dict(o=o_p, lse=lse_p, dq=grads_p[0], dk=grads_p[1], dv=grads_p[2]), torch.bfloat16,
    )
    return {n: c["used"] for n, c in checks.items()}


@pytest.mark.parametrize("split", [True, False], ids=["hi-lo", "one-rounding"])
def test_kernel_precision_plan_holds_the_per_element_bar(split):
    """At (2,512,2,64) bf16 with ~6 seams per row, the kernels' arithmetic
    with P and dS as hi/lo bf16 pairs passes chip_smoke.attn_check's
    unchanged per-element bar (2^-7|ref| + 2^-16 max|ref|, used <= 1) on o,
    dq, dk and dv; one bf16 rounding of P and dS would use many times it
    (printed: the share of the bar each output uses)."""
    used = _bar_shares(split)
    print(f"share of the bf16 bar used, {'hi/lo' if split else 'one rounding'}: {used}")
    assert used["lse"] <= 1.0
    worst = max(used[n] for n in ("o", "dq", "dk", "dv"))
    if split:
        assert worst <= 1.0
    else:
        assert min(used[n] for n in ("o", "dq", "dk", "dv")) > 2.0 and worst > 10.0
