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
  ``flash_attention_tpu``, which takes ``full_attention`` off the TPU.

Shapes have B, H > 1, several segments per row and ragged T."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
