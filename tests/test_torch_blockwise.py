"""The port's blockwise attention (``tpu_rl_torch.parallel.sequence.
blockwise_attention``) on the CPU:

- against ``tpu_rl.parallel.sequence.blockwise_attention`` on the same
  seeded inputs (``tests/test_sequence_parallel.py``'s cases: T 48/50/53/32,
  block 16/512, three segments a row), the output and the value and
  gradients of a weighted loss (a sum, so the gradients are O(1) and the
  absolute bar bites): f32 at ``tpu_rl``'s bars (value rtol 2e-5; o and
  grads rtol and atol 2e-4); bf16 inputs (bf16 contraction operands, f32
  sums, each output cast to its input's dtype) with the value at rtol 2e-5
  and each output and gradient element within one bf16 ulp of itself,
  2^-7·|ref| + 2^-16·max|ref|;
- against the port's own ``full_attention``: f32 at the same bars; bf16
  against full attention in f32 on the same bf16 inputs, within two bf16
  ulps of each tensor's largest element (see the test);
- the transients of one forward and backward, recorded under a
  ``TorchDispatchMode``: no intermediate holds B·H·T² elements or more;
- the padding's rows (segment id -1) take no part in a real row's output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from tests.test_sequence_parallel import _inputs
from tpu_rl.parallel.sequence import blockwise_attention as jax_blockwise
from tpu_rl_torch.parallel.sequence import blockwise_attention, full_attention

CASES = [(48, 16), (50, 16), (53, 16), (32, 512)]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _case(T, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, pos, seg = (np.asarray(x) for x in _inputs(rng, B=2, T=T, H=4, D=8, n_segments=3))
    w = rng.normal(size=q.shape).astype(np.float32)
    return q, k, v, pos, seg, w


def _torch_value_and_grads(fn, q, k, v, pos, seg, w, dtype):
    tq, tk, tv = (torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v))
    o = fn(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(seg), causal=True)
    assert o.dtype == dtype and o.shape == tq.shape
    loss = (o * torch.from_numpy(w)).sum()
    loss.backward()
    return float(loss), [o.detach(), *(t.grad for t in (tq, tk, tv))]


def _assert_grads(got, want, dtype):
    """o and its q, k, v gradients."""
    for name, g, r in zip(("o", "dq", "dk", "dv"), got, want, strict=True):
        assert g.dtype == dtype, name
        g, r = g.float().numpy(), np.asarray(r, np.float32)
        if dtype == torch.float32:
            np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4, err_msg=name)
        else:
            bar = 2.0**-7 * np.abs(r) + 2.0**-16 * np.abs(r).max()
            assert (np.abs(g - r) <= bar).all(), f"{name}: {np.abs(g - r).max()}"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("T,block", CASES)
def test_matches_tpu_rl_blockwise(T, block, dtype):
    tdt, jdt = DTYPES[dtype]
    q, k, v, pos, seg, w = _case(T)

    def loss(q, k, v):
        o = jax_blockwise(q, k, v, jnp.asarray(pos), jnp.asarray(seg), causal=True, block=block)
        return (o * w).sum()

    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    want, jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    jo = jax_blockwise(jq, jk, jv, jnp.asarray(pos), jnp.asarray(seg), causal=True, block=block)
    got, grads = _torch_value_and_grads(
        lambda *a, **kw: blockwise_attention(*a, block=block, **kw), q, k, v, pos, seg, w, tdt)
    np.testing.assert_allclose(got, float(want), rtol=2e-5)
    _assert_grads(grads, [jo, *jgrads], tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("T,block", CASES)
def test_matches_full_attention(T, block, dtype):
    """f32: blockwise against full attention at tpu_rl's bars. bf16: the two
    round different values to bf16 (blockwise the unnormalised tile
    probabilities, full the softmax), so they are not one bf16 ulp apart
    element by element; each is held against full attention in f32 on the
    same bf16 inputs (the function both approximate), o and gradients within
    two bf16 ulps of each tensor's largest element, 2^-6·max|ref| (bf16 full attention
    itself uses up to ~0.6 of it on these cases)."""
    tdt, _ = DTYPES[dtype]
    q, k, v, pos, seg, w = _case(T, seed=1)
    if tdt == torch.bfloat16:
        q, k, v = (torch.tensor(x).to(tdt).float().numpy() for x in (q, k, v))
    want, want_grads = _torch_value_and_grads(full_attention, q, k, v, pos, seg, w, torch.float32)
    got, grads = _torch_value_and_grads(
        lambda *a, **kw: blockwise_attention(*a, block=block, **kw), q, k, v, pos, seg, w, tdt)
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=2e-5)
        _assert_grads(grads, [g.numpy() for g in want_grads], tdt)
        return
    for name, g, r in zip(("o", "dq", "dk", "dv"), grads, want_grads, strict=True):
        err = (g.float() - r).abs().max()
        assert err <= 2.0**-6 * r.abs().max(), f"{name}: {err} vs max {r.abs().max()}"


class _Largest(TorchDispatchMode):
    """Records the largest tensor any operator returns."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("fn", ["blockwise", "full"])
def test_no_intermediate_holds_the_scores(fn):
    """At T 256 with 64-row tiles, no operator of one blockwise forward and
    backward returns B·H·T² elements or more (a tile's scores are
    B·H·64²); full attention's scores do, which shows the mode sees them."""
    B, T, H, D = 2, 256, 4, 8
    q, k, v, pos, seg = (torch.from_numpy(np.asarray(x))
                         for x in _inputs(np.random.default_rng(3), B=B, T=T, H=H, D=D))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    attn = (lambda *a: blockwise_attention(*a, block=64)) if fn == "blockwise" else full_attention
    with _Largest() as mode:
        attn(q, k, v, pos, seg).square().sum().backward()
    if fn == "blockwise":
        assert mode.largest < B * H * T * T, mode.largest
        assert mode.largest == B * H * 64 * 64
    else:
        assert mode.largest >= B * H * T * T


def test_padding_rows_stay_out():
    """T 50 in 16-row tiles pads to 4 tiles of 13 with two rows of segment
    -1: the output equals full attention's on the 50 real rows, and the
    gradient comes back at T rows (the wrapper slices the padding's off)."""
    q, k, v, pos, seg, w = _case(50, seed=2)
    tq = torch.tensor(q).requires_grad_()
    o = blockwise_attention(tq, torch.tensor(k), torch.tensor(v), torch.from_numpy(pos),
                            torch.from_numpy(seg), block=16)
    (o * torch.from_numpy(w)).sum().backward()
    assert o.shape == tq.shape and tq.grad.shape == tq.shape
    full = full_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          torch.from_numpy(pos), torch.from_numpy(seg))
    np.testing.assert_allclose(o.detach().numpy(), full.numpy(), atol=1e-6)
