"""The FLOP and byte counts against counts made by hand."""

import torch

from portbench.counts import attention_pairs, b4_work, b12_work, least_s, model_flops


def test_attention_pairs_by_hand():
    # one row, episodes of 3 and 2 steps: 6 + 3 pairs; a row with no start
    # inside: one piece of 4 steps, 10 pairs
    f = torch.tensor([[1, 0, 0, 1, 0], [0, 0, 0, 0, 0]], dtype=torch.float32)
    assert attention_pairs(f[:1]) == 9
    assert attention_pairs(f[1:, :4]) == 10
    assert attention_pairs(f) == 9 + 15


def test_b4_work_by_hand():
    w = b4_work(B=1, T=2, H=1, D=2, pairs=3)
    assert w["fwd"]["flops"] == 4 * 2 * 3 and w["bwd"]["flops"] == 8 * 2 * 3
    n = 1 * 2 * 1 * 2 * 4  # one q-sized tensor, bytes
    assert w["fwd"]["bytes"] == 4 * n + 4 * 2 + 4 * 2
    assert w["bwd"]["bytes"] == 8 * n + 4 * 2 + 4 * 2


def test_b12_work_by_hand():
    w = b12_work(B=2, S=3, H=1)
    assert w["fwd"]["flops"] == w["bwd"]["flops"] == 2 * 2 * 3 * 1 * 4
    xp, wh, carry, keep, seq = 2 * 3 * 4, 4, 4, 6, 12
    assert w["fwd"]["bytes"] == 4 * (xp + wh + carry + keep + seq)
    assert w["bwd"]["bytes"] == 4 * (2 * xp + wh + 2 * carry + keep + seq)


def test_least_time_is_the_larger_bound():
    assert least_s({"flops": 10, "bytes": 1}, 5.0, 1.0) == 2.0
    assert least_s({"flops": 1, "bytes": 10}, 5.0, 1.0) == 10.0


def test_model_flops_by_hand():
    f = torch.tensor([[1.0, 0.0, 0.0]])
    lstm = dict(model="lstm", obs_shape=[2], action_space=3, hidden_size=1)
    # weights: body 2, x_proj 4, recurrent 4, heads 3 + 1 -> 14, x 6 a weight a token, 3 tokens
    assert model_flops(lstm, {}, f) == 6 * 14 * 3
    tf = dict(model="transformer", obs_shape=[2], action_space=3, hidden_size=2, n_layers=1)
    weights = 2 * 2 + (4 * 4 + 2 * 2 * 8) + 2 * 4
    assert model_flops(tf, {"ff_mult": 4}, f) == 6 * weights * 3 + 12 * 2 * 6
