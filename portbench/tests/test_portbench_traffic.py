"""The generator: the same seed gives the same batches, and the episodes'
seams follow the mixes' recorded episode lengths."""

import json

import pytest
import torch

from portbench.spec import load_traffic
from portbench.traffic import episode_firsts, make_batch, mean_length, pool_size, seams
from portbench.tests.conftest import PORTBENCH

LSTM = dict(model="lstm", batch_size=16, seq_len=16, hidden_size=8, obs_shape=[4],
            action_space=3)
TF = dict(LSTM, model="transformer", seq_len=64)


@pytest.mark.parametrize("cfg", [LSTM, TF], ids=["lstm", "transformer"])
def test_a_seed_gives_the_same_batches(cfg):
    mix = load_traffic("cartpole-episodes")
    a = make_batch(cfg, mix, 2**31 + 5, 3, "cpu")
    b = make_batch(cfg, mix, 2**31 + 5, 3, "cpu")
    c = make_batch(cfg, mix, 2**31 + 5, 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["obs"], c["obs"])
    assert a["hx"].shape == (16, cfg["seq_len"], 8 if cfg["model"] == "lstm" else 1)
    # the stored carry is the row's first step's, on every step
    assert torch.equal(a["hx"][:, 0], a["hx"][:, -1])


def test_behaviour_log_probs_are_the_taken_actions():
    b = make_batch(LSTM, load_traffic("cartpole-episodes"), 1, 0, "cpu")
    assert torch.allclose(b["logits"].exp().sum(-1), torch.ones(16, 16))
    assert torch.equal(b["log_prob"], b["logits"].gather(-1, b["act"].long()))


@pytest.mark.parametrize("name,S", [
    ("long-episodes", 2048), ("short-episodes", 2048), ("cartpole-episodes", 16)])
def test_seams_follow_the_episode_lengths(name, S):
    mix = json.loads((PORTBENCH / "traffic" / f"{name}.json").read_text())
    want = (S - 1) / mean_length(mix)  # a cut at a uniform time meets an episode start so often
    rows = 20000 if S == 16 else 4000
    f = episode_firsts(rows, S, mix, torch.Generator().manual_seed(3), "cpu")
    mean = float(seams(f).mean())
    assert abs(mean - want) < 0.05 * want + 0.01, (mean, want)
    # inside a row, two seams are one recorded episode apart
    r, t = torch.nonzero(f, as_tuple=True)
    same = r[1:] == r[:-1]
    gaps = set((t[1:] - t[:-1])[same].tolist())
    assert gaps <= {n for n, _ in mix["episode_lengths"]}


def test_episode_lengths_are_drawn_as_recorded():
    mix = dict(load_traffic("cartpole-episodes"), episode_lengths=[[10, 3], [40, 1]],
               offset_episodes=1)
    S = 2000
    f = episode_firsts(2000, S, mix, torch.Generator().manual_seed(5), "cpu")
    r, t = torch.nonzero(f, as_tuple=True)
    same = r[1:] == r[:-1]
    gaps = (t[1:] - t[:-1])[same]
    # episodes of 10 steps are three times as many as those of 40; a row holds
    # a whole episode of L steps at S - 1 - L starts
    want = 3.0 * (S - 1 - 10) / (S - 1 - 40)
    assert abs(float((gaps == 10).sum() / (gaps == 40).sum()) - want) < 0.05


def test_the_pool_holds_distinct_batches():
    mix = dict(load_traffic("long-episodes"), pool_mib=1)
    first = make_batch(TF, mix, 0, 0, "cpu")
    assert pool_size(first, mix) >= 4
    assert pool_size(first, dict(mix, pool_mib=0)) == 4
