"""The one generator of training batches. A traffic mix is a JSON file of
parameters (``traffic/<name>.json``); the configuration gives the shapes.

A row of S steps is cut from a stream of episodes whose lengths are drawn
from ``episode_lengths``, a recorded histogram ``[[length, count], ...]``
(``portbench.record_episodes``), at an offset drawn uniformly from ``[0,
offset_episodes * longest episode)``: an episode starts at every step
``is_fir`` flags, wherever the cut puts it. The rest
of a row is drawn from the mix's parameters: observations ``obs_std *
N(0, 1)``; actions uniform; behaviour logits ``behaviour_logit_std *
N(0, 1)``, stored log-softmaxed, with the taken action's log-probability;
rewards ``reward_mean + reward_std * N(0, 1)``. An LSTM's stored carries
(h and c at the row's first step, ``carry_std * N(0, 1)``) are held once per
row, as a view over the row's steps: the learner reads the first step's
only. The transformer stores no carry (1-wide zeros).

Batch ``i`` of seed ``s`` is drawn on the device from its own generator, so
it is the same on every card and in every run. The pool holds as many distinct batches
as ``pool_mib`` allows (at least 4); the timed updates cycle through it.
"""

from __future__ import annotations

import math

import torch

FIELDS = ("obs", "act", "rew", "logits", "log_prob", "is_fir", "hx", "cx")


def batch_generator(seed: int, index: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + index) % (2**63 - 1))
    return g


def episode_firsts(B: int, S: int, mix: dict, g: torch.Generator, device) -> torch.Tensor:
    """(B, S) float32 0/1: where an episode starts in each row."""
    steps = [n for n, _ in mix["episode_lengths"]]
    counts = torch.tensor([c for _, c in mix["episode_lengths"]], dtype=torch.float32,
                          device=device)
    span = mix["offset_episodes"] * max(steps)
    K = math.ceil((span + S) / min(steps)) + 1
    pick = torch.multinomial(counts, B * K, replacement=True, generator=g)
    lengths = torch.tensor(steps, device=device)[pick].reshape(B, K)
    starts = torch.cumsum(lengths, 1) - lengths
    offset = torch.randint(0, span, (B, 1), generator=g, device=device)
    rel = starts - offset
    rel = torch.where((rel >= 0) & (rel < S), rel, S)
    firsts = torch.zeros((B, S + 1), device=device)
    firsts.scatter_(1, rel, 1.0)
    return firsts[:, :S].contiguous()


def make_batch(cfg: dict, mix: dict, seed: int, index: int, device) -> dict:
    """Batch ``index`` of ``cfg["batch_size"]`` rows: the fields of a
    training batch, (B, S, width) float32."""
    B, S = cfg["batch_size"], cfg["seq_len"]
    D, A = cfg["obs_shape"][0], cfg["action_space"]
    g = batch_generator(seed, index, device)
    f32 = dict(device=device, dtype=torch.float32)
    firsts = episode_firsts(B, S, mix, g, device)
    obs = mix["obs_std"] * torch.randn((B, S, D), generator=g, **f32)
    act = torch.randint(0, A, (B, S, 1), generator=g, device=device)
    logits = torch.log_softmax(
        mix["behaviour_logit_std"] * torch.randn((B, S, A), generator=g, **f32), dim=-1)
    rew = mix["reward_mean"] + mix["reward_std"] * torch.randn((B, S, 1), generator=g, **f32)
    width = cfg["hidden_size"] if cfg["model"] == "lstm" else 1
    if cfg["model"] == "lstm":
        h0, c0 = (mix["carry_std"] * torch.randn((B, 1, width), generator=g, **f32)
                  for _ in range(2))
    else:
        h0 = c0 = torch.zeros((B, 1, width), **f32)
    out = dict(obs=obs, act=act.float(), rew=rew, logits=logits,
               log_prob=logits.gather(-1, act), is_fir=firsts[..., None], hx=h0, cx=c0)
    out["hx"] = out["hx"].expand(-1, S, -1)
    out["cx"] = out["cx"].expand(-1, S, -1)
    return out


def batch_bytes(batch: dict) -> int:
    """Bytes the batch holds (a view over a row's steps counted once)."""
    return sum(v.untyped_storage().nbytes() for v in batch.values())


def pool_size(first: dict, mix: dict) -> int:
    return max(4, int(mix["pool_mib"] * 2**20) // batch_bytes(first))


def mean_length(mix: dict) -> float:
    """The mean episode length of the mix's histogram."""
    total = sum(c for _, c in mix["episode_lengths"])
    return sum(n * c for n, c in mix["episode_lengths"]) / total


def seams(firsts: torch.Tensor) -> torch.Tensor:
    """Episode starts inside each row, after its first step: (B,)."""
    return firsts[:, 1:].sum(1)
