"""Episode lengths of the repo's CartPole-v1 under the port's own rollout,
recorded over a PPO training run, for the traffic mixes' ``episode_lengths``.

    python3 -m portbench.record_episodes --horizon 500 --updates 3000 --out rec.json
    python3 -m portbench.record_episodes --histogram rec.json --from-update 0 --to-update 1

The run is ``tpu_rl_torch.runtime.colocated.ColocatedLoop`` on the CPU with
the recipe of ``examples/colocated_smoke.py`` (PPO, 32 envs, windows of 5
steps, lr 3e-4, entropy 1e-3, reward scale 0.1) and the given
``time_horizon``; each update's rollout and train step are the loop's own
(``ColocatedLoop.program``, split to read the rollout's ``done``). An
episode's length counts its steps, the terminating or truncated one
included. The recording is one JSON object: the settings, and ``episodes``,
a list of ``[update, length]`` in the order the episodes ended.

``--histogram`` reduces a recording to ``[[length, count], ...]`` over the
episodes that ended in updates ``[from, to)``, the form the mixes hold.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter

RECIPE = dict(env="CartPole-v1", env_mode="colocated", algo="PPO", batch_size=32,
              buffer_size=32, seq_len=5, lr=3e-4, entropy_coef=0.001, reward_scale=0.1,
              loss_log_interval=10**9)


def record(horizon: int, updates: int, seed: int) -> dict:
    import torch

    from tpu_rl_torch.config import Config
    from tpu_rl_torch.runtime.colocated import ColocatedLoop, act_params

    torch.set_num_threads(1)
    cfg = Config(**RECIPE, time_horizon=horizon)
    loop = ColocatedLoop(cfg, seed=seed, max_updates=updates, device="cpu")
    state, carry, gen = loop.state, loop.init_carry(), loop.generator
    running = torch.zeros(cfg.batch_size, dtype=torch.long)
    episodes = []
    t0 = time.time()
    for it in range(updates):
        carry, batch, done, _ = loop.rollout(act_params(state), carry, gen)
        state, _ = loop.train_step(state, batch, generator=gen)
        for t in range(cfg.seq_len):
            running += 1
            ended = done[:, t].reshape(-1).bool()
            episodes += [[it, int(n)] for n in running[ended]]
            running[ended] = 0
        if (it + 1) % 500 == 0:
            recent = [n for u, n in episodes if u > it - 500]
            print(f"update {it + 1}: {len(episodes)} episodes, mean length of the last 500 "
                  f"updates' {sum(recent) / max(1, len(recent)):.1f}, {time.time() - t0:.0f} s",
                  file=sys.stderr, flush=True)
    return {"recipe": dict(RECIPE, time_horizon=horizon), "seed": seed, "updates": updates,
            "episodes": episodes}


def histogram(rec: dict, start: int, stop: int) -> list[list[int]]:
    counts = Counter(n for u, n in rec["episodes"] if start <= u < stop)
    return [[n, counts[n]] for n in sorted(counts)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.record_episodes")
    p.add_argument("--horizon", type=int, default=500)
    p.add_argument("--updates", type=int, default=3000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out")
    p.add_argument("--histogram")
    p.add_argument("--from-update", type=int, default=0)
    p.add_argument("--to-update", type=int, default=None)
    args = p.parse_args(argv)
    if args.histogram:
        with open(args.histogram) as f:
            rec = json.load(f)
        stop = rec["updates"] if args.to_update is None else args.to_update
        print(json.dumps(histogram(rec, args.from_update, stop)))
        return 0
    rec = record(args.horizon, args.updates, args.seed)
    with open(args.out, "w") as f:
        json.dump(rec, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
