#!/usr/bin/env python3
"""Where the Sebulba split's time goes when both lanes share one card.

    python3 lab/sebulba_lab.py        # on the card, from the repository root
    python3 lab/sebulba_lab.py loop   # the whole loop, four runs in one process

At the default config (PPO, CartPole-v1, H 64, S 5, 128 envs), ROUNDS
rounds of N calls each, every line the median ms per call over the rounds
(host clock, a synchronize closing each round):

- ``rollout alone`` / ``train step alone``: each lane's work on one thread,
  on a stream of its own;
- ``both in turns``: a rollout then a train step on one thread (the
  colocated loop's order);
- ``both in two threads``: the split's shape without its queue, each lane
  on its own thread and stream, N calls each, started together: each
  lane's ms per call and the pair's wall;
- ``train step beside a Python loop``: the train step on this thread while
  a second thread spins in pure Python (no torch call): what sharing the
  interpreter lock alone costs the train step;
- ``train step beside a thread of tiny torch ops``: the same, the second
  thread calling ``torch.add`` on one-element CPU tensors (each op releases
  and retakes the lock).

The train step runs on one fixed batch from the same state each call (its
result is dropped), so only the host and device work are timed.

``loop``: ``SebulbaLoop`` itself (the test seam's ``["cuda:0", "cuda:0"]``,
split 1, queue 2, LOOP_UPDATES updates) run four times in one fresh
process, in the order: telemetry off, on, off, on (``result_dir`` arms the
ledgers), with ``record_batches`` off: each run's updates/s and, with the
ledgers, each lane's compute ms an update; whether the first run in a
process is the slow one.
"""

from __future__ import annotations

import statistics
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

N, ROUNDS = 20, 5
LOOP_UPDATES = 200


def main() -> None:
    import torch

    from tpu_rl_torch.config import Config
    from tpu_rl_torch.kernels import build
    from tpu_rl_torch.models.families import build_family
    from tpu_rl_torch.runtime.colocated import ColocatedLoop, act_params

    card = torch.cuda.get_device_name(0)
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = Config(env="CartPole-v1", env_mode="colocated", algo="PPO", colocated_envs=128)
    loop = ColocatedLoop(cfg, seed=0, device="cuda")
    dev = loop.device
    actor_family = build_family(loop.cfg, device=dev)
    state = loop.state
    params = {"actor": {k: v.clone() for k, v in act_params(state)["actor"].items()}}
    gen_a = torch.Generator(dev).manual_seed(1)
    gen_l = torch.Generator(dev).manual_seed(2)
    carry = [loop.init_carry(torch.Generator(dev).manual_seed(3))]
    _c, batch, _d, _r = loop.rollout(params, carry[0], gen_a)
    s_act, s_learn = torch.cuda.Stream(dev), torch.cuda.Stream(dev)

    def rollout(n: int) -> None:
        with torch.cuda.device(dev), torch.cuda.stream(s_act):
            for _ in range(n):
                carry[0], _b, _d, _r = loop.rollout(params, carry[0], gen_a, actor_family)
            s_act.synchronize()

    def train(n: int) -> None:
        with torch.cuda.device(dev), torch.cuda.stream(s_learn):
            for _ in range(n):
                loop.train_step(state, batch, gen_l)
            s_learn.synchronize()

    def timed(fn, *args) -> float:
        t0 = time.perf_counter()
        fn(*args)
        return (time.perf_counter() - t0) * 1e3

    def rounds(fn) -> float:
        fn()  # warm-up
        return statistics.median(fn() for _ in range(ROUNDS))

    out = {}
    out["rollout alone"] = rounds(lambda: timed(rollout, N) / N)
    out["train step alone"] = rounds(lambda: timed(train, N) / N)
    out["both in turns"] = rounds(lambda: timed(lambda: [(rollout(1), train(1))
                                                         for _ in range(N)]) / N)

    def two_threads() -> tuple[float, float, float]:
        lanes = {}

        def lane(name, fn):
            lanes[name] = timed(fn, N) / N

        ts = [threading.Thread(target=lane, args=("actor", rollout)),
              threading.Thread(target=lane, args=("learner", train))]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return lanes["actor"], lanes["learner"], (time.perf_counter() - t0) * 1e3 / N

    two_threads()
    runs = [two_threads() for _ in range(ROUNDS)]
    out["both in two threads: actor ms a rollout"] = statistics.median(r[0] for r in runs)
    out["both in two threads: learner ms a train step"] = statistics.median(r[1] for r in runs)
    out["both in two threads: wall ms a pair"] = statistics.median(r[2] for r in runs)

    def beside(spin) -> float:
        stop = threading.Event()
        t = threading.Thread(target=spin, args=(stop,), daemon=True)
        t.start()
        try:
            return rounds(lambda: timed(train, N) / N)
        finally:
            stop.set()
            t.join()

    def python_spin(stop) -> None:
        x = 0
        while not stop.is_set():
            x += 1

    def torch_spin(stop) -> None:
        a, b = torch.ones(1), torch.ones(1)
        while not stop.is_set():
            torch.add(a, b)

    out["train step beside a Python loop"] = beside(python_spin)
    out["train step beside a thread of tiny torch ops"] = beside(torch_spin)
    power = "not read"
    try:
        import subprocess

        power = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    for k, v in out.items():
        print(f"{k}: {v:.4f} ms [{card}; {power}; switch interval "
              f"{sys.getswitchinterval()} s]", flush=True)


def loop_runs() -> None:
    import tempfile

    import torch

    from tpu_rl_torch.config import Config
    from tpu_rl_torch.kernels import build
    from tpu_rl_torch.runtime.sebulba import SebulbaLoop

    card = torch.cuda.get_device_name(0)
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    base = dict(env="CartPole-v1", env_mode="colocated", algo="PPO", colocated_envs=128,
                sebulba_split=1, sebulba_queue=2, loss_log_interval=50)
    for i, telemetry in enumerate((False, True, False, True)):
        kw = dict(base, result_dir=tempfile.mkdtemp()) if telemetry else base
        loop = SebulbaLoop(Config(**kw), seed=0, max_updates=LOOP_UPDATES, device="cuda",
                           devices=["cuda:0", "cuda:0"])
        out = loop.run(log=False)
        lanes = {led.role: round(led.snapshot()["buckets"]["compute"] / out["updates"] * 1e3, 4)
                 for led in loop._ledgers()}
        print(f"loop run {i + 1} (telemetry {'on' if telemetry else 'off'}): "
              f"{out['updates'] / out['elapsed_s']:.4f} updates/s, lane compute ms an update "
              f"{lanes or 'not measured (telemetry off)'}, queue peak {out['queue_peak_depth']}, "
              f"staleness max {out['max_staleness']} [{card}]", flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["loop"]:
        loop_runs()
    else:
        main()
