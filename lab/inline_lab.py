#!/usr/bin/env python3
"""``chip_smoke.py``'s inline SAC-Continuous runs, off the smoke: the
recipe, target and budget of ``chip_smoke.INLINE_CONT_DEVICE`` (Pendulum-v1,
a 50-episode mean of -400) or ``INLINE_CONT_GYM`` (MountainCarContinuous-v0,
run_baselines.py's recipe, target 90), through either package's inline
trainer.

    python3 lab/inline_lab.py tpu_rl pendulum [SEED ...]         # tpu_rl's examples/train_inline.py
    python3 lab/inline_lab.py port pendulum [SEED ...]           # tpu_rl_torch's, on the CPU
    python3 lab/inline_lab.py port-stand-in pendulum [SEED ...]  # ... over chip_smoke.DeviceSpecEnv
    python3 lab/inline_lab.py port-card mountaincar [SEED ...]   # tpu_rl_torch's, on the card
    python3 lab/inline_lab.py tpu_rl pendulum --lr 3e-4 [SEED ...]  # the recipe at another lr

From the repository root (``JAX_PLATFORMS=cpu`` for ``tpu_rl``). ``tpu_rl``
and ``port`` step gymnasium's envs; ``port-stand-in`` steps the port's
device dynamics behind ``chip_smoke.DeviceSpecEnv``, as the card does
where gymnasium is not installed. One package is imported per process.
Each seed prints its stats dict as one JSON line. The Pendulum budget is
the first of 3000, 4000, ... updates within which ``tpu_rl``'s trainer
reaches the bar at seed 0. ``lab/`` is outside the package.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv: list[str]) -> None:
    sys.path.insert(0, str(ROOT))
    which, recipe, rest = argv[0], argv[1], argv[2:]
    lr = None
    if rest[:1] == ["--lr"]:
        lr, rest = float(rest[1]), rest[2:]
    seeds = [int(s) for s in rest] or [0]
    import chip_smoke as cs

    kw = {"pendulum": cs.INLINE_CONT_DEVICE, "mountaincar": cs.INLINE_CONT_GYM}[recipe]
    kw = dict(kw, overrides=dict(kw["overrides"], **({} if lr is None else {"lr": lr})))
    if which == "tpu_rl":
        from examples.train_inline import run
    else:
        if which == "port-stand-in":
            sys.modules["gymnasium"] = None  # import fails: env_source installs the stand-in
            print(cs.env_source(), flush=True)
        from functools import partial

        from tpu_rl_torch.examples.train_inline import run

        run = partial(run, device="cuda" if which == "port-card" else "cpu")
    for seed in seeds:
        print(json.dumps(run(**dict(kw, seed=seed))), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
