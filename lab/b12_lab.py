"""On-card measurements behind the LSTM unroll kernels' design
(``tpu_rl_torch/csrc/lstm_fwd.cu`` and ``lstm_bwd.cu``, kernels B1 and B2).
From the repository root, on a machine with one H100:

    python3 lab/b12_lab.py plans
    python3 lab/b12_lab.py stages
    python3 lab/b12_lab.py push
    python3 lab/b12_lab.py train [--tree DIR]

``plans``: at each of ``chip_smoke.LSTM_SHAPES``, B1 and B2 at the plan
``ops.lstm.lstm_launch_plan`` picks and, for clusters of 2, 4, 8 and 16,
at the one its cost model (``plan_cycles``) ranks first at that size, in
turns (first to last, then back), beside the model's estimate: does the
model rank the plans as the card does?
``stages``: the streamed regime's ring depth (2, 3, 4 stages) at the wide
shape's plan, in turns. ``push``: B2's partial dh summed over distributed
shared memory (pushed into the owner's slots) or through the global scratch
buffer, at the same resident plan, in turns. ``train``: chip_smoke's wide
PPO train step (``wide_lstm_train_phase``) with the ``tpu_rl_torch`` of
``DIR`` (default: this tree), for an A/B against another commit unpacked
there (``git archive``). Every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def inputs(B: int, S: int, H: int, seed: int = 0):
    """chip_smoke.lstm_phase's inputs: lecun-scale wh, ~20% resets."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g).cuda()  # noqa: E731
    xp, h0, c0 = rnd(B, S, 4 * H), rnd(B, H), rnd(B, H)
    wh = rnd(H, 4 * H) / H**0.5
    keep = (torch.rand((B, S), generator=g) >= 0.2).float()
    keep[: B // 2, 0] = 0.0
    return xp, wh, h0, c0, keep.cuda(), rnd(B, S, H), rnd(B, S, H)


def time_plans(cs, L, shape, plans: dict, card: str) -> None:
    """B1 and B2 at each of ``plans`` ({name: plan}) on the same inputs, in
    turns, each checked against the plain versions first."""
    B, S, H = shape
    xp, wh, h0, c0, keep, dhs, dcs = inputs(B, S, H)
    hs, cs_, acts = L.lstm_forward_plain(xp, wh, h0, c0, keep)
    dxp, _dwh, dh0, dc0 = L.lstm_backward_plain(wh, h0, c0, keep, hs, cs_, acts, dhs, dcs)
    iters = 100 if B * S * H <= 100_000 else 10
    for name, plan in plans.items():
        got = L._launch_fwd(xp, wh, h0, c0, keep, plan)
        gotb = L._launch_bwd(wh, c0, keep, cs_, acts, dhs, dcs, plan)
        errs = [cs.max_err(x, y) for x, y in zip(got + gotb, (hs, cs_, acts, dxp, dh0, dc0))]
        if max(errs[:3]) > cs.LSTM_FWD_TOL or max(errs[3:]) > cs.LSTM_GRAD_TOL:
            sys.exit(f"{shape} {name}: errors {errs} over the tolerance")
    times: dict[str, list[tuple[float, float]]] = {n: [] for n in plans}
    order = list(plans) + list(reversed(plans))
    for name in order:
        plan = plans[name]
        f = cs.device_ms(lambda: L._launch_fwd(xp, wh, h0, c0, keep, plan), iters=iters, reps=5)
        b = cs.device_ms(lambda: L._launch_bwd(wh, c0, keep, cs_, acts, dhs, dcs, plan),
                         iters=iters, reps=5)
        times[name].append((f, b))
    for name, plan in plans.items():
        (f1, b1), (f2, b2) = times[name]
        print(f"{shape} {name}: {plan.regime} R={plan.rows} U={plan.units} C={plan.cluster} "
              f"T={plan.threads} stages={plan.stages} push={int(plan.push)}: B1 {f1:.6f} / "
              f"{f2:.6f} ms, B2 {b1:.6f} / {b2:.6f} ms, model "
              f"{L.plan_cycles(B, S, H, plan) / 1.98e6:.6f} ms [{card}]", flush=True)


def plans_cmd(cs, L, card: str) -> None:
    """The chosen plan beside, for every cluster size, the plan the cost
    model ranks first at that size."""
    for shape in cs.LSTM_SHAPES:
        B, S, H = shape
        chosen = L.lstm_launch_plan(B, S, H)
        plans = {"chosen": chosen}
        by_c: dict[int, object] = {}
        for p in sorted(L._candidates(B, H, chosen.resident), key=lambda p: L.plan_cycles(B, S, H, p)):
            by_c.setdefault(p.cluster, p)
        for c, p in sorted(by_c.items()):
            if p != chosen and c in (2, 4, 8, 16):
                plans[f"C{c}"] = p
        time_plans(cs, L, shape, plans, card)


def stages_cmd(cs, L, card: str) -> None:
    shape = cs.LSTM_SHAPES[-1]
    plan = L.lstm_launch_plan(*shape)
    plans = {}
    for s in (2, 3, 4):
        fwd, bwd = L.streamed_smem(plan.rows, plan.units, s)
        plans[f"stages{s}"] = dataclasses.replace(plan, stages=s, smem_fwd=fwd, smem_bwd=bwd)
    time_plans(cs, L, shape, plans, card)


def push_cmd(cs, L, card: str) -> None:
    for shape in cs.LSTM_SHAPES:
        plan = L.lstm_launch_plan(*shape)
        if plan.resident:
            time_plans(cs, L, shape, {"push": dataclasses.replace(plan, push=True),
                                      "global": dataclasses.replace(plan, push=False)}, card)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("plans", "stages", "push", "train"))
    ap.add_argument("--tree", default=str(ROOT), help="train: the tree whose tpu_rl_torch runs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("b12_lab needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    if args.what == "train":
        # chip_smoke's phase, with the package of the other tree first on
        # the path (its kernels build into that tree's _build/).
        sys.path.insert(0, str(Path(args.tree).resolve()))
        import tpu_rl_torch

        print(f"train: tpu_rl_torch from {Path(tpu_rl_torch.__file__).parent} [{card}]", flush=True)
        cs.wide_lstm_train_phase(card)
        return
    from tpu_rl_torch.ops import lstm as L

    {"plans": plans_cmd, "stages": stages_cmd, "push": push_cmd}[args.what](cs, L, card)


if __name__ == "__main__":
    main()
