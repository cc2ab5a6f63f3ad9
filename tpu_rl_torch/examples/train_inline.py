"""Single-process end-to-end slice for any of the six algorithms through the
port's public API — the port of ``tpu_rl``'s ``examples/train_inline.py``:
a gymnasium env loop (``EnvAdapter``), ``seq_len`` windows with ``is_fir``
and the stored carries, and the train step on the card (B1/B2 unroll the
LSTMs there). On-policy algorithms train once per batch of windows; SAC and
SAC-Continuous keep a uniform replay of windows and sample from it.

The trainer draws from ``np.random.default_rng(seed)`` in ``tpu_rl``'s call
order (the warm-up actions, then the replay's indices), so under warm-up the
two trainers make the same actions, the same replay and the same sampled
indices; the policy's own sampling draws from a ``torch.Generator`` on the
run's device.

Run (the card; ``--device cpu`` for the plain path on the CPU):
  python -m tpu_rl_torch.examples.train_inline \\
      [--algo PPO] [--env CartPole-v1] [--updates 250] [--target 500] [--device cuda]
"""

from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from tpu_rl_torch import resolve_device
from tpu_rl_torch.algos.registry import get_algo
from tpu_rl_torch.config import Config, is_off_policy
from tpu_rl_torch.models.families import build_family
from tpu_rl_torch.runtime.env import EnvAdapter, probe_spaces
from tpu_rl_torch.types import BATCH_FIELDS, Batch, maybe_zero_carry


def act_params(state):
    """Acting parameter tree for either state flavour (SACState keeps the
    actor separate; TrainState nests it under "actor")."""
    if hasattr(state, "actor_params"):
        return {"actor": state.actor_params}
    return {"actor": state.params["actor"]}


def run(
    updates: int = 250,
    algo: str = "PPO",
    env_name: str = "CartPole-v1",
    seed: int = 0,
    batch_size: int = 32,
    log_every: int = 25,
    target: float | None = None,
    overrides: dict | None = None,
    device: str = "cuda",
) -> dict:
    """Train on ``device`` (the card unless the caller passes
    ``device="cpu"``) and return ``tpu_rl``'s stats dict.

    ``target``: stop once the 50-game mean episode reward reaches it.
    ``overrides`` are Config keys plus three of the trainer's own:
    ``entropy_anneal`` (``{"coef", "lr", "std_floor", "alpha_min"}`` taken
    at update ``"at"`` or at ``"frac"`` of the budget; a ``std_floor``
    rebuilds the family, the params carry over), ``warmup_steps`` (random
    actions for the first N env steps: sticky bang-bang for continuous
    actions, flipping sign with ``warmup_flip_p``; iid uniform for
    discrete; off-policy algorithms only) and ``warmup_flip_p``.
    """
    dev = resolve_device(device)
    cfg_dict = dict(
        algo=algo,
        env=env_name,
        batch_size=batch_size,
        seq_len=5,
        lr=3e-4,
        entropy_coef=0.001,
        reward_scale=0.1,
        time_horizon=500,
    )
    overrides = dict(overrides or {})
    anneal = overrides.pop("entropy_anneal", None)
    warmup_steps = int(overrides.pop("warmup_steps", 0))
    warmup_flip_p = float(overrides.pop("warmup_flip_p", 0.1))
    cfg_dict.update(overrides)
    cfg = probe_spaces(Config.from_dict(cfg_dict))
    off_policy = is_off_policy(cfg.algo)
    if warmup_steps and not off_policy:
        # on-policy losses weight by the stored behaviour log-probs, which
        # warm-up actions (not drawn from the policy) would make garbage
        raise ValueError(
            "warmup_steps requires an off-policy algorithm (SAC/SAC-Continuous)"
        )
    spec = get_algo(cfg.algo)
    family, state, train_step = spec.build(
        cfg, torch.Generator().manual_seed(seed), device=dev
    )
    switch_at = None
    if anneal:
        switch_at = max(
            1,
            int(anneal["at"]) if "at" in anneal
            else int(anneal["frac"] * updates),
        )
    act = family.act
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    env = EnvAdapter(cfg, seed=seed)
    obs = env.reset()
    hw, cw = family.carry_widths
    h = torch.zeros((1, hw), device=dev)
    c = torch.zeros((1, cw), device=dev)
    is_fir = 1.0
    epi_rew, epi_steps = 0.0, 0
    rewards = collections.deque(maxlen=50)
    best_epi_rew = -float("inf")
    rng = np.random.default_rng(seed)

    warm_sign = float(rng.choice([-1.0, 1.0]))  # sticky bang-bang warm-up state
    seq: list[dict] = []
    ready: list[dict] = []
    # off-policy replay of windows (capacity in windows)
    replay: collections.deque = collections.deque(maxlen=cfg.buffer_size)
    env_steps = 0
    update = 0
    time_to_target = None
    hit = False
    t0 = time.time()

    def mean50() -> float:
        return float(np.mean(rewards)) if rewards else float("nan")

    while update < updates and not hit:
        # ---- collect: one fresh window per update (off-policy, once the
        # replay holds a batch) or a full batch of windows (on-policy)
        need = 1 if (off_policy and len(replay) >= cfg.batch_size) else cfg.batch_size
        while len(ready) < need:
            ob = torch.as_tensor(obs, dtype=torch.float32, device=dev)[None]
            with torch.no_grad():
                a, logits, log_prob, h2, c2 = act(act_params(state), ob, h, c, generator=gen)
                # one read back a step: the action, the behaviour outputs
                # and the pre-step carry that the window stores
                host = torch.cat([a[0], logits[0], log_prob[0], h[0], c[0]]).cpu().numpy()
            widths = np.cumsum([a.shape[1], logits.shape[1], log_prob.shape[1], hw])
            a_np, logits_np, log_prob_np, hx_np, cx_np = np.split(host, widths)
            if env_steps < warmup_steps:
                # execute and store a scripted action; the carry stays the
                # policy's. The stored logits/log_prob would describe the
                # policy's own sample, so they are poisoned with NaN (SAC
                # never reads them).
                log_prob_np = np.full_like(log_prob_np, np.nan)
                logits_np = np.full_like(logits_np, np.nan)
                if family.continuous:
                    if rng.random() < warmup_flip_p:
                        warm_sign = -warm_sign
                    a_np = np.clip(
                        warm_sign + 0.25 * rng.normal(size=tuple(a.shape)), -1.0, 1.0,
                    ).astype(np.float32)[0]
                else:
                    a_np = rng.integers(
                        0, cfg.action_space, size=tuple(a.shape)
                    ).astype(np.float32)[0]
            next_obs, rew, done = env.step(a_np)
            epi_rew += rew
            epi_steps += 1
            env_steps += 1
            seq.append(
                dict(
                    obs=np.asarray(obs, np.float32),
                    act=a_np,
                    rew=np.array([rew * cfg.reward_scale], np.float32),
                    logits=logits_np,
                    log_prob=log_prob_np,
                    is_fir=np.array([is_fir], np.float32),
                    hx=hx_np,
                    cx=cx_np,
                )
            )
            if len(seq) == cfg.seq_len:
                ready.append(
                    {k: np.stack([s[k] for s in seq]) for k in BATCH_FIELDS}
                )
                seq = []
            is_fir = 0.0
            obs, h, c = next_obs, h2, c2
            if done or epi_steps >= cfg.time_horizon:
                rewards.append(epi_rew)
                best_epi_rew = max(best_epi_rew, epi_rew)
                if (
                    target is not None
                    and len(rewards) == rewards.maxlen
                    and mean50() >= target
                ):
                    time_to_target = time.time() - t0
                    hit = True
                obs = env.reset()
                h = torch.zeros_like(h)
                c = torch.zeros_like(c)
                is_fir, epi_rew, epi_steps = 1.0, 0.0, 0

        # ---- train
        if off_policy:
            replay.extend(ready)
            ready = []
            if len(replay) < cfg.batch_size:
                continue
            idx = rng.integers(0, len(replay), size=cfg.batch_size)
            picked = [replay[int(i)] for i in idx]
        else:
            picked, ready = ready, []
        batch = Batch.from_mapping(
            maybe_zero_carry(
                cfg, {k: np.stack([t[k] for t in picked]) for k in BATCH_FIELDS}
            ),
            device=dev,
        )
        state, metrics = train_step(state, batch, generator=gen)
        update += 1
        if switch_at is not None and update == switch_at:
            cfg = cfg.replace(
                entropy_coef=float(anneal.get("coef", cfg.entropy_coef)),
                lr=float(anneal.get("lr", cfg.lr)),
                std_floor=float(anneal.get("std_floor", cfg.std_floor)),
                alpha_min=float(anneal.get("alpha_min", cfg.alpha_min)),
            )
            if "std_floor" in anneal:
                # std_floor is a module attribute, not a parameter: rebuild
                # the family (params carry over) so acting and training both
                # use the floored distribution
                family = build_family(cfg, device=dev)
                act = family.act
            train_step = spec.make_train_step(cfg, family)
            print(
                f"update {update}: entropy_coef -> {cfg.entropy_coef}, "
                f"lr -> {cfg.lr}, std_floor -> {cfg.std_floor}, "
                f"alpha_min -> {cfg.alpha_min}",
                flush=True,
            )
        if update % log_every == 0:
            extra = ""
            if "alpha" in metrics:
                extra = (
                    f"  alpha {float(metrics['alpha']):.4f}"
                    f"  q-loss {float(metrics['value-loss']):+.4f}"
                )
            print(
                f"update {update:5d}  loss {float(metrics['loss']):+.4f}  "
                f"mean-epi-rew {mean50():8.2f}  "
                f"best {best_epi_rew:8.2f}  env-steps {env_steps:7d}  "
                f"elapsed {time.time()-t0:6.1f}s{extra}",
                flush=True,
            )
    wallclock = time.time() - t0

    # Greedy evaluation, 20 episodes: argmax of the logits (discrete) or the
    # family's deterministic act (continuous).
    eval_mean = None
    if not family.continuous or family.act_greedy is not None:
        returns = []
        for _ep in range(20):
            obs = env.reset()
            h = torch.zeros((1, hw), device=dev)
            c = torch.zeros((1, cw), device=dev)
            total, steps, done = 0.0, 0, False
            while not done and steps < cfg.time_horizon:
                ob = torch.as_tensor(obs, dtype=torch.float32, device=dev)[None]
                with torch.no_grad():
                    if family.continuous:
                        a, h, c = family.act_greedy(act_params(state), ob, h, c)
                        greedy = a[0].cpu().numpy()
                    else:
                        _a, logits, _lp, h, c = act(act_params(state), ob, h, c, generator=gen)
                        greedy = np.asarray(
                            [float(np.argmax(logits[0].cpu().numpy()))]
                        )
                obs, rew, done = env.step(greedy)
                total += rew
                steps += 1
            returns.append(total)
        eval_mean = float(np.mean(returns))
    env.close()
    return {
        "algo": cfg.algo,
        "env": cfg.env,
        "final_mean_50": mean50(),
        "best_epi_rew": (
            round(best_epi_rew, 1) if np.isfinite(best_epi_rew) else None
        ),
        "target": target,
        "reached_target": hit,
        "time_to_target_s": (
            round(time_to_target, 1) if time_to_target is not None else None
        ),
        "greedy_eval_mean_20": eval_mean,
        "updates": update,
        "env_steps": env_steps,
        "wallclock_s": round(wallclock, 1),
        "env_steps_per_s": round(env_steps / max(wallclock, 1e-9), 1),
        "seed": seed,
    }


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--algo", default="PPO")
    p.add_argument("--env", default="CartPole-v1")
    p.add_argument("--updates", type=int, default=250)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--target", type=float, default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args()
    stats = run(
        args.updates, args.algo, args.env, args.seed,
        batch_size=args.batch_size, target=args.target, device=args.device,
    )
    import json

    print(json.dumps(stats))
