"""Colocated (Anakin-mode) training loop on one GPU — the port of
``tpu_rl.runtime.colocated``.

Envs, acting and training all run on the device in one process: no workers,
no ZMQ, no shared-memory ring. One iteration (:meth:`ColocatedLoop.program`):

1. :meth:`~ColocatedLoop.rollout`: ``cfg.seq_len`` acting ticks. Each tick
   keeps the worker's tick semantics: store the pre-step obs, pre-step carry
   (zero placeholders for the transformer, which acts from KV caches it
   never stores) and pre-tick ``is_fir``, act (``family.act``), step the vectorized env
   (auto-reset and the ``time_horizon`` truncation live in
   :func:`~tpu_rl_torch.envs.make_vec_env`), scale the reward, zero the
   carry on done with ``torch.where`` (never a multiply: a NaN carry must
   not survive the reset), and raise ``is_fir`` for the post-reset step.
   The ticks stack into the learner's batch-major ``(B, S, w)``
   :class:`~tpu_rl_torch.types.Batch`.
2. The algorithm's ``train_step(state, batch)`` on that batch while it is
   still on the device; its LSTM unroll runs the kernels of
   :mod:`tpu_rl_torch.ops.lstm`, the transformer's attention kernel B4
   (:mod:`tpu_rl_torch.ops.attention`) with ``attention_impl="flash"``.

Episode counts and return sums accumulate on the device; the host reads
them, and the metrics, only every ``cfg.loss_log_interval`` updates.

Not in this slice: meshes and multihost, checkpoint and resume, telemetry,
the history store, the goodput ledger and the ``diag`` accumulator (the
train step still computes ``diag``; the loop drops it).
"""

from __future__ import annotations

import time

import torch

from tpu_rl_torch import resolve_device
from tpu_rl_torch.algos.registry import get_algo
from tpu_rl_torch.config import Config
from tpu_rl_torch.envs import get_spec, make_vec_env
from tpu_rl_torch.types import BATCH_FIELDS, Batch
from tpu_rl_torch.utils.timer import ExecutionTimer


def act_params(state) -> dict:
    """The acting parameter dict of a train state."""
    return {"actor": state.params["actor"]}


def resolve_colocated_config(cfg: Config) -> Config:
    """``colocated_envs`` replaces ``batch_size`` (the env batch IS the train
    batch), and the obs/action spaces come from the env spec."""
    if cfg.colocated_envs:
        cfg = cfg.replace(
            batch_size=cfg.colocated_envs,
            buffer_size=max(cfg.buffer_size, cfg.colocated_envs),
        )
    spec = get_spec(cfg.env)
    return cfg.replace(
        obs_shape=spec.obs_shape, action_space=spec.action_space, is_continuous=spec.is_continuous
    )


class ColocatedLoop:
    """Owns the act -> env step -> train loop and its device state.

    - :meth:`rollout` ``(params, carry, generator) -> (carry, batch, done,
      ep_ret)``: the acting ticks alone;
    - :meth:`program` ``(state, carry, stats, generator) -> (state, carry,
      stats, metrics)``: rollout + train step;
    - :meth:`run`: :meth:`program` up to ``max_updates``, with a summary.

    Runs on ``device="cuda"`` unless the caller passes ``device="cpu"``.
    The initial weights are drawn from a CPU generator seeded with ``seed``;
    acting and env resets draw from a generator on the device seeded with
    ``seed + 1``.
    """

    def __init__(
        self,
        cfg: Config,
        seed: int = 0,
        max_updates: int | None = None,
        device: str | torch.device | None = "cuda",
    ):
        self.device = resolve_device(device)
        cfg = resolve_colocated_config(cfg)
        if cfg.env_mode != "colocated":
            raise ValueError(f"ColocatedLoop needs env_mode='colocated', got {cfg.env_mode!r}")
        self.cfg = cfg
        self.seed = int(seed)
        self.max_updates = max_updates
        self.spec = get_spec(cfg.env)
        self._v_reset, self._v_step = make_vec_env(self.spec, cfg.batch_size, cfg.time_horizon)
        self.family, self.state, self.train_step = get_algo(cfg.algo).build(
            cfg, torch.Generator().manual_seed(self.seed), self.device
        )
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)

    # ------------------------------------------------------------ device init
    def init_carry(self, generator: torch.Generator | None = None) -> dict:
        """Fresh acting carry: reset envs, zero recurrent state, ``is_fir=1``
        (every env starts an episode), zero running returns."""
        gen = self.generator if generator is None else generator
        env, obs = self._v_reset(gen, self.device)
        n = self.cfg.batch_size
        hw, cw = self.family.carry_widths
        f32 = dict(dtype=torch.float32, device=self.device)
        return {
            "env": env,
            "obs": obs,
            "h": torch.zeros((n, hw), **f32),
            "c": torch.zeros((n, cw), **f32),
            "is_fir": torch.ones((n,), **f32),
            "ret": torch.zeros((n,), **f32),
        }

    def init_stats(self) -> dict:
        return {
            "episodes": torch.zeros((), dtype=torch.int64, device=self.device),
            "ret_sum": torch.zeros((), dtype=torch.float32, device=self.device),
        }

    # ------------------------------------------------------------------ steps
    def _tick(self, params, cr: dict, generator: torch.Generator):
        """One acting tick: the worker loop's body on the device."""
        a, logits, log_prob, h2, c2 = self.family.act(params, cr["obs"], cr["h"], cr["c"], generator)
        env, obs2, rew, done = self._v_step(cr["env"], a, generator)
        ret2 = cr["ret"] + rew
        if self.family.store_carry:
            hx, cx = cr["h"], cr["c"]
        else:  # transformer: zero placeholders, not the caches
            n = self.cfg.batch_size
            hx, cx = (torch.zeros((n, w), dtype=torch.float32, device=self.device)
                      for w in self.family.stored_carry_widths)
        ys = dict(
            obs=cr["obs"],
            act=a,
            rew=(rew * self.cfg.reward_scale)[:, None],
            logits=logits,
            log_prob=log_prob,
            is_fir=cr["is_fir"][:, None],
            hx=hx,
            cx=cx,
            done=done,
            # Completed-episode raw return, on the terminal tick.
            ep_ret=torch.where(done, ret2, 0.0),
        )
        keep = (~done)[:, None]
        cr2 = {
            "env": env,
            "obs": obs2,
            "h": torch.where(keep, h2, 0.0),
            "c": torch.where(keep, c2, 0.0),
            "is_fir": done.float(),
            "ret": torch.where(done, 0.0, ret2),
        }
        return cr2, ys

    @torch.no_grad()
    def rollout(self, params, carry: dict, generator: torch.Generator | None = None):
        gen = self.generator if generator is None else generator
        ticks = []
        for _ in range(self.cfg.seq_len):
            carry, ys = self._tick(params, carry, gen)
            ticks.append(ys)

        def stack(f: str) -> torch.Tensor:  # S ticks of (B, w) -> (B, S, w)
            return torch.stack([y[f] for y in ticks], dim=1)

        batch = Batch(**{f: stack(f) for f in BATCH_FIELDS})
        return carry, batch, stack("done"), stack("ep_ret")

    def program(self, state, carry: dict, stats: dict, generator: torch.Generator | None = None):
        carry, batch, done, ep_ret = self.rollout(act_params(state), carry, generator)
        state, metrics = self.train_step(state, batch)
        stats = {
            "episodes": stats["episodes"] + done.sum(),
            "ret_sum": stats["ret_sum"] + ep_ret.sum(),
        }
        return state, carry, stats, metrics

    # --------------------------------------------------------------- run loop
    def run(self, log: bool = True) -> dict:
        """Drive :meth:`program` to ``max_updates``. Returns the run totals:
        ``updates``, ``env_steps``, ``episodes``, ``mean_return_overall``,
        ``mean_return_recent`` (the last log window's completed-episode
        mean), ``mean_return_best_window`` (the best such window),
        ``elapsed_s``, ``transitions_per_s``, and the timer's ``scalars``."""
        cfg = self.cfg
        n, s = cfg.batch_size, cfg.seq_len
        timer = ExecutionTimer(num_transition=n * s)
        state = self.state
        carry = self.init_carry()
        stats = self.init_stats()
        log_every = max(1, cfg.loss_log_interval)
        it = 0
        last_it, last_ep, last_ret = 0, 0, 0.0
        mean_ret, best_ret = 0.0, float("-inf")
        t0 = t_mark = time.perf_counter()
        while self.max_updates is None or it < self.max_updates:
            state, carry, stats, metrics = self.program(state, carry, stats)
            it += 1
            if it % log_every and it != self.max_updates:
                continue
            # The host reads block on iteration `it`, so the clock below
            # covers the device's work.
            episodes = int(stats["episodes"])
            ret_sum = float(stats["ret_sum"])
            host_metrics = {k: float(v) for k, v in metrics.items() if k != "diag"}
            now = time.perf_counter()
            iters = it - last_it
            chunk_s = (now - t_mark) / max(1, iters)
            timer.record("colocated-iteration", chunk_s, check_throughput=True)
            tps = iters * n * s / max(now - t_mark, 1e-9)
            if episodes > last_ep:
                mean_ret = (ret_sum - last_ret) / (episodes - last_ep)
                best_ret = max(best_ret, mean_ret)
            if log:
                print(
                    f"[colocated] update {it}  tps {tps:,.0f}  episodes {episodes}  "
                    f"mean_return {mean_ret:.1f}  "
                    + "  ".join(f"{k} {v:.4f}" for k, v in host_metrics.items()),
                    flush=True,
                )
            last_it, last_ep, last_ret = it, episodes, ret_sum
            t_mark = time.perf_counter()
        episodes = int(stats["episodes"])
        ret_sum = float(stats["ret_sum"])
        elapsed = time.perf_counter() - t0
        self.state = state
        return {
            "updates": it,
            "env_steps": it * n * s,
            "episodes": episodes,
            "mean_return_overall": ret_sum / max(1, episodes),
            "mean_return_recent": mean_ret,
            "mean_return_best_window": best_ret,
            "elapsed_s": elapsed,
            "transitions_per_s": it * n * s / max(elapsed, 1e-9),
            "scalars": timer.scalars(),
        }
