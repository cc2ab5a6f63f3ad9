#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``tpu_rl_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

It drives the port's serving path (f32, bf16 and int8 weights), its
distributed runtime (worker -> manager -> storage -> learner processes), its
training topology (the Sebulba split, the multihost learner on hosts of
several ranks, the population plane), its operations planes (chaos, the
heal plane under injected faults, the fleet autopilot), its
colocated LSTM training path (with checkpoint and resume), bf16-compute
LSTM training, the other algorithms' train steps and colocated loops
(IMPALA, V-MPO, PPO-Continuous, SAC, SAC-Continuous), the transformer's
PPO, IMPALA and V-MPO training (train steps at full width with flash and
blockwise attention, and its colocated loop), the transformer's serving,
the single-process off-policy path (the inline trainer with SAC learning
from its replay, the host data plane feeding the card) and the run
reports end to end, and holds every hand-written kernel of those paths
against its plain PyTorch version:

1. device check: a CUDA card is required (else exit 1, no result printed);
   prints the card's name and power limit as nvidia-smi reports them and
   turns TF32 off everywhere;
2. build: every ``tpu_rl_torch/csrc/*.cu`` with nvcc (``kernels/build.py``),
   printing ptxas's registers and spill stores for every kernel instance;
3. kernel vs plain: the fused act kernel at the serving ladder, ragged row
   counts, the default model (8, 64 and 128 rows: 64 is the cluster's
   remote-acting flush), the wide model and two edge widths (ragged
   unit slices; H not a multiple of 4), on seeded inputs and the
   port's own init with seeded nonzero biases; per shape the launch plan
   (``ops.fused_act.act_launch_plan``: rows and units per block, cluster
   size, and how many such clusters the card holds at once), the max abs
   error, the kernel's, the plain version's and the unfused act's
   (``family.act``) times, and the bound;
4. serving: an ``InferenceService`` (IMPALA ``DiscreteActorCritic``,
   H=256, A=2, inference_batch=256, buckets 8..256, the fused kernel) over
   an in-process ``LocalRouter``, under 2 clients x 4 envs x 1000 acts and
   64 clients x 4 envs x 100 acts; asserts every request is answered, the
   kernel ran exactly once per warm-up and per flush, the carry persists on
   the server and a parameter swap is served with its version, and B3 ran
   once per warm-up and flush at each bucket (counted in the wrapper); then
   the same run again under the profiler, for B3's device time per serving
   run (beside an estimate: each bucket's kernel-phase time x its
   launches); then bf16 and int8 serving (``inference_dtype``: the weights
   quantized when the service takes them, widened before B3 in each act
   step): tests/test_quant.py's policy bars on its margin-scaled head, and
   mix 1 with the same checks, a flush's replies against ``family.act`` on
   the widened tree, and ``tree_bytes`` per mode;
5. LSTM kernels vs plain: B1 (``lstm_fwd``) and B2 (``lstm_bwd``) at
   (B,S,H) = (128,5,64) the training path, (32,5,64) the learning run,
   (100,5,64) ragged, (256,16,256) and (1024,16,1024), on seeded inputs with
   a keep mask that resets; per shape the launch plan
   (``ops.lstm.lstm_launch_plan``: regime, rows and units per block,
   cluster, and how many such clusters the card holds), the max abs error
   of hs, cs, acts, dxp, dh0, dc0 and of the whole autograd Function's
   dwh, the kernel's and the plain version's times, the bound, the
   Function's forward + backward beside the plain pair's, and cuDNN's LSTM
   (no resets) as a yardstick;
6. training: the default config (PPO, CartPole, H=64, S=5, 128 envs)
   through ``ColocatedLoop.program``, 5 warm-up then 200 timed updates:
   transitions/s, ms per update, its rollout/train split, the device busy
   share over a 10-update profiler window, and B1/B2 launch counts equal to
   updates x K_epoch with no fused-act launch;
7. learning: ``ColocatedLoop.program`` on tpu_rl's colocated smoke recipe
   (batch 32, lr 3e-4, entropy 1e-3, seed 0), one line per 200-update
   window (``ColocatedLoop.run``'s), up to 1800 updates, stopped at the
   first window that meets the bar; fails unless a window's mean return is
   >= 60 over >= 100 episodes;
8. wide LSTM training: ``get_algo(algo).build`` and its train step at
   bench.py's IMPALA@wide-lstm row (1024 x 16, H=1024, obs 64, 8 actions,
   f32), with PPO (as in earlier slices) and with the row's IMPALA, on a
   seeded batch with resets, 2 warm-up then 5 timed updates: ms per
   update, host enqueue and device time, B1 + B2's share of device time,
   B1/B2 launch counts equal to updates x K_epoch; for IMPALA V-trace's
   device time on the step's own inputs and its share;
8a. the @ref rows of the other algorithms (bench.py:234-239: IMPALA, V-MPO,
   SAC, PPO-Continuous, SAC-Continuous at 128 x 5, H=64): one train step on
   the card against the same step on the CPU through the plain versions,
   from one seeded state, batch and shared noise (loss rtol 1e-5, metrics
   and params 1e-5, grad norms and optimizer moments 3e-5), then 10 timed
   updates whose B1/B2 launches must be updates x K_epoch x the path's
   per-epoch count (1/1; SAC 8/3, SAC-Continuous 8/5);
8b. colocated IMPALA and V-MPO on CartPole and PPO-Continuous on Pendulum
   through ``ColocatedLoop.program`` at 128 envs, 1 + 2 updates: ms per
   update, finite metrics and params, launches = updates x K_epoch; then
   an IMPALA learning run on step 7's recipe for 100 updates, its best
   window printed with no bar;
8c. bf16 compute (tpu_rl's mixed precision; the recurrence is the bf16
   scan, never B1/B2): ``mixed_dot`` on the card against the CPU (1e-5)
   and, at the wide recurrence, against the float64 product (f32 sums);
   IMPALA@ref with compute_dtype bf16, the card's step against the CPU's at
   the bf16 element bar; bench.py's IMPALA@wide-lstm-bf16 row (as step 8,
   B1/B2 launches 0, the bf16 products' and the scan's elementwise shares)
   printed beside step 8's f32 row; colocated PPO with bf16 compute;
8d. checkpoint and resume: the default config's colocated loop with
   model_dir, saving every 10 updates (async) for 30, resumed bit for bit
   (state and generator) by a fresh loop and run to 40; a torn directory
   invisible; a bf16 config refused unless resume_force; save seconds sync
   and async, ms/update with and without checkpoints;
9. B4 (``flash_attn_fwd``/``flash_attn_bwd``: bf16 on the tensor-core
   kernels ``flash_attn_tc_*``, f32 on the split-TF32 tensor-core kernels
   ``flash_attn_f32_*``) vs plain: the main path's (B,T,H,D)
   = (16,2048,8,64) bf16, the colocated config's (8,4096,8,32) bf16, bf16
   rows with long segments over many tiles, many seams on a ragged T, a
   small D=32 shape and shuffled (non-monotone) segment ids, and f32 rows
   (the main path's shape at tpu_rl's default f32 compute, one with
   ~1000-key segments), q/k/v as strided views of one qkv tensor;
   per shape the tile pairs the kernels visit beside the causal ones,
   the max abs error of o, lse, dq, dk and dv beside its tolerance (bf16:
   element by element) and the median |ref|, the kernels', the plain
   versions' and ``scaled_dot_product_attention``'s times (the same mask as
   a boolean attn_mask), and the bound (f32: the dense TF32 peak, with the
   f32 FMA peak's bound of the CUDA-core kernels beside it);
10. blockwise attention (the plain tile loop, block 512) at bench.py's
   longctx-blockwise shape (16,2048,8,64), f32 and bf16, seams from
   CartPole-like episodes: output and gradients of a weighted loss against
   full attention (f32: tpu_rl's bars; bf16: against full attention in f32
   on the same bf16 inputs, two bf16 ulps of each tensor's largest
   element), the share of each bar used; peak memory of a forward and
   backward, which must sit one (B,H,T,T) f32 score tensor or more below
   full attention's; device times beside B4's on the same inputs;
10a. transformer training: small f32 and bf16 train steps on the card
   against the CPU's plain path (loss, grad norm), and a small f32 flash
   PPO step (8 x 256, d128, 2 heads of 64, 2 layers, CartPole-like
   episode seams) at the @ref bars, then
   ``get_algo("PPO").build`` at
   bench.py's ``PPO-transformer@longctx-flash`` model (d512, 8 heads, 4
   layers, bf16, flash; its build must leave bf16 products reducing in f32)
   on a seeded 16 x 2048 batch with seams, 2 warm-up
   then 10 timed updates: ms per update, transitions/s, peak memory, B4's
   share of device time over a profiler window, finite loss, and B4 launch
   counts equal to n_layers x K_epoch x updates; then the
   ``PPO-transformer@longctx-blockwise`` row (the same with blockwise
   attention, 5 timed updates, B4 launches 0, the tiles' share of device
   time) and the longctx-flash row at ``compute_dtype="float32"``,
   tpu_rl's default (the f32 kernels; 2 warm-up then 5 timed updates, the
   same counts and shares);
10b. the transformer's IMPALA and V-MPO: each step at 128 x 16, d64, 4
   heads, 2 layers (full attention, f32) on the card against the CPU's at
   the @ref bars, then at the longctx-flash width for 2 timed updates with
   B4's launches counted (n_layers x K_epoch x updates);
11. the transformer's colocated loop: ``ColocatedLoop.program`` on
   ``configs/longcontext_singlechip.example.json`` at LONGCTX_LAYERS
   layers (blockwise; CartPole, KV-cached acting, 8 x 4096) for 1 update,
   finite metrics, no
   B4 launch, one tick's host and device time; then the same with flash
   attention for 1 update, B4 launches n_layers x K_epoch each way;
11a. transformer serving: the long-context config's model (d256, 8 heads,
   LONGCTX_LAYERS layers, act_ctx 512, bf16 compute; obs 4, 2 actions) behind
   ``InferenceService`` with its KV caches in the service's carry table on
   the card, at inference_dtype f32, bf16 and int8, under mix 1 (2 x 4 x
   600, the ring wraps) and mix 2 (64 x 4 x 50) with CartPole-like
   resets: no failure; mix 1's clients 0 and 1 equal to a replay of
   ``family.act`` on the card, bit for bit; client 0's env 0 against
   ``_act_transformer_window`` for act_ctx steps; host-to-device bytes =
   obs, first and slot per row; a param swap; acts/s, p50/p99, flush_ms,
   the act step's device time at 256 rows and per flush (profiler), carry
   bytes on the card, param_bytes; then both mixes at f32 compute, mix 2's
   clients 0, 21, 42 and 63 against their replay at 1e-5;
12. the telemetry and performance plane (``telemetry_phase``): (a) the
   training config's colocated loop through ``ColocatedLoop.run`` with the
   plane on (result_dir, an HTTP port, SLO rules, the diag accumulator,
   the history store) for 30 updates: ``/metrics``, ``/healthz`` and
   ``/goodput`` scraped mid-run, a ``/prof`` capture whose trace must name
   B1's and B2's kernels, every file written, the FLOPs per update equal to
   the CPU's count of the same update, B1/B2 launches = updates, no
   recompile; then ms/update with the plane on and off in turns, the params
   bit for bit equal; (b) IMPALA at bench.py's wide-lstm width on CartPole
   in the colocated loop with the plane on, 2 + 5 updates: FLOPs per
   update, achieved FLOP/s and MFU (bf16 peak), the memory gauges against
   ``torch.cuda.max_memory_allocated()``; (c) serving mix 1 with the plane
   on and off in turns: ``publish_serving_metrics``'s bucket counters
   against the flushes and B3's launches, no recompile, each bucket's FLOPs
   by B3's formula; (d) one full-width transformer train step counted: B4
   charged its formula once per launch;
12a. the off-policy slice's inline trainer (``inline_sac_phase``):
   ``tpu_rl_torch.examples.train_inline.run`` on the card with SAC-Continuous
   learning from its replay: on MountainCarContinuous-v0 with
   examples/run_baselines.py's recipe (bar: the 50-episode target 90 and a
   greedy eval >= 90) where gymnasium is installed, else on Pendulum-v1
   over the port's device dynamics behind a gymnasium-shaped stand-in
   (``DeviceSpecEnv``; bar: a 50-episode mean >= -400 within the budget at
   which tpu_rl's trainer reaches it); the env source printed; updates, env
   steps, wallclock, env steps/s; B1/B2 launches per update = 8/5 x
   K_epoch; B1/B2 at (32,5,64) beside their bounds; one train step's host
   enqueue vs device time (profiler); the act step's host ms per env step;
   then SAC on CartPole-v1 for 100 updates after a 2000-step warm-up:
   launches 8/3 per update, every loss finite;
12b. the data plane onto the card (``replay_feed_phase``): a ReplayStore at
   the reference's capacity (10240 windows at SAC@ref's 128 x 5, H 64, obs
   4) filled by a spawn child; 50 SAC train steps fed by SynchronousFeed and
   by PrefetchPipeline(depth 2), both through ``device_batch`` (pinned
   staging buffers, a side stream, an event the consumer waits on), from
   one state, sampler seed and train generator: every batch on the card
   equal to its numpy sample and the final states equal, bit for bit; then
   the same on an OnPolicyStore at IMPALA@wide-lstm's shape (1024 x 16,
   H 1024, ~139 MB a batch, a spawn writer per run) with ms/update sync vs
   prefetch and one batch's host copy and H2D time (no bar);
12c. ``obs.report.main`` and ``obs.compare.main`` of the port over the
   result dir of step 12's colocated run, compared with itself: both exit
   0, no regression;
12d. the distributed runtime (``cluster_phase``, on the thread):
   ``runtime.runner.local_cluster``
   with tpu_rl's default config (PPO, CartPole-v1, H 64, seq_len 5, batch
   128; one worker machine of 2 processes, worker_num_envs 1, no worker
   throttle), twice: (a) local acting, TCP, the raw relay, 20 updates;
   (b) every act step served by the learner's InferenceService through B3,
   the manager -> storage hop over shm, 12 updates. Where gymnasium is missing, a
   stand-in ``gymnasium`` package over ``DeviceSpecEnv`` goes first on
   every child's path. Per run: the learner's exit code (0), updates/s and
   env steps/s ingested by storage (telemetry.json, storage's clock),
   the learner's host enqueue vs device ms an update (its profiler window
   over 5 updates), frames rejected (must be 0) and dropped, B1/B2
   launches = updates x K_epoch and, for (b), B3 launches = warm-ups +
   flushes with no remote-acting fallback, all read from the learner's
   closing telemetry snapshot; only the learner child holds a CUDA context
   (nvidia-smi's compute PIDs mid-run);
12d'. the inference fleet (``fleet_cluster_phase``, ``fleet_sweeps_phase``,
   ``sharded_phase``): (F1) cluster run (d), run
   (b)'s config with ``inference_replicas=2``, no hedge timer and a 20 s
   request timeout, 30 updates, ``inference-1`` stopped (SIGSTOP) from
   update 12 until the learner's replica 0 has served FLEET_HOLD_FLUSHES
   flushes in its place (the workers fail over to it), then resumed:
   every replica answers, each replica's B3 launches = its warm-ups +
   flushes, no fallback, storage's fleet gauges (``inference-1`` evicted
   and rejoined), three CUDA contexts (this process, the learner,
   ``inference-1``); (F2)
   ``tpu_rl_torch.examples.loadgen_smoke.run``: two replica processes on
   the card under 12000 synthetic clients from 2 driver processes, 100 /
   250 / 600 rps, 6 s a stage, the busier replica SIGKILLed 8 s in, held
   to tpu_rl's bars, then a sweep of 600 / 1200 / 2400 rps, 2 s a stage,
   without a kill (the saturation curve), B3 launches per replica; (F3) a replica
   sharded over ``inference_mesh_data`` 2 devices refuses on one card, and
   on two or more matches a one-device replica at the serving bar with
   one B3 launch a device a flush;
12e. data and sequence parallelism on torch.distributed (``dp_phase``,
   ``sp_phase``; one card, so none of it is a scaling number): (P1) the
   data-parallel step at IMPALA@wide-lstm, (P2) the colocated loop (10
   updates, then a run checkpointed at 5 and resumed to 8) and the
   transformer at longctx-flash width with flash, each at world size 1 over
   a one-rank NCCL group in this process against the plain path (bit for
   bit), with the wrapper's cost, the grad bytes all-reduced and the
   all-reduce's device time; then two ranks sharing the card over gloo
   (``python3 chip_smoke.py --rank R ...`` children on the thread,
   collectives staged through host memory) against world size 1 at tests/test_parallel.py's
   bars, with each rank's B1/B2 launches; (P4) ring and Ulysses attention
   over the two ranks at (16,2048,8,64) bf16 against full attention in
   f32, beside B4's and blockwise's times; (P3) the cluster with a
   two-rank learner (run (c)), B1/B2 = updates x K_epoch on every rank;
12f. the training topology (one card, so no scaling number): (S1)
   ``SebulbaLoop`` with both lanes on the card (the test seam's
   ``devices=["cuda:0", "cuda:0"]``, split 1, queue 2) at the default
   config for 100 updates: B1/B2 on the learner lane = updates x K_epoch,
   queue peak <= depth, staleness <= depth + 1, compute and queue-wait on
   both lane ledgers, the learner's state = the colocated train step
   replaying the consumed batches, bit for bit; updates/s and
   transitions/s beside ``ColocatedLoop.run``'s, the lanes' overlap; (S2)
   ``python -m tpu_rl_torch local --env-mode colocated --sebulba-split 1``
   refuses on one card naming the count (runs on two or more); (M1) the
   multihost learner as 2 hosts x 2 ranks sharing the card over gloo, each
   host's rank 0 sampling only its own store and scattering over its
   host-local group: B1/B2 = updates x K_epoch on every rank, equal params
   on every rank, within tests/test_parallel.py's bar of one card's plain
   steps on the global batches (its ranks on the thread, the plain steps
   here after it); (PBT, on the thread) a population of 2 colocated PPO
   members with member 0 poisoned, its controller a process with no CUDA
   context: an exploit whose loser resumes the copied committed checkpoint
   at a bumped epoch, B1/B2 = updates run x K_epoch in each member's
   telemetry, one context per member (nvidia-smi, /proc fds);
12g. the operations planes, on the thread: (A1) ``tpu_rl_torch.examples.autopilot_smoke``
   (its controller a process of its own) with its replicas on the card on a
   cut schedule, held to tpu_rl's autopilot bars, its controller holding no
   CUDA context, each replica process's B3 launches = its warm-ups +
   flushes, no process of it left; (X2) tpu_rl's heal smoke run 2 (a
   poisoned worker's rollouts, the other's log-probs) with the learner on
   the card: a rollback at a bumped epoch, the worker quarantined and
   released, rollout injections == storage's poisoned frames, guarded
   non-finite updates (B2 on non-finite cotangents), every broadcast
   finite, B1/B2 = updates run x K_epoch (its clean run is cut for the
   time limit); (X1) cluster run (b) under tpu_rl's chaos-smoke plan and
   a 5 ms stall of every flush, 8 updates (tpu_rl's): exit 0 at the budget, the
   killed worker respawned and audited, corruptions == rejected frames,
   delayed sends and stalled flushes, B1/B2 = updates x K_epoch, B3 =
   warm-ups + flushes with no fallback, only the learner on the card;
13. prints the ``kernels`` JSON line and, last, the ``{"ok": true, ...}`` line.

Order (the time limit, PERF.md §4): step 3's kernel rows of B3, B1/B2 and B4,
blockwise attention's and the mixed dot's run first, with nothing else on
the card. Then one thread (``beside_start``) runs every phase whose
processes hold the card, one after the other: (A1), and while it runs
(F2), the DP ranks, (M1)'s ranks, (S2) and (X2), none of which counts the
card's contexts; then, each alone, (X1), 12d, (PBT), (F1) and (P3), which
count them. Meanwhile this process runs its own phases, whose kernels it
launches and counts itself (no phase on the thread launches one here).
World size 1, (P4), (F3), (S1) and (M1)'s plain steps run after the thread.

Any failed phase raises and the script exits non-zero before the last line.
Times are CUDA-event medians on this card; each is printed beside the card's
name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32
# CUDA-core FLOP/s, dense bf16 and dense TF32 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12

# Serving configuration: the model of tpu_rl's serving benchmark
# (bench.py:1058-1082), f32 weights through the fused act kernel.
SERVE_CFG = dict(
    algo="IMPALA", obs_shape=(4,), action_space=2, hidden_size=256,
    inference_batch=256, inference_flush_us=500, inference_buckets=8,
    inference_dtype="f32", act_kernel="pallas", worker_num_envs=4,
)

# The training config: tpu_rl's defaults (PPO, CartPole-v1, H=64, S=5,
# K_epoch=1, lr 1e-4, guard and learn_diag on) at bench.py's reference
# quantum of 128 envs.
TRAIN_CFG = dict(env="CartPole-v1", env_mode="colocated", algo="PPO", colocated_envs=128)
TRAIN_WARMUP, TRAIN_UPDATES = 5, 200
# examples/colocated_smoke.py's learning recipe and bar.
LEARN_CFG = dict(
    env="CartPole-v1", env_mode="colocated", algo="PPO", batch_size=32, buffer_size=32,
    seq_len=5, lr=3e-4, entropy_coef=1e-3, reward_scale=0.1, time_horizon=500,
    loss_log_interval=200,
)
LEARN_UPDATES, LEARN_BAR, LEARN_EPISODES = 1800, 60.0, 100
# The IMPALA learning run (no bar) at half that depth since the transformer
# serving phases came in, to keep the whole run near its earlier length.
IMPALA_LEARN_UPDATES = 100  # no bar; cut from 900, then 300, for the time limit (PERF.md §4)

# (B, S, H) at which B1 and B2 are held against the plain versions: the
# training path, the learning run, a ragged batch, two wide shapes
# (tpu_rl's IMPALA@wide-lstm, bench.py:241-246) and a multihost rank's rows.
LSTM_SHAPES = [(128, 5, 64), (32, 5, 64), (100, 5, 64), (256, 16, 256), (1024, 16, 1024),
               (64, 5, 64)]  # the last: a multihost rank's rows (M1: 128 a host over 2 ranks)
LSTM_FWD_TOL, LSTM_GRAD_TOL = 1e-5, 3e-5

# (B, T, H, D, dtype, mean seams per row, shuffled ids) at which B4 is held
# against its plain versions: the main path (bench.py's
# PPO-transformer@longctx-flash; one seam per row, as the training batch
# below has), the colocated config (configs/longcontext_singlechip.example
# .json); for the bf16 tensor-core kernels, the main path's row length with
# ~1 seam (long segments: the online softmax and the backward walks over
# many tiles, most of them unmasked), a ragged T with ~50 seams (most tile
# pairs skipped, the rest masked), a small D=32 shape, and shuffled segment
# ids (not monotone: the skip rule visits every causal tile and the element
# mask does the work); the f32 split-TF32 kernels at the main path's shape
# (the longctx-flash row at tpu_rl's default f32 compute), at its row length
# (segments of ~1000 keys), a ragged shape with many segments and a small
# shape.
ATTN_SHAPES = [
    (16, 2048, 8, 64, torch.bfloat16, 1, False), (8, 4096, 8, 32, torch.bfloat16, 16, False),
    (2, 2048, 8, 64, torch.bfloat16, 1, False), (3, 1000, 4, 64, torch.bfloat16, 50, False),
    (2, 200, 3, 32, torch.bfloat16, 5, False), (2, 512, 4, 64, torch.bfloat16, 8, True),
    (16, 2048, 8, 64, torch.float32, 1, False),
    (2, 2048, 8, 64, torch.float32, 1, False), (3, 1000, 4, 64, torch.float32, 50, False),
    (2, 200, 3, 32, torch.float32, 5, False),
]
# f32: the kernel and the plain version sum in another order; absolute
# tolerances (o and lse, gradients). bf16: both compute in f32 from the same
# bf16 inputs and round once, so an element may differ by one bf16 ulp of
# itself (at most 2**-7 * |ref|), checked element by element, plus a floor of
# 2**-16 * max|ref| for the f32 sums' order near zero; lse is f32 either way.
ATTN_F32_TOL = (2e-5, 1e-4)
BF16_ULP, BF16_FLOOR = 2.0**-7, 2.0**-16

# bench.py's PPO-transformer@longctx-flash row (bench.py:291-300): the
# transformer's full-width model and batch.
TF_TRAIN_CFG = dict(
    algo="PPO", model="transformer", compute_dtype="bfloat16", attention_impl="flash",
    batch_size=16, seq_len=2048, hidden_size=512, n_heads=8, n_layers=4, obs_shape=(64,),
    action_space=8,
)
TF_WARMUP, TF_UPDATES, TF_PROFILE = 2, 10, 2
# The same row at tpu_rl's default compute dtype, float32 (the f32 B4
# kernels): its timed updates.
TF_F32_UPDATES = 5
# A small f32 flash transformer (B4's f32 kernels at head width 64) whose
# PPO step on the card is held against the CPU's at REF_TOL: 8 x 256, d128,
# 2 heads, 2 layers, seams from CartPole-like episodes.
TF_F32_REF = dict(TF_TRAIN_CFG, compute_dtype="float32", batch_size=8, seq_len=256,
                  hidden_size=128, n_heads=2, n_layers=2)
# The colocated long-context loop: one update (two until the transformer
# serving phases came in), ~4096 host-bound decode ticks.
TF_COLOCATED_UPDATES = 1
# bench.py's PPO-transformer@longctx-blockwise row (bench.py:276-284) is
# TF_TRAIN_CFG with blockwise attention; its timed updates.
TF_BLOCKWISE_UPDATES = 5
# Its attention alone, (B, T, H, D), held against full attention. bf16: each
# output within this share of its tensor's largest element (two bf16 ulps),
# against full attention in f32 on the same bf16 inputs.
BLOCKWISE_SHAPE = (16, 2048, 8, 64)
BLOCKWISE_BF16_BAR = 2.0**-6
# CartPole-like episode lengths (uniform) for segment seams and serving
# resets: a random policy's ~20 steps up to a learning one's ~200.
EPISODE_LO, EPISODE_HI = 10, 200
# The transformer's IMPALA and V-MPO: the card's step against the CPU's at
# 128 x 16 (full attention, f32: head width 16 is no B4 width), then at
# TF_TRAIN_CFG's width with flash for TF_ALGO_UPDATES timed updates.
TF_REF = dict(model="transformer", batch_size=128, seq_len=16, hidden_size=64, n_heads=4,
              n_layers=2, obs_shape=(4,), action_space=2)
TF_ALGO_UPDATES = 2
# The long-context config's depth in the colocated loop and in transformer
# serving: cut from its 4 layers to keep the smoke inside its time limit
# (PERF.md §4); widths, heads, context and every shape a layer sees are the
# config's own.
LONGCTX_LAYERS = 2
# Transformer serving: acts a client in the profiled mix-2 burst.
TF_SERVE_PROFILED = 5
# Transformer serving: the clients whose every reply is replayed through
# family.act on the card, and the replay's bar on the logits. Mix 1 runs at
# the replay's own 8 rows (the ladder's floor), so its replies must equal
# the replay bit for bit under any compute dtype; mix 2's flushes run at
# other row counts than the replay's 16, so it is replayed under f32
# compute only, at 1e-5.
TF_SERVE_KEEP = {"mix1": (0, 1), "mix2": (0, 21, 42, 63)}
TF_REPLAY_BAR = {"mix1": 0.0, "mix2": 1e-5}
# Checkpoint and resume: the default config's colocated loop saving every
# CKPT_INTERVAL updates (async), CKPT_KEEP kept, CKPT_UPDATES updates, then
# resumed to CKPT_RESUMED_TO; CKPT_SAVES saves timed each way.
CKPT_INTERVAL, CKPT_KEEP, CKPT_UPDATES, CKPT_RESUMED_TO, CKPT_SAVES = 10, 2, 30, 40, 5
# bench.py's IMPALA@wide-lstm row (bench.py:241-246): the LSTM learner at
# its widest; run with IMPALA, and with PPO as in earlier slices.
WIDE_LSTM_CFG = dict(
    algo="PPO", batch_size=1024, seq_len=16, hidden_size=1024, obs_shape=(64,), action_space=8,
)
WIDE_WARMUP, WIDE_UPDATES, WIDE_PROFILE = 2, 5, 2
# The off-policy slice: (a) the inline trainer. SAC-Continuous on
# MountainCarContinuous-v0 with examples/run_baselines.py:120-158's recipe
# (tpu_rl solves it on one CPU core in 2121-2192 updates, greedy eval
# 94.4-95.6: BASELINE_RESULTS.md:11-14) and its bar, target 90 and greedy
# >= 90, where gymnasium is installed. Else Pendulum-v1 over the port's
# device dynamics (DeviceSpecEnv), bar a 50-episode mean >= -400 within
# INLINE_CONT_DEVICE's budget: the first of 3000, 4000, ... updates at
# which tpu_rl's own trainer reaches that bar on gymnasium's Pendulum-v1
# with the same recipe and seed (5369 updates, PERF.md §6). The recipe is
# train_inline's defaults with lr 1e-3: at its 3e-4 tpu_rl's trainer stays
# far from the bar after 6000 updates (lab/inline_lab.py reruns both).
INLINE_CONT_GYM = dict(
    updates=6000, algo="SAC-Continuous", env_name="MountainCarContinuous-v0", seed=0,
    target=90.0, log_every=500, overrides=dict(
        action_repeat=8, time_horizon=999, reward_scale=0.1, lr=3e-4, buffer_size=32768,
        gamma=0.99, warmup_steps=10_000),
)
INLINE_GREEDY_BAR = 90.0
INLINE_CONT_DEVICE = dict(updates=6000, algo="SAC-Continuous", env_name="Pendulum-v1", seed=0,
                          target=-400.0, log_every=500, overrides=dict(lr=1e-3))
# SAC on CartPole-v1 (run_baselines.py's warm-up; no learning bar: tpu_rl
# needs 27k+ updates), and one inline train step timed and profiled.
INLINE_SAC = dict(updates=100, algo="SAC", env_name="CartPole-v1", seed=0, log_every=50,
                  overrides=dict(warmup_steps=2000))
INLINE_STEP_TIMED, INLINE_STEP_PROFILED = 20, 5
# (b) the data plane onto the card: a ReplayStore at the reference's replay
# capacity (BASELINE.md:20, 10240 windows) at SAC@ref's shape, and an
# OnPolicyStore at IMPALA@wide-lstm's (a pool of WIDE_FEED_POOL distinct
# windows, written in turn); the prefetch pipeline's depth.
REPLAY_FEED_CFG = dict(algo="SAC", obs_shape=(4,), action_space=2, batch_size=128, seq_len=5,
                       hidden_size=64, buffer_size=10240)
REPLAY_FEED_UPDATES = 50
WIDE_FEED_CFG = dict(WIDE_LSTM_CFG, algo="IMPALA")
WIDE_FEED_UPDATES, WIDE_FEED_POOL = 10, 64
PREFETCH_DEPTH = 2
# bench.py's @ref rows of the other algorithms (bench.py:234-239): the
# reference quantum, 128 x 5 with H 64; CartPole's spaces for the discrete
# ones, bench.py's (2,)/1 for the continuous ones.
_REF = dict(batch_size=128, seq_len=5, hidden_size=64)
REF_ROWS = {
    "IMPALA": dict(algo="IMPALA", obs_shape=(4,), action_space=2, **_REF),
    "V-MPO": dict(algo="V-MPO", obs_shape=(4,), action_space=2, **_REF),
    "SAC": dict(algo="SAC", obs_shape=(4,), action_space=2, **_REF),
    "PPO-Continuous": dict(algo="PPO-Continuous", obs_shape=(2,), action_space=1,
                           is_continuous=True, **_REF),
    "SAC-Continuous": dict(algo="SAC-Continuous", obs_shape=(2,), action_space=1,
                           is_continuous=True, **_REF),
}
# The card's step against the CPU's: tpu_rl's own bars (loss relative; the
# metrics absolute up to magnitude 1, relative above; params and moments
# absolute; 3e-5 where a gradient feeds the value directly).
REF_TOL = {"loss": 1e-5, "metrics": 1e-5, "grad-norms": 3e-5, "params": 1e-5, "moments": 3e-5}
REF_UPDATES = 10
# B1 / B2 launches per epoch of each train step: one unroll and its
# backward for the shared-torso algorithms; SAC's as counted in
# tpu_rl_torch/algos/sac.py (the actor twice, the twin critic under the
# actor loss, the target twin with no grad, the twin critic with grad).
LAUNCHES_PER_EPOCH = {"PPO": (1, 1), "IMPALA": (1, 1), "V-MPO": (1, 1), "PPO-Continuous": (1, 1),
                      "SAC": (8, 3), "SAC-Continuous": (8, 5)}
# The other on-policy algorithms in the colocated loop, at the training
# phase's 128 envs (Pendulum: gymnasium's 200-step horizon).
COLOCATED_ALGOS = [("CartPole-v1", "IMPALA", {}), ("CartPole-v1", "V-MPO", {}),
                   ("Pendulum-v1", "PPO-Continuous", dict(time_horizon=200))]
COLOCATED_UPDATES = 2
# Checkpoint and resume: the default config's colocated loop saving every
# CKPT_INTERVAL updates (async), CKPT_KEEP kept, CKPT_UPDATES updates, then
# resumed to CKPT_RESUMED_TO; CKPT_SAVES saves timed each way.
CKPT_INTERVAL, CKPT_KEEP, CKPT_UPDATES, CKPT_RESUMED_TO, CKPT_SAVES = 10, 2, 30, 40, 5

# The telemetry plane: the training config's colocated loop with the plane
# on (result_dir, an HTTP port, the SLO rules below, the diag accumulator
# and the history store) for TELEMETRY_UPDATES updates, a log tick every
# TELEMETRY_LOG; ms/update with the plane on and off over TELEMETRY_TIMED
# updates each, in turns; IMPALA at bench.py's wide-lstm width on CartPole
# (the colocated loop needs a device env: obs 4, 2 actions), 2 warm-up and 5
# timed updates; serving mix 1 with the plane on and off, in turns.
TELEMETRY_UPDATES, TELEMETRY_LOG, TELEMETRY_TIMED = 30, 10, 50  # timed cut from 100
# the serving turns' mix 1, cut from 1000 acts a client (PERF.md §4)
TELEMETRY_SERVE_MIX = ((2, 500, "mix1"),)
TELEMETRY_SLO = ("gauge:colocated-updates-per-s>0,gauge:colocated-mfu>0,"
                 "counter:colocated-xla-recompiles==0")
WIDE_COLOCATED_CFG = dict(env="CartPole-v1", env_mode="colocated", algo="IMPALA",
                          colocated_envs=1024, seq_len=16, hidden_size=1024)
WIDE_COLOCATED_WARMUP, WIDE_COLOCATED_UPDATES = 2, 5

# Serving traffic: 2 x 4 x 1000 is bench.py's chip default (mix 1);
# 64 x 4 x 100 fills the 256-row bucket (mix 2). bf16/int8 serving runs
# mix 1.
SERVE_MIXES = ((2, 1000, "mix1"), (64, 100, "mix2"))
# The transformer's mixes, cut to keep the smoke inside its time limit: mix
# 1 to 600 acts a client (the window oracle still reads act_ctx, 512,
# steps), mix 2 to 50.
TF_SERVE_MIXES = ((2, 600, "mix1"), (64, 50, "mix2"))
SERVE_DTYPES = ("bf16", "int8")
# tests/test_quant.py:140-157's bars for bf16/int8 serving against f32 on
# its margin-scaled head (_margin_params: the logits head x 4, 512 rows):
# argmax agreement, and mean |log-prob drift| per mode.
QUANT_AGREE, QUANT_DRIFT = 0.99, {"bf16": 0.05, "int8": 0.08}

# (rows, D, H, A) checked against the plain version.
SERVING_LADDER = [(b, 4, 256, 2) for b in (8, 16, 32, 64, 128, 256)]
RAGGED = [(b, 4, 256, 2) for b in (1, 3, 100)]
# the default config's model; 64 rows is the cluster's remote-acting flush
# (inference_batch 64, one padded bucket)
DEFAULT_MODEL = [(b, 4, 64, 2) for b in (8, 64, 128)]
WIDE_MODEL = [(256, 64, 1024, 8)]
# Beside those: H=100 (13 unit slices, the last of 4 units) and H=50 (not a
# multiple of 4: the kernel's 4-byte-copy path; the last slice of 2 units).
EDGE = [(8, 4, 100, 3), (3, 6, 50, 5)]
# the load sweeps' replicas (examples/loadgen_smoke.fleet_config: H 32, buckets
# 8 and 16)
LOADGEN_MODEL = [(b, 4, 32, 2) for b in (8, 16)]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    if threading.current_thread() is not threading.main_thread():
        raise SystemExit(1)  # a phase on a thread: its owner fails the run
    if ADOPTING:
        left = stop_leftovers()
        if left:
            print(f"chip_smoke: stopped {len(left)} leftover processes: {left}", file=sys.stderr)
    sys.exit(1)


# --------------------------------------------------------------- processes
ADOPTING = False  # set by adopt_orphans()
PR_SET_CHILD_SUBREAPER = 36


def children_of(pid: int) -> list[int]:
    """The PIDs whose parent is ``pid``, read from /proc."""
    kids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            stat = Path(f"/proc/{d}/stat").read_text()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            kids.append(int(d))
    return kids


def proc_state(pid: int) -> str | None:
    """``pid``'s state letter from /proc (``Z``: ended, not yet reaped), or
    None when there is no such process."""
    try:
        return Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except (OSError, IndexError):
        return None


def running(pid: int) -> bool:
    """Whether ``pid`` exists and has not ended (a zombie has ended)."""
    return proc_state(pid) not in (None, "Z", "X")


def subtree(pid: int) -> list[int]:
    """Every descendant of ``pid``, read from /proc."""
    out, todo = [], [pid]
    while todo:
        kids = children_of(todo.pop())
        out += kids
        todo += kids
    return out


def adopt_orphans() -> None:
    """Make this process the subreaper of every process the run starts
    (``prctl(PR_SET_CHILD_SUBREAPER)``, an attribute of this process alone):
    a process whose parent ends first is re-parented here rather than to
    init, so :func:`stop_leftovers` still finds it."""
    global ADOPTING
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        fail(f"prctl(PR_SET_CHILD_SUBREAPER) failed: errno {ctypes.get_errno()}")
    ADOPTING = True
    main_pid = os.getpid()

    def stopped_by(signum, frame):
        # a stop from outside (a time limit's SIGTERM) takes the run's
        # processes with it; a forked child restores the default action
        if os.getpid() != main_pid:
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        print(f"chip_smoke: stopped by signal {signum}", file=sys.stderr, flush=True)
        left = stop_leftovers(grace_s=2.0)
        print(f"chip_smoke: stopped {len(left)} processes: {left}", file=sys.stderr, flush=True)
        os._exit(128 + signum)

    for signum in (signal.SIGTERM, signal.SIGHUP):
        signal.signal(signum, stopped_by)


def cmdline(pid: int) -> str:
    """``pid``'s command line from /proc (cut to 300 characters), or ``?``."""
    try:
        return Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ").decode(
            errors="replace").strip()[:300]
    except OSError:
        return "?"


def stop_leftovers(grace_s: float = 5.0) -> list[dict]:
    """Stop every process of the run that is still running: the
    descendants of this process (orphans included, see
    :func:`adopt_orphans`) but multiprocessing's resource tracker, which
    ends with this process. SIGCONT and SIGTERM, then SIGKILL after
    ``grace_s``, in rounds, since a stopped parent's own children come
    here next. Returns what it found: pid, command line."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker._pid
    found: dict[int, dict] = {}
    for _round in range(5):
        live = [p for p in subtree(os.getpid()) if p != tracker and running(p)]
        if not live:
            break
        for p in live:
            found.setdefault(p, dict(pid=p, cmd=cmdline(p)))
            for sig in (signal.SIGCONT, signal.SIGTERM):
                try:
                    os.kill(p, sig)
                except ProcessLookupError:
                    pass
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline and any(running(p) for p in live):
            time.sleep(0.1)
        for p in live:
            if running(p):
                try:
                    os.kill(p, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                found[p]["killed"] = True
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline and any(running(p) for p in live):
            time.sleep(0.1)
    # reap what has ended here (orphans re-parented to this process among
    # them), so that none outlives the run as a zombie
    for p in children_of(os.getpid()):
        if proc_state(p) == "Z":
            try:
                os.waitpid(p, os.WNOHANG)
            except ChildProcessError:
                pass
    return list(found.values())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
def device_ms(fn, iters: int = 100, reps: int = 3, warmup: int = 10) -> float:
    """Median device time of one ``fn()`` call, in ms. A busy-wait kernel is
    queued first so that the host has enqueued all ``iters`` calls before
    the card reaches the start event: the events then time the card's work
    back to back, not Python's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # cycles to cover twice the host's enqueue time at up to 2 GHz
    sleep_cycles = int(max(host_s, 1e-3) * 2 * 2e9)
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def bound(B: int, D: int, H: int, A: int) -> tuple[float, str]:
    """Least time (ms) of one fused act step on an H100: the larger of its
    bytes (each input read once, each output written once) over HBM's rate
    and its operations (the three products' multiply-adds, 2 each) over the
    f32 peak."""
    weights = H * D + H + 4 * H * H + 4 * H + H * 4 * H + A * H + A
    floats = weights + B * D + 2 * B * H + B * A + 2 * B * H
    t_bytes = 4 * floats / HBM_BYTES_PER_S
    t_ops = 2 * B * (D * H + 8 * H * H + H * A) / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def seeded_params(family, seed: int) -> dict:
    """The port's own init from ``seed``, then every bias filled with seeded
    N(0, 0.1^2) values: the init zeroes biases, a trained policy's are not,
    and the kernel's bias terms must be held to the plain version too."""
    g = torch.Generator().manual_seed(seed)
    params = family.init_params(g)
    for name, t in params["actor"].items():
        if name.endswith(".bias"):
            t.copy_(0.1 * torch.randn(t.shape, generator=g))
    return params


# ------------------------------------------------------- kernel vs plain
def kernel_phase() -> list[dict]:
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.models.families import build_family
    from tpu_rl_torch.models.quant import make_act_fn
    from tpu_rl_torch.ops import fused_act as FA

    rows = []
    for B, D, H, A in SERVING_LADDER + RAGGED + DEFAULT_MODEL + WIDE_MODEL + EDGE + LOADGEN_MODEL:
        cfg = Config.from_dict({"hidden_size": H, "obs_shape": (D,), "action_space": A})
        family = build_family(cfg, device="cuda")
        params = seeded_params(family, 0)
        p = params["actor"]
        g = torch.Generator().manual_seed(B * 1000 + H)
        obs, h, c = (torch.randn(s, generator=g).cuda() for s in ((B, D), (B, H), (B, H)))
        got = FA.fused_act_step(p, obs, h, c)
        torch.cuda.synchronize()
        want = FA.fused_act_step_plain(p, obs, h, c)
        err = max(float((x - y).abs().max()) for x, y in zip(got, want, strict=True))
        # f32 FMAs on both sides, summed in another order: 1e-5 holds up to
        # H=256; at H=1024 each gate sums 2048 products, so the rounding of
        # the two orders can differ by a few 1e-6 more.
        tol = 1e-5 if H <= 256 else 1e-4
        if not (err <= tol and all(bool(torch.isfinite(x).all()) for x in got)):
            fail(f"fused act kernel vs plain at {(B, D, H, A)}: max abs err {err} > {tol}")
        gen = torch.Generator("cuda").manual_seed(0)
        fused_act = make_act_fn(cfg.replace(act_kernel="pallas"), family)
        kernel_ms = device_ms(lambda: FA.fused_act_step(p, obs, h, c))
        plain_ms = device_ms(lambda: FA.fused_act_step_plain(p, obs, h, c))
        unfused_ms = device_ms(lambda: family.act(params, obs, h, c, gen))
        # the service's whole act step: the kernel, then sampling and log-prob
        act_ms = device_ms(lambda: fused_act(params, obs, h, c, gen))
        bound_ms, bound_by = bound(B, D, H, A)
        plan = FA.act_launch_plan(B, D, H, A)
        plan_d = dict(
            rows=plan.rows, units=plan.units, cluster=plan.cluster, row_tiles=plan.row_tiles,
            tm=plan.tm, ksplit=plan.ksplit, stages=plan.stages, threads=plan.threads,
            smem=plan.smem, tma=plan.tma, push=plan.push,
            max_active_clusters=FA.max_active_clusters(plan),
        )
        row = dict(
            shape=dict(rows=B, D=D, H=H, A=A), max_abs_err=err, tol=tol,
            kernel_ms=kernel_ms, plain_ms=plain_ms, unfused_ms=unfused_ms, act_ms=act_ms,
            bound_ms=bound_ms, bound_by=bound_by, plan=plan_d,
        )
        rows.append(row)
        print(
            f"fused_act plan rows={B} D={D} H={H} A={A}: {plan.row_tiles} tiles of "
            f"R={plan.rows} rows x cluster of {plan.cluster} blocks of U={plan.units} units "
            f"({plan.blocks} blocks, {plan.threads} threads, tm={plan.tm}, ksplit={plan.ksplit}, "
            f"{plan.stages} stages, {plan.smem} B shared, tma={plan.tma}, push={plan.push}); "
            f"card holds {plan_d['max_active_clusters']} such clusters at once",
            flush=True,
        )
        print(
            f"fused_act rows={B} D={D} H={H} A={A}: max_abs_err={err:.3e} (tol {tol:g}) "
            f"kernel_ms={kernel_ms:.6f} plain_ms={plain_ms:.6f} "
            f"unfused_ms={unfused_ms:.6f} act_ms={act_ms:.6f} "
            f"bound_ms={bound_ms:.6f} ({bound_by})",
            flush=True,
        )
    return rows


# ----------------------------------------------------------------- serving
def drive(cfg, router, n_clients: int, envs: int, acts: int, tag: str, streams=None,
          keep=(), carry: bool = True) -> dict:
    """``n_clients`` threads, each one client of ``envs`` env rows, each
    sending ``acts`` timed ObsRequests: ``streams(k)``'s obs (acts, envs, D)
    and firsts (acts, envs) for client ``k``, or, without ``streams``, one
    untimed priming act with ``first`` set, then its obs with ``first``
    clear. Checks every reply's shapes, finiteness and log-prob, and that it
    carries the pre-step carry iff ``carry``; keeps the replies of the
    clients in ``keep``."""
    barrier = threading.Barrier(n_clients + 1)
    failures = [0] * n_clients
    bad = [0] * n_clients
    lat: list[list[float]] = [[] for _ in range(n_clients)]
    kept: dict[int, list] = {k: [] for k in keep}
    A = int(cfg.action_space)

    def check(reply) -> bool:
        act = reply["act"]
        logits = reply["logits"]
        lp = reply["log_prob"]
        if act.shape != (envs, 1) or logits.shape != (envs, A) or lp.shape != (envs, 1):
            return False
        if ("hx" in reply) != carry or not (np.isfinite(logits).all() and np.isfinite(lp).all()):
            return False
        idx = act[:, 0].astype(np.int64)
        if idx.min() < 0 or idx.max() >= A:
            return False
        picked = logits[np.arange(envs), idx]
        return bool(np.allclose(lp[:, 0], picked, atol=1e-6, rtol=0)) and bool(
            np.allclose(np.exp(logits).sum(-1), 1.0, atol=1e-5)
        )

    def run(k: int) -> None:
        cl = router.client(f"{tag}-{k}".encode())
        if streams is None:
            rng = np.random.default_rng(k)
            obs = rng.standard_normal((envs, int(cfg.obs_shape[0]))).astype(np.float32)
            reply = cl.act(obs, np.ones(envs, np.float32))
            if reply is None or not check(reply):
                failures[k] += 1
            obs_t, first_t = [obs] * acts, [np.zeros(envs, np.float32)] * acts
        else:
            obs_t, first_t = streams(k)
        barrier.wait()
        for t in range(acts):
            t0 = time.perf_counter()
            reply = cl.act(obs_t[t], first_t[t])
            lat[k].append(time.perf_counter() - t0)
            if reply is None:
                failures[k] += 1
                continue
            if not check(reply):
                bad[k] += 1
            if k in kept:
                kept[k].append(reply)

    threads = [threading.Thread(target=run, args=(k,), daemon=True) for k in range(n_clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    all_lat = sorted(x for ks in lat for x in ks)
    return dict(
        clients=n_clients, envs=envs, acts=acts,
        acts_per_s=n_clients * acts * envs / dt,
        p50_ms=all_lat[int(0.50 * (len(all_lat) - 1))] * 1e3,
        p99_ms=all_lat[int(0.99 * (len(all_lat) - 1))] * 1e3,
        client_failures=sum(failures), bad_replies=sum(bad), kept=kept,
    )


def serve_phase(device: str = "cuda", profile: bool = False, dtype: str = "f32",
                mixes: tuple = SERVE_MIXES, telemetry: bool = False) -> dict:
    """The main path: an InferenceService on ``device`` over a LocalRouter,
    serving at ``inference_dtype=dtype`` (f32, bf16 or int8: the weights
    widened to f32 inside each act step, before B3). Returns the traffic
    results, the fused kernel's launch count over the whole run, in all and
    by row count, and the service's counters. With ``profile`` the run goes
    under the profiler (device activity only), and B3's device time over the
    run is read from its kernel records; the profiler slows the host, so
    the timed run goes without it. With ``telemetry`` the service runs with
    the plane on (a result_dir), and the result holds what
    ``publish_serving_metrics`` put in a registry, each bucket's FLOPs per
    act step and the largest bucket's achieved FLOP/s and MFU."""
    import tempfile

    from tpu_rl_torch.config import Config
    from tpu_rl_torch.models.families import build_family
    from tpu_rl_torch.models.quant import dequantize_tree, quantize_tree
    from tpu_rl_torch.obs import MetricsRegistry
    from tpu_rl_torch.ops import fused_act as FA
    from tpu_rl_torch.runtime.inference_service import InferenceService
    from tpu_rl_torch.runtime.local_router import LocalRouter
    from tpu_rl_torch.utils.timer import ExecutionTimer

    result_dir = tempfile.mkdtemp(prefix="tpu_rl_serve_") if telemetry else None
    cfg = Config.from_dict(dict(SERVE_CFG, inference_dtype=dtype, result_dir=result_dir))
    family = build_family(cfg, device=device)
    params = seeded_params(family, 0)
    router = LocalRouter()

    def served_cpu(p):
        """The actor the service acts with, widened, on the CPU."""
        return {k: v.cpu() for k, v in dequantize_tree(quantize_tree(p, dtype))["actor"].items()}

    # A window that holds every flush of a mix, for the mean flush time.
    timer = ExecutionTimer(window=1_000_000)
    # B3's device time over the whole run: warm-ups, both mixes, the probe.
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile

        try:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        except (RuntimeError, AttributeError) as e:
            print(f"serving profile: not measured ({e!r})", flush=True)
            prof = None
    FA.LAUNCHES = 0  # every launch from here on is the main path's
    FA.LAUNCHES_BY_ROWS.clear()
    svc = InferenceService(cfg, family, params, router, timer, seed=0, device=device).start()
    try:
        if not svc.wait_ready(300.0) or svc.error is not None:
            fail(f"inference service did not start: {svc.error!r}")
        results = []
        for n_clients, acts, tag in mixes:
            timer.elapsed.clear()
            timer.gauges.clear()
            mix = drive(cfg, router, n_clients, 4, acts, tag)
            # host clock around staging, H2D, act step, D2H sync and replies
            mix["flush_ms"] = timer.mean_elapsed("inference-step-time") * 1e3
            mix["flush_rows"] = timer.mean_gauge("inference-batch-size")
            results.append(mix)

        # Carry persistence and the parameter swap, from one probe client
        # while no other traffic flows (so its flushes hold only its rows).
        probe = router.client(b"probe")
        rng = np.random.default_rng(99)
        obs1, obs2 = (rng.standard_normal((4, 4)).astype(np.float32) for _ in range(2))
        r1 = probe.act(obs1, np.ones(4, np.float32))
        r2 = probe.act(obs2, np.zeros(4, np.float32))
        if r1 is None or r2 is None:
            fail("probe client got no reply")
        zeros = torch.zeros((4, cfg.hidden_size))
        cpu_actor = served_cpu(params)
        _lg, h2, c2 = FA.fused_act_step_plain(cpu_actor, torch.from_numpy(obs1), zeros, zeros)
        carry_err = max(
            float(np.abs(r1["hx"]).max()), float(np.abs(r1["cx"]).max()),
            float(np.abs(r2["hx"] - h2.numpy()).max()), float(np.abs(r2["cx"] - c2.numpy()).max()),
        )
        if carry_err > 1e-5:
            fail(f"server-side carry: reply 2's hx/cx differ from reply 1's post-step carry by {carry_err}")
        # one flush's replies against the unfused act (family.act) on the
        # widened tree the service serves
        deq = {"actor": {k: v.to(device) for k, v in cpu_actor.items()}}
        dz = torch.zeros((4, cfg.hidden_size), device=device)
        _a, lg_u, _lp, h2_u, c2_u = family.act(deq, torch.from_numpy(obs1).to(device), dz, dz)
        unfused_err = max(
            float(np.abs(r1["logits"] - lg_u.cpu().numpy()).max()),
            float(np.abs(r2["hx"] - h2_u.cpu().numpy()).max()),
            float(np.abs(r2["cx"] - c2_u.cpu().numpy()).max()),
        )
        if unfused_err > 1e-5:
            fail(f"{dtype} serving: a flush's replies differ from family.act on the widened tree "
                 f"by {unfused_err}")

        new = seeded_params(family, 1)
        svc.set_params(new, version=7)
        r3 = probe.act(obs1, np.ones(4, np.float32))
        if r3 is None or r3["ver"] != 7:
            fail(f"after set_params(version=7) the reply says ver={None if r3 is None else r3['ver']}")
        if np.allclose(r3["logits"], r1["logits"], atol=1e-4):
            fail("set_params did not change the served policy")
        want, _h, _c = FA.fused_act_step_plain(served_cpu(new), torch.from_numpy(obs1), zeros, zeros)
        swap_err = float(np.abs(r3["logits"] - want.numpy()).max())
        if swap_err > 1e-5:
            fail(f"swapped policy's logits differ from the plain version by {swap_err}")
        plane = None
        if telemetry:
            reg = MetricsRegistry(role="inference")
            svc.publish_serving_metrics(reg)
            snap = reg.snapshot()
            plane = dict(
                recompiles=next(e[2] for e in snap["counters"]
                                if e[0] == "inference-xla-recompiles"),
                bucket_flushes={int(e[1]["rows"]): int(e[2]) for e in snap["counters"]
                                if e[0] == "inference-bucket-flushes"},
                flops_per_act_step={r: t.flops_per_call for r, t in svc.perf_buckets.items()},
                achieved_flops={r: t.achieved_flops_per_s() for r, t in svc.perf_buckets.items()},
                mfu={r: t.mfu() for r, t in svc.perf_buckets.items()},
                goodput=svc.ledger.snapshot()["ratios"],
            )
    finally:
        svc.close()
        if prof is not None:
            torch.cuda.synchronize()
            prof.stop()
    launches, by_rows = FA.LAUNCHES, dict(sorted(FA.LAUNCHES_BY_ROWS.items()))
    if svc.error is not None:
        fail(f"inference service died: {svc.error!r}")
    b3_ms = b3_records = None
    if prof is not None:
        b3 = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and "fused_act_kernel" in e.key]
        if b3:
            b3_ms = sum(e.self_device_time_total for e in b3) / 1e3
            b3_records = sum(e.count for e in b3)
    return dict(
        dtype=dtype, param_bytes=svc.param_bytes, unfused_err=unfused_err,
        mixes=results, launches=launches, launches_by_rows=by_rows, b3_device_ms=b3_ms,
        b3_kernel_records=b3_records, warmups=len(svc.buckets), flushes=svc.n_batches,
        buckets=svc.buckets, n_flush_bucket=dict(sorted(svc.n_flush_bucket.items())),
        n_requests=svc.n_requests, n_replies=svc.n_replies,
        n_flush_full=svc.n_flush_full, n_flush_deadline=svc.n_flush_deadline,
        n_rejected_payload=svc.n_rejected_payload, carry_err=carry_err, swap_err=swap_err,
        telemetry=plane,
    )

def serving_checks(serving: dict, tag: str, card: str) -> None:
    """Print one serving run and fail unless every request was answered
    with a well-formed reply and B3 launched once per warm-up and flush, at
    each bucket (counted where the wrapper launches)."""
    for mix in serving["mixes"]:
        print(
            f"{tag} {mix['clients']} clients x {mix['envs']} envs x {mix['acts']} acts: "
            f"acts/s={mix['acts_per_s']:.1f} p50_ms={mix['p50_ms']:.4f} "
            f"p99_ms={mix['p99_ms']:.4f} flush_ms={mix['flush_ms']:.4f} "
            f"flush_rows={mix['flush_rows']:.1f} client_failures={mix['client_failures']} "
            f"bad_replies={mix['bad_replies']} [{card}]",
            flush=True,
        )
    print(
        f"{tag} inference_dtype={serving['dtype']} param_bytes={serving['param_bytes']} "
        f"(tree_bytes) unfused err {serving['unfused_err']:.3e}",
        flush=True,
    )
    print(
        f"{tag} flushes per bucket {serving['n_flush_bucket']} "
        f"(full {serving['n_flush_full']}, deadline {serving['n_flush_deadline']}); "
        f"requests {serving['n_requests']} replies {serving['n_replies']}; "
        f"fused_act launches {serving['launches']} = warm-ups {serving['warmups']} "
        f"+ flushes {serving['flushes']}, by bucket {serving['launches_by_rows']}; "
        f"carry err {serving['carry_err']:.3e}, swap err {serving['swap_err']:.3e}",
        flush=True,
    )
    for mix in serving["mixes"]:
        if mix["client_failures"] or mix["bad_replies"]:
            fail(f"{tag} mix {mix}: requests unanswered or replies malformed")
    if serving["n_replies"] != serving["n_requests"] or serving["n_rejected_payload"]:
        fail(f"{tag}: replies {serving['n_replies']} != requests {serving['n_requests']}")
    if serving["launches"] != serving["warmups"] + serving["flushes"]:
        fail(f"{tag}: fused_act.LAUNCHES is not warm-ups plus flushes")
    if serving["launches"] == 0:
        fail(f"{tag}: the main path never launched the fused act kernel")
    by_rows = serving["launches_by_rows"]
    for rows in serving["buckets"]:
        if by_rows.get(rows, 0) != serving["n_flush_bucket"].get(rows, 0) + 1:
            fail(f"{tag}: bucket {rows}: {by_rows.get(rows, 0)} B3 launches, want its "
                 "flushes + 1 warm-up")
    if set(by_rows) - set(serving["buckets"]):
        fail(f"{tag}: B3 launched at row counts that are not buckets: {by_rows}")


def serving_b3_time(shapes: list[dict], profiled: dict, card: str) -> None:
    """B3's device time over the profiled serving run, beside an estimate:
    each bucket's kernel-phase time x that bucket's launches."""
    ladder = {r["shape"]["rows"]: r["kernel_ms"] for r in shapes
              if r["shape"]["H"] == 256 and r["shape"]["D"] == 4}
    estimate = sum(n * ladder[rows] for rows, n in profiled["launches_by_rows"].items())
    if profiled["b3_device_ms"] is None:
        print(f"serving B3 device time: not measured (estimate {estimate:.6f} ms)", flush=True)
        return
    if profiled["b3_kernel_records"] != profiled["launches"]:
        fail(f"the profiler saw {profiled['b3_kernel_records']} B3 kernels, the wrapper "
             f"counted {profiled['launches']} launches")
    print(f"serving B3 device time: {profiled['b3_device_ms']:.6f} ms over "
          f"{profiled['b3_kernel_records']} kernels (profiled run; estimate from the kernel "
          f"phase {estimate:.6f} ms) [{card}]", flush=True)


# ------------------------------------------------------------ LSTM kernels
def lstm_bounds(B: int, S: int, H: int) -> dict:
    """Least time (ms) of B1 and B2 on an H100, and what bounds each: the
    larger of the bytes each must move (inputs read once, outputs written
    once) over HBM's rate and its recurrent product's multiply-adds
    (2*B*S*H*4H operations) over the f32 peak."""
    G = 4 * H
    seq, rows = B * S, B
    fwd = 4 * (seq * G + H * G + 2 * rows * H + seq + 2 * seq * H + seq * G)
    bwd = 4 * (seq * G + 3 * seq * H + rows * H + seq + G * H + seq * G + 2 * rows * H)
    t_ops = 2 * B * S * H * G / F32_FLOPS_PER_S
    out = {}
    for name, nbytes in (("lstm_fwd", fwd), ("lstm_bwd", bwd)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[name] = dict(
            bytes=nbytes, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
    return out


def cudnn_lstm_ms(B: int, S: int, H: int, iters: int) -> dict:
    """A yardstick, not a ``library_ms``: cuDNN's LSTM (``nn.LSTM``, TF32
    off) forward and forward + backward on (B, S, H) inputs with no carry
    resets (no PyTorch call computes the keep-masked LSTM) and its own
    input projection from H inputs."""
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(B + S + H)
    lstm = torch.nn.LSTM(H, H, batch_first=True).cuda()
    x = torch.randn((B, S, H), generator=g).cuda().requires_grad_()
    h0, c0 = (torch.randn((1, B, H), generator=g).cuda() for _ in range(2))
    dy = torch.randn((B, S, H), generator=g).cuda()

    def fwd_bwd():
        y, _ = lstm(x, (h0, c0))
        return torch.autograd.grad(y, [x, *lstm.parameters()], dy)

    with torch.no_grad():
        fwd = device_ms(lambda: lstm(x, (h0, c0)), iters=iters)
    return dict(fwd_ms=fwd, fwd_bwd_ms=device_ms(fwd_bwd, iters=iters))


def max_err(got, want) -> float:
    return float((got.detach().float() - want.detach().float()).abs().max())


def lstm_phase() -> list[dict]:
    """B1 and B2 against their plain versions at LSTM_SHAPES, and the whole
    autograd Function (both kernels plus the dwh product) against the plain
    backward. The inputs are at the scales of the training path: lecun-scale
    wh, unit xp, carries and cotangents, and a keep mask with ~20% resets
    (every row reset at step 0 on half the rows)."""
    from tpu_rl_torch.ops import lstm as L

    rows = []
    for B, S, H in LSTM_SHAPES:
        g = torch.Generator().manual_seed(B * 7 + S * 3 + H)
        rnd = lambda *shape: torch.randn(shape, generator=g).cuda()  # noqa: E731
        xp, h0, c0 = rnd(B, S, 4 * H), rnd(B, H), rnd(B, H)
        wh = rnd(H, 4 * H) / H**0.5
        keep = (torch.rand((B, S), generator=g) >= 0.2).float()
        keep[: B // 2, 0] = 0.0
        keep = keep.cuda()
        dhs, dcs = rnd(B, S, H), rnd(B, S, H)

        hs, cs, acts = L.lstm_fwd(xp, wh, h0, c0, keep)
        dxp, dh0, dc0 = L.lstm_bwd(wh, h0, c0, keep, hs, cs, acts, dhs, dcs)
        torch.cuda.synchronize()
        hs_p, cs_p, acts_p = L.lstm_forward_plain(xp, wh, h0, c0, keep)
        dxp_p, dwh_p, dh0_p, dc0_p = L.lstm_backward_plain(wh, h0, c0, keep, hs_p, cs_p, acts_p, dhs, dcs)
        fwd_err = max(max_err(hs, hs_p), max_err(cs, cs_p), max_err(acts, acts_p))
        bwd_err = max(max_err(dxp, dxp_p), max_err(dh0, dh0_p), max_err(dc0, dc0_p))

        # The autograd Function end to end: B1, B2 and the dwh product.
        leaves = [t.clone().requires_grad_() for t in (xp, wh, h0, c0)]
        hs_f, cs_f = L.lstm_unroll(*leaves, keep)
        grads = torch.autograd.grad((hs_f, cs_f), leaves, (dhs, dcs))
        torch.cuda.synchronize()
        fn_err = max(
            max_err(hs_f, hs_p), max_err(grads[0], dxp_p), max_err(grads[2], dh0_p),
            max_err(grads[3], dc0_p),
        )
        dwh_err = max_err(grads[1], dwh_p)
        # dwh is a (B*S)-deep contraction, summed in another order by the
        # product and by the plain per-step loop: its rounding grows with
        # its magnitude, so its tolerance is relative to its largest entry.
        dwh_scale = max(1.0, float(dwh_p.abs().max()))
        dwh_tol = LSTM_GRAD_TOL * dwh_scale
        finite = all(bool(torch.isfinite(t).all()) for t in (hs, cs, acts, dxp, dh0, dc0, grads[1]))
        if not (finite and fwd_err <= LSTM_FWD_TOL and bwd_err <= LSTM_GRAD_TOL
                and fn_err <= LSTM_GRAD_TOL and dwh_err <= dwh_tol):
            fail(
                f"LSTM kernels vs plain at (B,S,H)={(B, S, H)}: fwd {fwd_err} (tol {LSTM_FWD_TOL}), "
                f"bwd {bwd_err} / Function {fn_err} (tol {LSTM_GRAD_TOL}), dwh {dwh_err} "
                f"(tol {dwh_tol}), finite {finite}"
            )

        iters = 100 if B * S * H <= 100_000 else 10
        # the plain versions, ~1-3 ms of host launches a call, on fewer calls
        # a sample (the smoke's time limit)
        plain_iters = max(5, iters // 5)
        fwd_ms = device_ms(lambda: L.lstm_fwd(xp, wh, h0, c0, keep), iters=iters)
        fwd_plain_ms = device_ms(lambda: L.lstm_forward_plain(xp, wh, h0, c0, keep),
                                 iters=plain_iters)
        bwd_ms = device_ms(lambda: L.lstm_bwd(wh, h0, c0, keep, hs, cs, acts, dhs, dcs), iters=iters)
        bwd_plain_ms = device_ms(
            lambda: L.lstm_backward_plain(wh, h0, c0, keep, hs, cs, acts, dhs, dcs),
            iters=plain_iters,
        )
        # The autograd Function's forward + backward (B1, B2 and the dwh
        # product) beside the plain pair's.
        fn_ms = device_ms(
            lambda: torch.autograd.grad(L.lstm_unroll(*leaves, keep), leaves, (dhs, dcs)),
            iters=iters,
        )

        def plain_pair():
            hs_q, cs_q, acts_q = L.lstm_forward_plain(xp, wh, h0, c0, keep)
            return L.lstm_backward_plain(wh, h0, c0, keep, hs_q, cs_q, acts_q, dhs, dcs)

        pair_ms = device_ms(plain_pair, iters=plain_iters)
        cudnn = cudnn_lstm_ms(B, S, H, iters)
        plan = L.lstm_launch_plan(B, S, H)
        resident = L.max_active_clusters(plan)
        bounds = lstm_bounds(B, S, H)
        row = dict(
            shape=dict(B=B, S=S, H=H),
            fwd_err=fwd_err, bwd_err=bwd_err, function_err=fn_err, dwh_err=dwh_err, dwh_tol=dwh_tol,
            lstm_fwd=dict(ms=fwd_ms, plain_ms=fwd_plain_ms, **bounds["lstm_fwd"]),
            lstm_bwd=dict(ms=bwd_ms, plain_ms=bwd_plain_ms, **bounds["lstm_bwd"]),
            function_ms=fn_ms, plain_pair_ms=pair_ms, cudnn_yardstick=cudnn,
            plan=dict(rows=plan.rows, units=plan.units, cluster=plan.cluster,
                      row_tiles=plan.row_tiles, threads=plan.threads, regime=plan.regime,
                      clusters_resident=resident),
        )
        rows.append(row)
        print(
            f"lstm plan B={B} S={S} H={H}: {plan.regime}, R={plan.rows} rows x U={plan.units} "
            f"units a block, cluster {plan.cluster}, {plan.row_tiles} clusters, {plan.threads} "
            f"threads, tile {plan.tm}x{plan.tu}, smem {plan.smem_fwd}/{plan.smem_bwd} bytes, "
            f"{resident} clusters resident on the card",
            flush=True,
        )
        print(
            f"lstm Function B={B} S={S} H={H}: forward+backward {fn_ms:.6f} ms, plain pair "
            f"{pair_ms:.6f} ms; yardstick, not library_ms (no resets, its own input projection): "
            f"cuDNN LSTM forward {cudnn['fwd_ms']:.6f} ms, forward+backward "
            f"{cudnn['fwd_bwd_ms']:.6f} ms",
            flush=True,
        )
        for name in ("lstm_fwd", "lstm_bwd"):
            r = row[name]
            print(
                f"{name} B={B} S={S} H={H}: kernel_ms={r['ms']:.6f} plain_ms={r['plain_ms']:.6f} "
                f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}, {r['bytes']} bytes)",
                flush=True,
            )
        print(
            f"lstm B={B} S={S} H={H}: max_abs_err hs/cs/acts {fwd_err:.3e} (tol {LSTM_FWD_TOL:g}), "
            f"dxp/dh0/dc0 {bwd_err:.3e} (tol {LSTM_GRAD_TOL:g}), Function {fn_err:.3e}, "
            f"dwh {dwh_err:.3e} (tol {dwh_tol:.3e})",
            flush=True,
        )
    return rows


# ---------------------------------------------------------------- training
def train_phase(card: str) -> dict:
    """The main training path: ColocatedLoop.program at the default config,
    TRAIN_WARMUP untimed then TRAIN_UPDATES timed updates. The launch
    counters are zeroed just before the timed updates and read just after."""
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import fused_act as FA
    from tpu_rl_torch.ops import lstm as L
    from tpu_rl_torch.runtime.colocated import ColocatedLoop, act_params

    cfg = Config(**TRAIN_CFG)
    loop = ColocatedLoop(cfg, seed=0, device="cuda")
    n, s = loop.cfg.batch_size, loop.cfg.seq_len
    state, carry, stats = loop.state, loop.init_carry(), loop.init_stats()
    for _ in range(TRAIN_WARMUP):
        state, carry, stats, metrics = loop.program(state, carry, stats)
    torch.cuda.synchronize()
    fa0 = FA.LAUNCHES
    L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_UPDATES):
        state, carry, stats, metrics = loop.program(state, carry, stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fwd, bwd = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
    want = TRAIN_UPDATES * cfg.K_epoch
    if fwd != want or bwd != want:
        fail(f"training launched lstm_fwd {fwd} and lstm_bwd {bwd} times, want {want} each")
    if FA.LAUNCHES != fa0:
        fail("the colocated loop launched the fused act kernel")
    host = {k: float(v) for k, v in metrics.items() if k != "diag"}
    if not all(np.isfinite(v) for v in host.values()) or host["nonfinite-updates"] != 0.0:
        fail(f"training metrics not finite: {host}")
    if not all(bool(torch.isfinite(p).all()) for p in state.params["actor"].values()):
        fail("training params not finite")

    # Where one update's time goes: the rollout and the train step apart,
    # each closed by a synchronize, on the host clock.
    roll, train = [], []
    for _ in range(20):
        t1 = time.perf_counter()
        carry, batch, _done, _ret = loop.rollout(act_params(state), carry)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state, _m = loop.train_step(state, batch)
        torch.cuda.synchronize()
        roll.append(t2 - t1)
        train.append(time.perf_counter() - t2)

    # Device busy share and kernels per update over a few updates, from the
    # profiler's device events.
    busy = kernels_per_update = None
    n_prof = 10
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t3 = time.perf_counter()
            for _ in range(n_prof):
                state, carry, stats, _m = loop.program(state, carry, stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t3
        device = [
            e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
        ]
        device_us = sum(e.self_device_time_total for e in device)
        if device_us > 0:
            busy = device_us / 1e6 / wall
            kernels_per_update = sum(e.count for e in device) / n_prof
    except (RuntimeError, AttributeError) as e:
        print(f"training profile: not measured ({e!r})", flush=True)

    out = dict(
        updates=TRAIN_UPDATES, batch=n, seq=s, hidden=cfg.hidden_size,
        ms_per_update=dt / TRAIN_UPDATES * 1e3, transitions_per_s=TRAIN_UPDATES * n * s / dt,
        rollout_ms=statistics.median(roll) * 1e3, train_step_ms=statistics.median(train) * 1e3,
        lstm_fwd_launches=fwd, lstm_bwd_launches=bwd, device_busy=busy,
        device_events_per_update=kernels_per_update,
        episodes=int(stats["episodes"]), loss=host["loss"],
    )
    print(
        f"training PPO CartPole B={n} S={s} H={cfg.hidden_size}: {TRAIN_UPDATES} updates, "
        f"ms/update={out['ms_per_update']:.4f} transitions/s={out['transitions_per_s']:.1f} "
        f"rollout_ms={out['rollout_ms']:.4f} train_step_ms={out['train_step_ms']:.4f} "
        f"device_busy={'not measured' if busy is None else f'{busy:.4f}'} "
        f"device_events/update={kernels_per_update} "
        f"lstm_fwd launches={fwd} lstm_bwd launches={bwd} (= updates x K_epoch {cfg.K_epoch}) "
        f"fused_act launches +0 [{card}]",
        flush=True,
    )
    return out


def learn_phase(card: str) -> dict:
    """tpu_rl's colocated learning check: ``ColocatedLoop.program`` at
    LEARN_CFG, the windows ``ColocatedLoop.run`` logs (the same draws, so
    the same run), stopped at the first window that meets the bar (best
    window mean return >= LEARN_BAR over >= LEARN_EPISODES episodes)
    within LEARN_UPDATES updates."""
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import lstm as L
    from tpu_rl_torch.runtime.colocated import ColocatedLoop

    L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
    loop = ColocatedLoop(Config(**LEARN_CFG), seed=0, max_updates=LEARN_UPDATES, device="cuda")
    window = loop.cfg.loss_log_interval
    state, carry, stats = loop.state, loop.init_carry(), loop.init_stats()
    it, last_ep, last_ret, best = 0, 0, 0.0, float("-inf")
    t0 = time.perf_counter()
    while it < LEARN_UPDATES:
        for _ in range(window):
            state, carry, stats, metrics = loop.program(state, carry, stats)
        it += window
        episodes, ret_sum = int(stats["episodes"]), float(stats["ret_sum"])
        if episodes > last_ep:
            best = max(best, (ret_sum - last_ret) / (episodes - last_ep))
        print(f"[colocated] update {it}  episodes {episodes}  window mean_return "
              f"{(ret_sum - last_ret) / max(1, episodes - last_ep):.1f}  loss "
              f"{float(metrics['loss']):.4f}", flush=True)
        last_ep, last_ret = episodes, ret_sum
        if best >= LEARN_BAR and episodes >= LEARN_EPISODES:
            break
    elapsed = time.perf_counter() - t0
    out = dict(updates=it, episodes=last_ep, mean_return_best_window=best, elapsed_s=elapsed,
               transitions_per_s=it * loop.cfg.batch_size * loop.cfg.seq_len / elapsed)
    fwd, bwd = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
    print(
        f"learning: {out['updates']} updates (stopped at the bar), {out['episodes']} episodes, "
        f"best-window mean return "
        f"{out['mean_return_best_window']:.1f} (bar {LEARN_BAR}), {out['elapsed_s']:.1f} s, "
        f"{out['transitions_per_s']:.1f} transitions/s, lstm launches {fwd}/{bwd} [{card}]",
        flush=True,
    )
    if out["mean_return_best_window"] < LEARN_BAR or out["episodes"] < LEARN_EPISODES:
        fail(f"no learning: {out}")
    if fwd != out["updates"] or bwd != out["updates"]:
        fail(f"learning run launched lstm_fwd {fwd} / lstm_bwd {bwd} for {out['updates']} updates")
    return dict(out, lstm_launches={"lstm_fwd": fwd, "lstm_bwd": bwd})


def lstm_batch(cfg, seed: int, device: str = "cuda", continuous: bool = False):
    """A seeded LSTM batch at ``cfg``'s shape, as tests/test_torch_ppo.py
    builds one: behaviour logits and log-probs (for a Gaussian policy:
    actions in (-1, 1), per-dimension log-probs, zero logits), episode
    firsts on ~20% of steps (every row of the first few at step 0), carries
    at 0.5 scale."""
    from tpu_rl_torch.types import Batch

    rng = np.random.default_rng(seed)
    B, S, H, A = cfg.batch_size, cfg.seq_len, cfg.hidden_size, cfg.action_space
    D = int(cfg.obs_shape[0])
    if continuous:
        act = np.tanh(rng.normal(size=(B, S, A))).astype(np.float32)
        logits = np.zeros((B, S, A), np.float32)
        log_prob = (-1.0 + 0.3 * rng.normal(size=(B, S, A))).astype(np.float32)
    else:
        logits = rng.normal(size=(B, S, A)).astype(np.float32)
        logits = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        act = rng.integers(0, A, size=(B, S, 1)).astype(np.float32)
        log_prob = np.take_along_axis(logits, act.astype(np.int64), -1)
    is_fir = (rng.random((B, S, 1)) < 0.2).astype(np.float32)
    is_fir[: B // 8, 0] = 1.0
    return Batch.from_mapping(dict(
        obs=rng.normal(size=(B, S, D)).astype(np.float32), act=act,
        rew=(0.1 * rng.normal(size=(B, S, 1))).astype(np.float32), logits=logits,
        log_prob=log_prob if continuous else
        (log_prob + 0.1 * rng.normal(size=log_prob.shape)).astype(np.float32),
        is_fir=is_fir, hx=(0.5 * rng.normal(size=(B, S, H))).astype(np.float32),
        cx=(0.5 * rng.normal(size=(B, S, H))).astype(np.float32),
    ), device=device)


def vtrace_device_ms(family, state, batch, cfg) -> dict:
    """V-trace alone on the wide step's own inputs (the learner's log-probs
    and values of ``batch``): its device time per call (CUDA events, calls
    queued back to back) and its device kernels per call (profiler)."""
    from tpu_rl_torch.algos.ppo import policy_outputs
    from tpu_rl_torch.ops.returns import vtrace

    with torch.no_grad():
        log_probs, _ent, value, _logits = policy_outputs(family, state.params, batch)

    def call():
        return vtrace(batch.log_prob, log_probs, batch.is_fir, batch.rew, value, cfg.gamma,
                      cfg.rho_bar, cfg.rho_min, cfg.c_bar)

    ms = device_ms(call, iters=20)
    kernels = None
    try:
        from torch.profiler import ProfilerActivity, profile

        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = sum(e.count for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
    except (RuntimeError, AttributeError) as e:
        print(f"vtrace profile: not measured ({e!r})", flush=True)
    return dict(ms=ms, kernels_per_call=kernels)


def wide_lstm_train_phase(card: str, algo: str = "PPO", compute_dtype: str = "float32") -> dict:
    """The LSTM learner at bench.py's IMPALA@wide-lstm shape (bench.py:241-
    246: batch 1024, seq 16, H 1024, obs 64, 8 actions, f32), with the row's
    own algorithm (IMPALA) or with PPO (the phase of earlier slices, kept
    for comparison): get_algo(algo).build and its train_step on one seeded
    batch with resets, WIDE_WARMUP untimed then WIDE_UPDATES timed updates;
    then B1 + B2's and cuBLAS's products' shares of device time over a
    profiler window, and for IMPALA V-trace's device time beside it. With
    compute_dtype="bfloat16" it is the IMPALA@wide-lstm-bf16 row
    (bench.py:248-260): the recurrence is the bf16 scan, so B1/B2 launch 0
    times, and the scan's elementwise kernels' share is measured on the
    scan alone. The launch counters are zeroed just before the timed
    updates and read just after."""
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import lstm as L

    cfg = Config.from_dict(dict(WIDE_LSTM_CFG, algo=algo, compute_dtype=compute_dtype))
    bf16 = compute_dtype == "bfloat16"
    family, state, train_step = get_algo(algo).build(
        cfg, torch.Generator().manual_seed(0), device="cuda"
    )
    batch = lstm_batch(cfg, 0)
    for _ in range(WIDE_WARMUP):
        state, metrics = train_step(state, batch)
    torch.cuda.synchronize()
    L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
    enqueue = []
    t0 = time.perf_counter()
    for _ in range(WIDE_UPDATES):
        t1 = time.perf_counter()
        state, metrics = train_step(state, batch)
        enqueue.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fwd, bwd = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
    want = 0 if bf16 else cfg.K_epoch * WIDE_UPDATES
    if fwd != want or bwd != want:
        fail(f"wide LSTM training ({compute_dtype}) launched lstm_fwd {fwd} and lstm_bwd {bwd} "
             f"times, want {want} each")
    host = {k: float(v) for k, v in metrics.items() if k != "diag"}
    if not all(np.isfinite(v) for v in host.values()) or host["nonfinite-updates"] != 0.0:
        fail(f"wide LSTM training metrics not finite: {host}")
    if not all(bool(torch.isfinite(p).all()) for p in state.params["actor"].values()):
        fail("wide LSTM training params not finite")

    share = gemm_share = busy = device_ms_per_update = None
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(WIDE_PROFILE):
                state, _m = train_step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in events)
        if device_us > 0:
            busy = device_us / 1e6 / wall
            # B1/B2's kernels: lstm_{fwd,bwd}_{resident,streamed} (PR 2-5's
            # lstm_{fwd,bwd}_kernel, when lab/b12_lab.py runs another tree)
            share = sum(e.self_device_time_total for e in events
                        if "lstm_fwd_" in e.key or "lstm_bwd_" in e.key) / device_us
            # cuBLAS's products (the input projection, its two backward
            # products, dwh, the heads): kernels named *gemm* / *xmma*
            gemm_share = sum(e.self_device_time_total for e in events
                             if is_product(e.key)) / device_us
            device_ms_per_update = device_us / 1e3 / WIDE_PROFILE
    except (RuntimeError, AttributeError) as e:
        print(f"wide LSTM profile: not measured ({e!r})", flush=True)
    scan = scan_share = None
    if bf16:
        try:
            scan = scan_device_ms(cfg, batch)
            if device_ms_per_update is not None:
                scan_share = cfg.K_epoch * scan["elementwise_ms"] / device_ms_per_update
        except (RuntimeError, AttributeError) as e:
            print(f"bf16 scan profile: not measured ({e!r})", flush=True)
    vt = vtrace_share = None
    if algo == "IMPALA":
        vt = vtrace_device_ms(family, state, batch, cfg)
        if device_ms_per_update is not None:
            vtrace_share = cfg.K_epoch * vt["ms"] / device_ms_per_update
    out = dict(
        algo=algo, compute_dtype=compute_dtype, scan=scan, scan_elementwise_share=scan_share,
        vtrace_ms=None if vt is None else vt["ms"], vtrace_device_share=vtrace_share,
        vtrace_kernels_per_call=None if vt is None else vt["kernels_per_call"],
        updates=WIDE_UPDATES, batch=cfg.batch_size, seq=cfg.seq_len, hidden=cfg.hidden_size,
        ms_per_update=dt / WIDE_UPDATES * 1e3,
        transitions_per_s=WIDE_UPDATES * cfg.batch_size * cfg.seq_len / dt,
        enqueue_ms=statistics.median(enqueue) * 1e3, device_ms_per_update=device_ms_per_update,
        b1_b2_device_share=share, gemm_device_share=gemm_share, device_busy=busy,
        lstm_fwd_launches=fwd,
        lstm_bwd_launches=bwd, loss=host["loss"],
    )
    if vt is not None:
        print(
            f"wide LSTM training {algo}: V-trace {vt['ms']:.6f} ms of device time a call "
            f"({vt['kernels_per_call']} device kernels), "
            f"{'not measured' if vtrace_share is None else f'{vtrace_share:.4f}'} of the "
            f"update's device time [{card}]",
            flush=True,
        )
    if scan is not None:
        print(
            f"wide LSTM training {algo} bf16: the scan alone (forward + backward) "
            f"{scan['ms']:.6f} ms of device time a call in {scan['kernels']} device kernels, "
            f"bf16 products {scan['product_ms']:.6f} ms, elementwise {scan['elementwise_ms']:.6f} "
            f"ms, {'not measured' if scan_share is None else f'{scan_share:.4f}'} of the update's "
            f"device time [{card}]",
            flush=True,
        )
    print(
        f"wide LSTM training {algo} B={cfg.batch_size} S={cfg.seq_len} H={cfg.hidden_size} obs "
        f"{cfg.obs_shape} A={cfg.action_space} {'bf16' if bf16 else 'f32'}: {WIDE_UPDATES} "
        f"updates, ms/update="
        f"{out['ms_per_update']:.4f} transitions/s={out['transitions_per_s']:.1f} host enqueue "
        f"ms/update={out['enqueue_ms']:.4f} device ms/update="
        f"{'not measured' if device_ms_per_update is None else f'{device_ms_per_update:.4f}'} "
        f"B1+B2 share of device time={'not measured' if share is None else f'{share:.4f}'} "
        f"cuBLAS products' share={'not measured' if gemm_share is None else f'{gemm_share:.4f}'} "
        f"device_busy={'not measured' if busy is None else f'{busy:.4f}'} loss={host['loss']:.6f} "
        f"lstm_fwd launches={fwd} lstm_bwd launches={bwd} (want {want}) [{card}]",
        flush=True,
    )
    return out


# ------------------------------------------------- the other algorithms
def state_to(state, device):
    """A TrainState or SACState with every tensor on ``device``."""
    import dataclasses

    return type(state)(**{f.name: on_device(getattr(state, f.name), device)
                          for f in dataclasses.fields(state)})


def state_leaves(state) -> dict[str, list]:
    """A train state's tensors by kind: ``params`` (the trained parameters,
    the SAC target and ``log_alpha`` included), ``moments`` (RMSprop nu,
    Adam mu and nu), ``counts`` (the step and Adam counts)."""
    def flat(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in flat(v)]
        return [tree]

    if hasattr(state, "params"):
        return dict(params=flat(state.params), moments=flat(state.opt_state), counts=[state.step])
    opts = (state.actor_opt, state.critic_opt, state.alpha_opt)
    return dict(
        params=flat(state.actor_params) + flat(state.critic_params)
        + flat(state.target_critic_params) + [state.log_alpha],
        moments=[x for o in opts for x in flat({"mu": o["mu"], "nu": o["nu"]})],
        counts=[state.step] + [o["count"] for o in opts],
    )


def metric_leaves(metrics: dict) -> dict[str, torch.Tensor]:
    out = {k: v for k, v in metrics.items() if k != "diag"}
    for part in ("rows", "scalars"):
        out.update({f"diag {part} {k}": v for k, v in metrics.get("diag", {}).get(part, {}).items()})
    return out


def step_noise(name: str, cfg, batch, g: torch.Generator) -> dict:
    """The shared noise of one train step, drawn on the CPU: V-MPO's unit
    uniform per epoch, SAC-Continuous's pair of unit normals per epoch."""
    if name == "V-MPO":
        return dict(coef_alpha_u=torch.rand((cfg.K_epoch,), generator=g))
    if name == "SAC-Continuous":
        shape = tuple(batch.act.shape)
        return dict(noise=[tuple(torch.randn(shape, generator=g) for _ in range(2))
                           for _ in range(cfg.K_epoch)])
    return {}


def card_vs_cpu(tag: str, got, want, got_state, want_state) -> tuple[dict, dict]:
    """One train step on the card against the same step on the CPU: the
    metrics and the new state's params and moments, at REF_TOL; fails
    otherwise. Returns the errors by kind and where each was largest."""
    errs = {"loss": 0.0, "metrics": 0.0, "grad-norms": 0.0, "params": 0.0, "moments": 0.0}
    worst = {}
    gm, wm = metric_leaves(got), metric_leaves(want)
    if set(gm) != set(wm):
        fail(f"{tag}: the card's metrics {sorted(gm)} are not the CPU's {sorted(wm)}")
    finite = True
    for k, w in wm.items():
        g = gm[k].cpu()
        finite &= bool(torch.isfinite(g).all())
        kind = "loss" if k == "loss" else "grad-norms" if "grad-norm" in k else "metrics"
        # loss: relative; the rest absolute up to magnitude 1 and relative
        # above it (an f32 ulp is 1.2e-4 at 1024: the diag w2 rows reach
        # ~10^3 where the batch's behaviour log-probs lie far below the
        # learner's)
        scale = w.abs() if kind == "loss" else w.abs().clamp(min=1.0)
        err = float(((g - w).abs() / scale).max())
        if err >= errs[kind]:
            errs[kind], worst[kind] = err, k
    gs, ws = state_leaves(got_state), state_leaves(want_state)
    for kind in ("params", "moments"):
        for g, w in zip(gs[kind], ws[kind], strict=True):
            finite &= bool(torch.isfinite(g).all())
            errs[kind] = max(errs[kind], max_err(g.cpu(), w))
    counts_equal = [int(g) for g in gs["counts"]] == [int(w) for w in ws["counts"]]
    if not (finite and counts_equal and all(errs[k] <= REF_TOL[k] for k in errs)):
        fail(f"{tag} train step on the card vs the CPU: {errs} (bars {REF_TOL}; largest at "
             f"{worst}), finite {finite}, counts equal {counts_equal}")
    return errs, worst


def ref_row_phase(name: str, card: str) -> dict:
    """One bench.py @ref row (bench.py:234-239: 128 x 5, H 64; CartPole's
    (4,)/2 for the discrete algorithms, (2,)/1 for the continuous): one
    train step on the card, through B1/B2, against the same step on the CPU
    through their plain versions, from the same seeded state, batch and
    shared noise; then REF_UPDATES timed updates on the card with the
    launch counters zeroed just before and read just after, which must be
    updates x K_epoch x the path's launches per epoch."""
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import lstm as L

    cfg = Config.from_dict(REF_ROWS[name])
    _f, state_cpu, step_cpu = get_algo(name).build(cfg, torch.Generator().manual_seed(0), device="cpu")
    family, _s, step_dev = get_algo(name).build(cfg, torch.Generator().manual_seed(0), device="cuda")
    batch_cpu = lstm_batch(cfg, 1, "cpu", family.continuous)
    batch = lstm_batch(cfg, 1, "cuda", family.continuous)
    noise = step_noise(name, cfg, batch_cpu, torch.Generator().manual_seed(2))
    want_state, want = step_cpu(state_cpu, batch_cpu, **noise)
    got_state, got = step_dev(state_to(state_cpu, "cuda"), batch, **on_device(noise, "cuda"))
    torch.cuda.synchronize()
    errs, worst = card_vs_cpu(f"{name}@ref", got, want, got_state, want_state)

    gen = torch.Generator(device="cuda").manual_seed(3)
    state = got_state
    for _ in range(2):
        state, metrics = step_dev(state, batch, gen)
    torch.cuda.synchronize()
    L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(REF_UPDATES):
        state, metrics = step_dev(state, batch, gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fwd, bwd = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
    per_fwd, per_bwd = LAUNCHES_PER_EPOCH[name]
    want_fwd, want_bwd = (REF_UPDATES * cfg.K_epoch * x for x in (per_fwd, per_bwd))
    if (fwd, bwd) != (want_fwd, want_bwd):
        fail(f"{name}@ref launched lstm_fwd {fwd} / lstm_bwd {bwd} times in {REF_UPDATES} "
             f"updates, want {want_fwd} / {want_bwd}")
    host = {k: float(v) for k, v in metrics.items() if k != "diag"}
    if not all(np.isfinite(v) for v in host.values()) or host.get("nonfinite-updates", 0.0) != 0.0:
        fail(f"{name}@ref metrics not finite: {host}")
    out = dict(errs=errs, worst=worst, tol=REF_TOL, ms_per_update=dt / REF_UPDATES * 1e3,
               transitions_per_s=REF_UPDATES * cfg.batch_size * cfg.seq_len / dt,
               lstm_fwd_launches=fwd, lstm_bwd_launches=bwd, loss=host["loss"])
    print(
        f"{name}@ref B={cfg.batch_size} S={cfg.seq_len} H={cfg.hidden_size} obs {cfg.obs_shape} "
        f"A={cfg.action_space}: the card's step vs the CPU's: "
        + " ".join(f"{k} {v:.3e} (bar {REF_TOL[k]:g}{', ' + worst[k] if k in worst else ''})"
                   for k, v in errs.items())
        + f"; {REF_UPDATES} updates, ms/update={out['ms_per_update']:.4f} transitions/s="
        f"{out['transitions_per_s']:.1f} lstm_fwd launches={fwd} lstm_bwd launches={bwd} "
        f"(= updates x K_epoch x {per_fwd}/{per_bwd}) [{card}]",
        flush=True,
    )
    return out


def colocated_algos_phase(card: str) -> dict:
    """IMPALA and V-MPO on CartPole and PPO-Continuous on Pendulum through
    ColocatedLoop.program at 128 envs: one warm-up update, then
    COLOCATED_UPDATES timed updates with the launch counters zeroed just
    before and read just after (updates x K_epoch each); finite metrics
    and params."""
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import lstm as L
    from tpu_rl_torch.runtime.colocated import ColocatedLoop, act_params

    out = {}
    for env, algo, extra in COLOCATED_ALGOS:
        cfg = Config(env=env, env_mode="colocated", algo=algo, colocated_envs=128, **extra)
        loop = ColocatedLoop(cfg, seed=0, device="cuda")
        state, carry, stats = loop.state, loop.init_carry(), loop.init_stats()
        state, carry, stats, metrics = loop.program(state, carry, stats)
        torch.cuda.synchronize()
        L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        for _ in range(COLOCATED_UPDATES):
            state, carry, stats, metrics = loop.program(state, carry, stats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fwd, bwd = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
        want = COLOCATED_UPDATES * loop.cfg.K_epoch
        if fwd != want or bwd != want:
            fail(f"colocated {algo} on {env} launched lstm_fwd {fwd} / lstm_bwd {bwd} times, "
                 f"want {want} each")
        host = {k: float(v) for k, v in metrics.items() if k != "diag"}
        if not all(np.isfinite(v) for v in host.values()) or host["nonfinite-updates"] != 0.0:
            fail(f"colocated {algo} on {env}: metrics not finite: {host}")
        if not all(bool(torch.isfinite(p).all()) for p in act_params(state)["actor"].values()):
            fail(f"colocated {algo} on {env}: params not finite")
        n, s = loop.cfg.batch_size, loop.cfg.seq_len
        out[algo] = dict(env=env, ms_per_update=dt / COLOCATED_UPDATES * 1e3,
                         transitions_per_s=COLOCATED_UPDATES * n * s / dt,
                         lstm_fwd_launches=fwd, lstm_bwd_launches=bwd, loss=host["loss"])
        print(
            f"colocated {algo} {env} B={n} S={s} H={loop.cfg.hidden_size}: {COLOCATED_UPDATES} "
            f"updates, ms/update={out[algo]['ms_per_update']:.4f} transitions/s="
            f"{out[algo]['transitions_per_s']:.1f} loss={host['loss']:.6f} lstm_fwd launches="
            f"{fwd} lstm_bwd launches={bwd} (= updates x K_epoch {want}) [{card}]",
            flush=True,
        )
    return out


def impala_learn_phase(card: str) -> dict:
    """IMPALA through ColocatedLoop.run on learn_phase's recipe (seed 0,
    IMPALA_LEARN_UPDATES updates): its best window and episodes are printed
    with no bar (tpu_rl has none for IMPALA); the launches must equal the
    updates."""
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import lstm as L
    from tpu_rl_torch.runtime.colocated import ColocatedLoop

    L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
    loop = ColocatedLoop(Config(**dict(LEARN_CFG, algo="IMPALA")), seed=0,
                         max_updates=IMPALA_LEARN_UPDATES, device="cuda")
    out = loop.run(log=True)
    fwd, bwd = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
    print(
        f"learning IMPALA: {out['updates']} updates, {out['episodes']} episodes, best-window mean "
        f"return {out['mean_return_best_window']:.1f} (no bar), {out['elapsed_s']:.1f} s, "
        f"{out['transitions_per_s']:.1f} transitions/s, lstm launches {fwd}/{bwd} [{card}]",
        flush=True,
    )
    if fwd != out["updates"] or bwd != out["updates"]:
        fail(f"IMPALA learning run launched lstm_fwd {fwd} / lstm_bwd {bwd} for "
             f"{out['updates']} updates")
    return dict({k: v for k, v in out.items() if k != "scalars"},
                lstm_launches={"lstm_fwd": fwd, "lstm_bwd": bwd})


# ------------------------------------------------- bf16 compute and serving
def quant_policy_check(card: str) -> dict:
    """tests/test_quant.py:140-157 on the card: the serving model with its
    logits head scaled x 4 (_margin_params), 512 seeded rows from a zero
    carry, acted through B3 on the f32 tree and on the bf16 and int8 trees
    widened, under shared Gumbel noise: argmax agreement with f32 >=
    QUANT_AGREE and mean |log-prob drift| <= QUANT_DRIFT[mode]. Also each
    mode's tree_bytes. Run before the serving runs: these launches are not
    the main path's."""
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.models.families import build_family
    from tpu_rl_torch.models.quant import dequantize_tree, make_act_fn, quantize_tree, tree_bytes

    cfg = Config.from_dict(SERVE_CFG)
    family = build_family(cfg, device="cuda")
    params = family.init_params(torch.Generator().manual_seed(0))
    params["actor"]["logits.weight"] *= 4.0
    act = make_act_fn(cfg, family)
    g = torch.Generator().manual_seed(7)
    obs = torch.randn((512, 4), generator=g).cuda()
    gumbel = -torch.log(-torch.log(torch.rand((512, 2), generator=g))).cuda()
    zeros = torch.zeros((512, cfg.hidden_size), device="cuda")
    out = {}
    _a, lg32, lp32, _h, _c = act(params, obs, zeros, zeros, gumbel=gumbel)
    for mode in ("f32", *SERVE_DTYPES):
        q = quantize_tree(params, mode)
        _a, lg, lp, _h, _c = act(dequantize_tree(q), obs, zeros, zeros, gumbel=gumbel)
        agree = float((lg.argmax(-1) == lg32.argmax(-1)).float().mean())
        drift = float((lp - lp32).abs().mean())
        out[mode] = dict(tree_bytes=tree_bytes(q), agree=agree, drift=drift)
        print(f"serving precision {mode}: tree_bytes={tree_bytes(q)} argmax agreement with f32 "
              f"{agree:.4f} (bar >= {QUANT_AGREE}) mean log-prob drift {drift:.6f} (bar "
              f"{QUANT_DRIFT.get(mode, 0.0)}) [{card}]", flush=True)
        if mode != "f32" and (agree < QUANT_AGREE or drift > QUANT_DRIFT[mode]):
            fail(f"{mode} serving drifts from f32: agreement {agree}, log-prob drift {drift}")
    return out


def mixed_dot_check(card: str) -> dict:
    """mixed_dot on the card (cuBLAS's bf16 product with an f32 output,
    ``torch.mm(..., out_dtype=torch.float32)``): at the @ref recurrence
    (128 x 64 @ 64 x 256) against the CPU's plain version (the same bf16
    operands widened, summed in f32) at 1e-5, forward and both gradients;
    at the wide recurrence (1024 x 1024 @ 1024 x 4096) against the float64
    product of the same bf16 operands, within 1e-5 x max|exact|: f32 sums
    (a bf16 reduction would miss by ~1e-3 of it). Times the product beside
    the f32 product (TF32 off) and the bf16 product rounded to bf16."""
    from tpu_rl_torch.ops import lstm as L

    out = {}
    for M, K, N in ((128, 64, 256), (1024, 1024, 4096)):
        g = torch.Generator().manual_seed(M + K)
        a, b, w = (torch.randn(s, generator=g) * 0.5 for s in ((M, K), (K, N), (M, N)))
        ac, bc = a.cuda().requires_grad_(), b.cuda().requires_grad_()
        got = L.mixed_dot(ac, bc)
        (got * w.cuda()).sum().backward()
        torch.cuda.synchronize()
        if M == 128:
            ap, bp = a.clone().requires_grad_(), b.clone().requires_grad_()
            want = L.mixed_dot(ap, bp)
            (want * w).sum().backward()
            err = max(max_err(got.cpu(), want), max_err(ac.grad.cpu(), ap.grad),
                      max_err(bc.grad.cpu(), bp.grad))
            bar = 1e-5
        else:
            exact = a.bfloat16().double() @ b.bfloat16().double()
            err = max_err(got.double().cpu(), exact)
            bar = 1e-5 * float(exact.abs().max())
        if got.dtype != torch.float32 or not err <= bar:
            fail(f"mixed_dot at {(M, K, N)} on the card: err {err} > {bar} ({got.dtype})")
        ab, bb = a.cuda().bfloat16(), b.cuda().bfloat16()
        af, bf = a.cuda(), b.cuda()
        ms = device_ms(lambda: torch.mm(ab, bb, out_dtype=torch.float32), iters=20)
        f32_ms = device_ms(lambda: af @ bf, iters=20)
        bf16_ms = device_ms(lambda: ab @ bb, iters=20)
        out[f"{M}x{K}x{N}"] = dict(err=err, bar=bar, ms=ms, f32_ms=f32_ms, bf16_out_ms=bf16_ms)
        print(f"mixed_dot {M}x{K} @ {K}x{N}: err {err:.3e} (bar {bar:.3e}); the product "
              f"{ms:.6f} ms (f32 product, TF32 off: {f32_ms:.6f}; bf16 rounded to bf16: "
              f"{bf16_ms:.6f}) [{card}]", flush=True)
    return out


def bf16_ref_phase(card: str) -> dict:
    """IMPALA with compute_dtype="bfloat16" at bench.py's @ref shape (128 x 5,
    H 64): one train step on the card against the same step on the CPU from
    one seeded state and batch. Both sides take the same bf16 operands, so
    what differs is the order of f32 sums and, through it, rare one-ulp
    flips of bf16-rounded values (x_proj's output, the bf16 Denses'
    gradients). So the loss and each metric are held to the bf16 element
    bar of PERF.md §2 (one bf16 ulp of the element, 2**-7·|ref| +
    2**-16·max|ref|); each param's update (new - old) to one bf16 ulp of
    the largest update of its tensor, 2**-7·max|update| (a flipped bf16
    gradient moves one element's update by about one ulp of the gradient,
    and a near-zero one is flipped against its tensor's scale, not its
    own); each RMSprop moment (nu, the square of a gradient: two ulps) to
    2**-6·max|nu| of its tensor. Then REF_UPDATES timed updates with
    B1/B2's counters zeroed just before: 0 launches (bf16 compute runs
    the scan)."""
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import lstm as L

    cfg = Config.from_dict(dict(REF_ROWS["IMPALA"], compute_dtype="bfloat16"))
    _f, state_cpu, step_cpu = get_algo("IMPALA").build(cfg, torch.Generator().manual_seed(0),
                                                       device="cpu")
    _f, _s, step_dev = get_algo("IMPALA").build(cfg, torch.Generator().manual_seed(0), device="cuda")
    old = state_leaves(state_cpu)["params"]
    want_state, want = step_cpu(state_cpu, lstm_batch(cfg, 1, "cpu"))
    got_state, got = step_dev(state_to(state_cpu, "cuda"), lstm_batch(cfg, 1, "cuda"))
    torch.cuda.synchronize()

    def ulps(g, w) -> float:
        g, w = g.detach().double().cpu(), w.detach().double()
        bar = 2.0**-7 * w.abs() + 2.0**-16 * float(w.abs().max())
        return float(((g - w).abs() / bar.clamp(min=1e-30)).max())

    share = {"loss": 0.0, "metrics": 0.0, "updates": 0.0, "moments": 0.0}
    gm, wm = metric_leaves(got), metric_leaves(want)
    if set(gm) != set(wm):
        fail(f"IMPALA@ref bf16: the card's metrics {sorted(gm)} are not the CPU's {sorted(wm)}")
    finite = True
    for k, w in wm.items():
        finite &= bool(torch.isfinite(gm[k]).all())
        kind = "loss" if k == "loss" else "metrics"
        share[kind] = max(share[kind], ulps(gm[k], w))
    def tensor_ulps(g, w, ulp: float) -> float:
        err = float((g.detach().double().cpu() - w.detach().double()).abs().max())
        scale = ulp * float(w.detach().double().abs().max())
        return err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))

    gs, ws = state_leaves(got_state), state_leaves(want_state)
    for g, w, o in zip(gs["params"], ws["params"], old, strict=True):
        finite &= bool(torch.isfinite(g).all())
        share["updates"] = max(share["updates"], tensor_ulps(g.cpu() - o, w - o, 2.0**-7))
    for g, w in zip(gs["moments"], ws["moments"], strict=True):
        share["moments"] = max(share["moments"], tensor_ulps(g, w, 2.0**-6))
    if not finite or any(v > 1.0 for v in share.values()):
        fail(f"IMPALA@ref bf16 train step on the card vs the CPU: shares of the bf16 bars "
             f"{share}, finite {finite}")

    state, batch = got_state, lstm_batch(cfg, 1, "cuda")
    for _ in range(2):
        state, metrics = step_dev(state, batch)
    torch.cuda.synchronize()
    L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(REF_UPDATES):
        state, metrics = step_dev(state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fwd, bwd = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
    if fwd or bwd:
        fail(f"IMPALA@ref bf16 launched lstm_fwd {fwd} / lstm_bwd {bwd} times, want 0")
    host = {k: float(v) for k, v in metrics.items() if k != "diag"}
    if not all(np.isfinite(v) for v in host.values()) or host["nonfinite-updates"] != 0.0:
        fail(f"IMPALA@ref bf16 metrics not finite: {host}")
    out = dict(bar_share=share, ms_per_update=dt / REF_UPDATES * 1e3,
               transitions_per_s=REF_UPDATES * cfg.batch_size * cfg.seq_len / dt,
               lstm_fwd_launches=fwd, lstm_bwd_launches=bwd, loss=host["loss"])
    print(
        f"IMPALA@ref bf16 B={cfg.batch_size} S={cfg.seq_len} H={cfg.hidden_size}: the card's step "
        f"vs the CPU's, largest share of its bf16 bar: "
        + " ".join(f"{k} {v:.4f}" for k, v in share.items())
        + f"; {REF_UPDATES} updates, ms/update={out['ms_per_update']:.4f} transitions/s="
        f"{out['transitions_per_s']:.1f} lstm_fwd launches={fwd} lstm_bwd launches={bwd} "
        f"(want 0) [{card}]",
        flush=True,
    )
    return out


def scan_device_ms(cfg, batch) -> dict:
    """The bf16 recurrence alone (ops.lstm.lstm_scan, forward and backward)
    at the wide step's shape with its keep mask and carries, under the
    profiler: its device time per call, split into the bf16 products and
    the rest (the gate arithmetic's elementwise kernels)."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_rl_torch.ops.lstm import lstm_scan

    B, S, H = cfg.batch_size, cfg.seq_len, cfg.hidden_size
    g = torch.Generator().manual_seed(5)
    xp = torch.randn((B, S, 4 * H), generator=g).cuda().bfloat16()
    wh = (torch.randn((H, 4 * H), generator=g) / H**0.5).cuda().requires_grad_()
    h0 = batch.hx[:, 0].clone().requires_grad_()
    c0 = batch.cx[:, 0].clone()
    keep = 1.0 - batch.is_fir[..., 0]

    def call():
        hs, (_hN, cN) = lstm_scan(xp, wh, h0, c0, keep)
        (hs.sum() + cN.sum()).backward()

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    gemm = sum(e.self_device_time_total for e in events if is_product(e.key)) / 1e3
    return dict(ms=total, product_ms=gemm, elementwise_ms=total - gemm,
                kernels=sum(e.count for e in events))


def is_product(name: str) -> bool:
    """cuBLAS's (and CUTLASS's) product kernels, by name."""
    name = name.lower()
    return any(k in name for k in ("gemm", "xmma", "nvjet", "cutlass"))


def bf16_colocated_phase(card: str) -> dict:
    """PPO with compute_dtype="bfloat16" through ColocatedLoop.program at
    128 envs, 1 + COLOCATED_UPDATES updates: finite metrics and params, and
    no B1/B2 launch."""
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import lstm as L
    from tpu_rl_torch.runtime.colocated import ColocatedLoop

    loop = ColocatedLoop(Config(**TRAIN_CFG, compute_dtype="bfloat16"), seed=0, device="cuda")
    state, carry, stats = loop.state, loop.init_carry(), loop.init_stats()
    state, carry, stats, metrics = loop.program(state, carry, stats)
    torch.cuda.synchronize()
    L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(COLOCATED_UPDATES):
        state, carry, stats, metrics = loop.program(state, carry, stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fwd, bwd = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
    host = {k: float(v) for k, v in metrics.items() if k != "diag"}
    if not all(np.isfinite(v) for v in host.values()) or host["nonfinite-updates"] != 0.0:
        fail(f"colocated PPO bf16: metrics not finite: {host}")
    if not all(bool(torch.isfinite(p).all()) and p.dtype == torch.float32
               for p in state.params["actor"].values()):
        fail("colocated PPO bf16: params not finite f32")
    if fwd or bwd:
        fail(f"colocated PPO bf16 launched lstm_fwd {fwd} / lstm_bwd {bwd} times, want 0")
    n, s = loop.cfg.batch_size, loop.cfg.seq_len
    out = dict(ms_per_update=dt / COLOCATED_UPDATES * 1e3,
               transitions_per_s=COLOCATED_UPDATES * n * s / dt, lstm_fwd_launches=fwd,
               lstm_bwd_launches=bwd, loss=host["loss"])
    print(f"colocated PPO bf16 CartPole B={n} S={s} H={loop.cfg.hidden_size}: {COLOCATED_UPDATES} "
          f"updates, ms/update={out['ms_per_update']:.4f} transitions/s="
          f"{out['transitions_per_s']:.1f} loss={host['loss']:.6f} lstm launches {fwd}/{bwd} "
          f"(want 0) [{card}]", flush=True)
    return out


# -------------------------------------------------- checkpoint and resume
def checkpoint_phase(card: str) -> dict:
    """ColocatedLoop.run on the default config (128 envs) with model_dir in a
    temporary directory, model_save_interval CKPT_INTERVAL, ckpt_async on
    and ckpt_keep CKPT_KEEP, for CKPT_UPDATES updates: the newest committed
    index is CKPT_UPDATES and CKPT_KEEP directories are kept. A fresh loop
    resumes at that index with run epoch 1, its restored state and
    generator equal to the saved ones bit for bit, and runs on to
    CKPT_RESUMED_TO with finite params; a directory without a marker above
    is invisible; a bf16-compute config refuses to resume (RuntimeError)
    unless resume_force. B1/B2's launches over both runs equal their
    updates. Then the save's cost: sync (blocking) and async (the loop's
    snapshot, and the writer's wall time from drain_save_secs), and
    ms/update of a run with and without checkpoints."""
    import dataclasses
    import os
    import tempfile

    from tpu_rl_torch.checkpoint import Checkpointer, latest_committed, read_meta
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import lstm as L
    from tpu_rl_torch.runtime.colocated import ColocatedLoop

    def leaves(tree):
        if dataclasses.is_dataclass(tree):
            return [x for f in dataclasses.fields(tree) for x in leaves(getattr(tree, f.name))]
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        return [tree]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        cfg = Config(**TRAIN_CFG, model_dir=d, model_save_interval=CKPT_INTERVAL,
                     ckpt_keep=CKPT_KEEP, ckpt_async=True, loss_log_interval=CKPT_UPDATES)
        L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
        first = ColocatedLoop(cfg, seed=0, max_updates=CKPT_UPDATES, device="cuda")
        run1 = first.run(log=False)
        newest = latest_committed(d, "PPO")
        kept = sorted(n for n in os.listdir(d) if not n.startswith("."))
        if newest is None or newest[0] != CKPT_UPDATES or len(kept) != CKPT_KEEP:
            fail(f"checkpointed run: newest committed {newest}, kept {kept}")
        saved_gen = first.generator.get_state()

        second = ColocatedLoop(cfg, seed=0, max_updates=CKPT_RESUMED_TO, device="cuda")
        restored = second.restore(second.state)
        same = all(torch.equal(a, b) and a.dtype == b.dtype and a.device == b.device
                   for a, b in zip(leaves(restored), leaves(first.state), strict=True))
        if (second._start_it, second.run_epoch) != (CKPT_UPDATES, 1) or not same \
                or not torch.equal(second.generator.get_state(), saved_gen):
            fail(f"resume: idx {second._start_it}, epoch {second.run_epoch}, state equal {same}, "
                 f"generator equal {torch.equal(second.generator.get_state(), saved_gen)}")
        run2 = second.run(log=False)
        if run2["updates"] != CKPT_RESUMED_TO or not all(
                bool(torch.isfinite(p).all()) for p in second.state.params["actor"].values()):
            fail(f"resumed run: {run2['updates']} updates, params finite?")
        if read_meta(os.path.join(d, f"PPO_{CKPT_RESUMED_TO}")).get("epoch") != 1:
            fail("the resumed run's checkpoint does not carry run epoch 1")
        fwd, bwd = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
        if fwd != CKPT_RESUMED_TO or bwd != CKPT_RESUMED_TO:
            fail(f"checkpointed runs launched lstm_fwd {fwd} / lstm_bwd {bwd}, want "
                 f"{CKPT_RESUMED_TO} each")
        torn = os.path.join(d, "PPO_50")
        os.makedirs(torn)
        with open(os.path.join(torn, "state.pt"), "w") as f:
            f.write("torn")
        if latest_committed(d, "PPO")[0] != CKPT_RESUMED_TO:
            fail("a directory without a commit marker is visible")
        refused = False
        try:
            ColocatedLoop(cfg.replace(compute_dtype="bfloat16"), seed=0, device="cuda").restore(
                second.state)
        except RuntimeError:
            refused = True
        forced = ColocatedLoop(cfg.replace(compute_dtype="bfloat16", resume_force=True), seed=0,
                               device="cuda")
        forced.restore(forced.state)
        if not refused or forced._start_it != CKPT_RESUMED_TO:
            fail(f"fingerprint: refused {refused}, forced resume at {forced._start_it}")

        # a save's cost at this state (sync: the whole save; async: what the
        # loop pays, then the writer's wall time)
        state = second.state
        sync = Checkpointer(os.path.join(d, "sync"), "PPO", keep=2)
        async_ = Checkpointer(os.path.join(d, "async"), "PPO", keep=2, async_save=True)
        sync_s, snap_s = [], []
        for i in range(CKPT_SAVES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sync.save(state, i)
            sync_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            async_.save(state, i)
            snap_s.append(time.perf_counter() - t0)
            async_.flush(timeout=60.0)
        writer_s = async_.drain_save_secs()
        sync.close()
        async_.close()
        # ms/update of CKPT_UPDATES-update runs without and with checkpoints,
        # in turns (without, with, with, without)
        per_update = {"plain": [], "ckpt": []}
        for i, kind in enumerate(("plain", "ckpt", "ckpt", "plain")):
            kw = dict(model_dir=os.path.join(d, f"timed{i}"), model_save_interval=CKPT_INTERVAL,
                      ckpt_keep=CKPT_KEEP) if kind == "ckpt" else {}
            timed = ColocatedLoop(Config(**TRAIN_CFG, loss_log_interval=CKPT_UPDATES, **kw),
                                  seed=0, max_updates=CKPT_UPDATES, device="cuda").run(log=False)
            per_update[kind].append(timed["elapsed_s"] / CKPT_UPDATES * 1e3)
    out = dict(
        updates=run1["updates"], resumed_to=run2["updates"], kept=kept,
        ms_per_update_ckpt=statistics.mean(per_update["ckpt"]),
        ms_per_update_plain=statistics.mean(per_update["plain"]),
        ms_per_update_runs=per_update,
        save_s_sync=statistics.median(sync_s), save_s_async_loop=statistics.median(snap_s),
        save_s_async_writer=statistics.median(writer_s), lstm_fwd_launches=fwd,
        lstm_bwd_launches=bwd,
    )
    print(
        f"checkpoint PPO CartPole B={first.cfg.batch_size}: {CKPT_UPDATES} updates saving every "
        f"{CKPT_INTERVAL} (async), newest committed {newest[0]}, kept {kept}; resumed at "
        f"{CKPT_UPDATES} (run epoch 1, state and generator bit for bit) and ran to "
        f"{run2['updates']}; a torn PPO_50 invisible; bf16 config refused, forced resumes; "
        f"ms/update with checkpoints {out['ms_per_update_ckpt']:.4f} without "
        f"{out['ms_per_update_plain']:.4f} (runs {per_update}); save s: sync {out['save_s_sync']:.6f}, async "
        f"(loop) {out['save_s_async_loop']:.6f}, async (writer, drain_save_secs) "
        f"{out['save_s_async_writer']:.6f}; lstm launches {fwd}/{bwd} [{card}]",
        flush=True,
    )
    return out


# ---------------------------------------------------------- attention (B4)
def attn_inputs(B, T, H, D, dtype, seams, seed, shuffled=False, device="cuda"):
    """Seeded q, k, v as strided views of one (B,T,3,H,D) qkv tensor (as the
    model hands them to the kernel), int32 segment ids with ~``seams``
    seams per row, and an output cotangent. ``shuffled`` permutes each
    row's ids: segments then interleave and the ids are not monotone, which
    the tile-skip rule must also get right."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((B, T, 3, H, D), generator=g).to(dtype).to(device)
    firsts = (torch.rand((B, T), generator=g) < seams / T).to(torch.int32)
    firsts[:, 0] = 1
    seg = torch.cumsum(firsts, 1, dtype=torch.int32)
    if shuffled:
        seg = torch.stack([row[torch.randperm(T, generator=g)] for row in seg])
    do = torch.randn((B, T, H, D), generator=g).to(dtype).to(device)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], seg.contiguous().to(device), do


def visible_pairs(seg: torch.Tensor) -> int:
    """Query-key pairs B4's mask keeps in this run's data: a segment id that
    occurs c times in a row keeps c(c+1)/2 (query, key) pairs, wherever its
    rows lie."""
    counts = [torch.unique(row, return_counts=True)[1] for row in seg]
    return int(sum(int((c * (c + 1) // 2).sum()) for c in counts))


def tile_visits(seg: torch.Tensor) -> tuple[int, int]:
    """(tile pairs the kernels visit, causal tile pairs) per head, by the
    kernels' own skip rule (``ops.attention.visited_tiles``)."""
    from tpu_rl_torch.ops import attention as A

    r = A.tile_ranges(seg)
    n = r[0].shape[1]
    return int(A.visited_tiles(r, r).sum()), seg.shape[0] * n * (n + 1) // 2


def attn_bounds(B: int, T: int, H: int, D: int, elt: int, pairs: int) -> dict:
    """Least time (ms) of B4's forward and backward on an H100: the larger of
    the bytes each must move (q, k, v, seg and the forward's o and lse, and
    do, read once; o, lse, dq, dk, dv written once) over HBM's rate, and
    its operations over the dtype's peak. The operations count the pairs
    this run's mask keeps, per head 2*D for each of the products that
    touch a pair: 2 forward (s, o) and 5 backward (s, dp, dv, dq, dk); with
    one segment per row that is 2*B*H*T^2*D and 5*B*H*T^2*D. The dtype's
    peak: bf16 989 TFLOP/s; f32 the dense TF32 rate, 495 TFLOP/s, which
    no f32-accurate tensor-core scheme can beat (the split-TF32 kernels
    run three TF32 products for each). f32 rows also carry
    ``fma_bound_ms``, the bound over the 67 TFLOP/s f32 FMA peak that the
    earlier CUDA-core f32 kernels were held to."""
    n = B * T * H * D * elt
    small = 4 * B * T + 4 * B * H * T  # seg, lse
    peak = BF16_FLOPS_PER_S if elt == 2 else TF32_FLOPS_PER_S
    out = {}
    for name, nbytes, products in (("flash_attn_fwd", 4 * n + small, 2),
                                   ("flash_attn_bwd", 8 * n + small, 5)):
        flops = products * 2 * D * H * pairs
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        out[name] = dict(
            bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
        if elt == 4:
            out[name]["fma_bound_ms"] = max(t_bytes, flops / F32_FLOPS_PER_S) * 1e3
    return out


def attn_check(got: dict, want: dict, dtype: torch.dtype) -> dict:
    """For each output: its max abs error, the median and max |ref|, the
    tolerance and the share of it used (at most 1 passes). f32 outputs and
    lse: ATTN_F32_TOL, absolute. bf16 o and gradients: element by element,
    BF16_ULP * |ref| + BF16_FLOOR * max|ref|."""
    out = {}
    for n in got:
        err = (got[n].float() - want[n].float()).abs()
        ref = want[n].float().abs()
        top = float(ref.max())
        if dtype == torch.float32 or n == "lse":
            tol = ATTN_F32_TOL[0] if n in ("o", "lse") else ATTN_F32_TOL[1]
            used, tol_text = float(err.max()) / tol, f"{tol:g}"
        else:
            floor = BF16_FLOOR * top
            used = float((err / (BF16_ULP * ref + floor)).max())
            tol_text = f"2^-7|ref|+{floor:.3e}"
        out[n] = dict(err=float(err.max()), median_ref=float(ref.median()), max_ref=top,
                      tol=tol_text, used=used)
    return out


def attention_phase() -> list[dict]:
    """B4's forward and backward kernels against their plain versions at
    ATTN_SHAPES, with their times beside the plain versions',
    scaled_dot_product_attention's (the library call for the same function,
    timed here, never called by the port) and the bound."""
    import torch.nn.functional as F

    from tpu_rl_torch.ops import attention as A

    rows = []
    for B, T, H, D, dtype, seams, shuffled in ATTN_SHAPES:
        q, k, v, seg, do = attn_inputs(B, T, H, D, dtype, seams, B * T + D, shuffled)
        # the kernels' tile plan, made once per forward on the main path and
        # timed apart from the kernels
        plan = A.tile_plan(seg)
        visited, causal = tile_visits(seg)
        o, lse = A.flash_fwd(q, k, v, seg, plan)
        dq, dk, dv = A.flash_bwd(q, k, v, seg, o, lse, do, plan)
        torch.cuda.synchronize()
        o_p, lse_p = A.flash_attention_forward_plain(q, k, v, seg)
        grads_p = A.flash_attention_backward_plain(q, k, v, seg, o, lse, do)
        got = dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv)
        want = dict(o=o_p, lse=lse_p, dq=grads_p[0], dk=grads_p[1], dv=grads_p[2])
        checks = attn_check(got, want, dtype)
        errs = {n: c["err"] for n, c in checks.items()}
        finite = all(bool(torch.isfinite(t).all()) for t in got.values())
        if not finite or any(c["used"] > 1.0 for c in checks.values()):
            fail(f"B4 vs plain at {(B, T, H, D, dtype)}: {checks}, finite {finite}")

        big = B * H * T * T > 2**30
        kw = dict(iters=3, reps=3, warmup=2) if big else dict(iters=20, reps=3, warmup=3)
        fwd_ms = device_ms(lambda: A.flash_fwd(q, k, v, seg, plan), **kw)
        bwd_ms = device_ms(lambda: A.flash_bwd(q, k, v, seg, o, lse, do, plan), **kw)
        plan_ms = device_ms(lambda: A.tile_plan(seg), **kw)
        fwd_plain_ms = device_ms(lambda: A.flash_attention_forward_plain(q, k, v, seg), **kw)
        bwd_plain_ms = device_ms(
            lambda: A.flash_attention_backward_plain(q, k, v, seg, o, lse, do), **kw
        )
        # The library call: SDPA over (B,H,T,D) views with the same mask as
        # a boolean attn_mask, forward alone and the backward of one graph.
        idx = torch.arange(T, device=seg.device)
        mask = ((idx[None, :] <= idx[:, None])[None] & (seg[:, :, None] == seg[:, None, :]))[:, None]
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))

        def sdpa():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        lib_err = max_err(out.transpose(1, 2), o_p)
        lib_fwd_ms = device_ms(sdpa, **kw)
        lib_bwd_ms = device_ms(
            lambda: torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
            **kw,
        )
        bounds = attn_bounds(B, T, H, D, q.element_size(), visible_pairs(seg))
        row = dict(
            shape=dict(B=B, T=T, H=H, D=D, dtype=str(dtype).split(".")[-1], seams=seams,
                       shuffled=shuffled),
            errs=errs, checks=checks, sdpa_err=lib_err, tiles_visited=visited,
            tiles_causal=causal, plan_ms=plan_ms,
            flash_attn_fwd=dict(ms=fwd_ms, plain_ms=fwd_plain_ms, library_ms=lib_fwd_ms,
                                **bounds["flash_attn_fwd"]),
            flash_attn_bwd=dict(ms=bwd_ms, plain_ms=bwd_plain_ms, library_ms=lib_bwd_ms,
                                **bounds["flash_attn_bwd"]),
        )
        rows.append(row)
        for name in ("flash_attn_fwd", "flash_attn_bwd"):
            r = row[name]
            print(
                f"{name} B={B} T={T} H={H} D={D} {row['shape']['dtype']}: kernel_ms={r['ms']:.6f} "
                f"plain_ms={r['plain_ms']:.6f} sdpa_ms={r['library_ms']:.6f} "
                f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}, {r['bytes']} bytes, "
                f"{r['flops']} flops"
                + (f"; f32 FMA-peak bound {r['fma_bound_ms']:.6f}" if "fma_bound_ms" in r else "")
                + ")",
                flush=True,
            )
        print(
            f"flash_attn B={B} T={T} H={H} D={D} {row['shape']['dtype']}"
            f"{' shuffled ids' if shuffled else ''}: tile pairs visited {visited} of "
            f"{causal} causal (per head; the kernels' skip rule), tile plan {plan_ms:.6f} ms",
            flush=True,
        )
        print(
            f"flash_attn B={B} T={T} H={H} D={D} {row['shape']['dtype']}: max_abs_err "
            + ", ".join(f"{n} {c['err']:.3e} (tol {c['tol']}, used {c['used']:.3f}; |ref| "
                        f"median {c['median_ref']:.3e} max {c['max_ref']:.3e})"
                        for n, c in checks.items())
            + f"; sdpa vs plain {lib_err:.3e}",
            flush=True,
        )
        del q, k, v, seg, do, o, lse, dq, dk, dv, o_p, lse_p, grads_p, got, want, out, mask, plan
        del qt, kt, vt
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------ transformer training
def tf_batch(cfg, seed: int, device: str = "cuda", episodes: bool = False):
    """A seeded batch at ``cfg``'s shape as tests/test_transformer.py builds
    one: every row starts an episode and has one more seam mid-window (or,
    with ``episodes``, seams from CartPole-like episode lengths,
    ``episode_firsts``); uniform behaviour logits; 1-wide carry
    placeholders."""
    from tpu_rl_torch.types import Batch

    rng = np.random.default_rng(seed)
    B, S, A, D = cfg.batch_size, cfg.seq_len, cfg.action_space, int(cfg.obs_shape[0])
    if episodes:
        firsts = episode_firsts(B, S, torch.Generator().manual_seed(seed)).numpy()
        firsts = firsts[..., None].astype(np.float32)
    else:
        firsts = np.zeros((B, S, 1), np.float32)
        firsts[:, 0] = 1.0
        firsts[np.arange(B), rng.integers(1, S, size=B)] = 1.0
    return Batch.from_mapping(dict(
        obs=rng.normal(size=(B, S, D)).astype(np.float32),
        act=rng.integers(0, A, size=(B, S, 1)).astype(np.float32),
        rew=(0.1 * rng.normal(size=(B, S, 1))).astype(np.float32),
        logits=np.full((B, S, A), -np.log(A), np.float32),
        log_prob=np.full((B, S, 1), -np.log(A), np.float32),
        is_fir=firsts, hx=np.zeros((B, S, 1), np.float32), cx=np.zeros((B, S, 1), np.float32),
    ), device=device)


def on_device(tree, device):
    if isinstance(tree, dict):
        return {k: on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(on_device(v, device) for v in tree)
    return tree.to(device)


def tf_reference_check(dtype: str) -> dict:
    """One PPO step of a small transformer (flash impl, T=200 with seams) on
    the card, through B4's kernels, against the same step from the same
    state on the CPU, through B4's plain versions.

    float32 (D=32, the split-TF32 kernels): f32 on both sides, summed in
    other orders over 800 transitions: loss and grad norm at rtol 1e-4.
    bfloat16 (D=64, the tensor-core kernels): both sides round activations
    to bf16 at every layer, at other places (cuBLAS and the CPU's GEMMs
    round their f32 sums once; B4's kernels and plain versions differ by
    at most one bf16 ulp per element), so loss and grad norm are held at
    rtol 2e-3, the size of bf16's own effect: the CPU's bf16 step differs
    from its f32 step by about that much, printed beside."""
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.config import Config

    small = dict(batch_size=4, seq_len=200, n_layers=2, n_heads=2)
    if dtype == "float32":
        cfg = Config.from_dict(dict(TF_TRAIN_CFG, compute_dtype=dtype, hidden_size=64, **small))
        rtol = 1e-4
    else:
        cfg = Config.from_dict(dict(TF_TRAIN_CFG, compute_dtype=dtype, hidden_size=128, **small))
        rtol = 2e-3
    _f, state, step_cpu = get_algo("PPO").build(cfg, torch.Generator().manual_seed(0), device="cpu")
    _f, _s, step_dev = get_algo("PPO").build(cfg, torch.Generator().manual_seed(0), device="cuda")
    _new, want = step_cpu(state, tf_batch(cfg, 1, "cpu"))
    dev_state = state.replace(step=state.step.cuda(), params=on_device(state.params, "cuda"),
                              opt_state=on_device(state.opt_state, "cuda"))
    _new, got = step_dev(dev_state, tf_batch(cfg, 1, "cuda"))
    keys = ("loss", "grad-norm")
    out = {k: (float(got[k]), float(want[k])) for k in keys}
    gap = ""
    if dtype != "float32":
        f32 = cfg.replace(compute_dtype="float32")
        _f, state32, step32 = get_algo("PPO").build(f32, torch.Generator().manual_seed(0), device="cpu")
        _new, m32 = step32(state32, tf_batch(f32, 1, "cpu"))
        gap = "; the CPU's bf16 step vs its f32 step: " + " ".join(
            f"{k} {abs(out[k][1] - float(m32[k])) / abs(float(m32[k])):.3e}" for k in keys)
    for k, (g, w) in out.items():
        if not (np.isfinite(g) and abs(g - w) <= rtol * abs(w)):
            fail(f"transformer {dtype} train step on the card vs the CPU: {k} {g} vs {w} "
                 f"(rtol {rtol:g})")
    print(f"transformer {dtype} step (D={cfg.hidden_size // cfg.n_heads}) on the card vs the CPU: "
          + " ".join(f"{k} {g:.8f} vs {w:.8f} (rel {abs(g - w) / abs(w):.3e}, rtol {rtol:g})"
                     for k, (g, w) in out.items()) + gap, flush=True)
    return {k: dict(card=g, cpu=w, rtol=rtol) for k, (g, w) in out.items()}


def tf_f32_ref_check(card: str) -> dict:
    """TF_F32_REF's PPO step (flash, f32: B4's split-TF32 kernels at head
    width 64, tile skipping over CartPole-like episode seams) on the card
    against the same step on the CPU through B4's plain versions, from one
    seeded state and batch, at REF_TOL (``card_vs_cpu``); one forward and
    one backward launch per layer."""
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import attention as A

    cfg = Config.from_dict(TF_F32_REF)
    _f, state_cpu, step_cpu = get_algo("PPO").build(cfg, torch.Generator().manual_seed(0),
                                                    device="cpu")
    _f, _s, step_dev = get_algo("PPO").build(cfg, torch.Generator().manual_seed(0), device="cuda")
    batch_cpu = tf_batch(cfg, 1, "cpu", episodes=True)
    want_state, want = step_cpu(state_cpu, batch_cpu)
    A.FLASH_FWD_LAUNCHES = A.FLASH_BWD_LAUNCHES = 0
    got_state, got = step_dev(state_to(state_cpu, "cuda"), tf_batch(cfg, 1, "cuda", episodes=True))
    torch.cuda.synchronize()
    launches = (A.FLASH_FWD_LAUNCHES, A.FLASH_BWD_LAUNCHES)
    want_launches = (cfg.n_layers * cfg.K_epoch,) * 2
    if launches != want_launches:
        fail(f"transformer f32 flash step launched B4 {launches}, want {want_launches}")
    tag = "transformer PPO f32 flash (D=64)"
    errs, worst = card_vs_cpu(tag, got, want, got_state, want_state)
    seg = torch.cumsum(batch_cpu.is_fir[..., 0].to(torch.int32), 1, dtype=torch.int32)
    visited, causal = tile_visits(seg)
    print(
        f"{tag} B={cfg.batch_size} T={cfg.seq_len} d={cfg.hidden_size} heads={cfg.n_heads} "
        f"layers={cfg.n_layers}, {int(seg[:, -1].sum())} episodes, tile pairs visited {visited} "
        f"of {causal} causal: the card's step vs the CPU's: "
        + " ".join(f"{k} {v:.3e} (bar {REF_TOL[k]:g}{', ' + worst[k] if k in worst else ''})"
                   for k, v in errs.items())
        + f"; B4 launches {launches[0]}/{launches[1]} [{card}]",
        flush=True,
    )
    return dict(errs=errs, worst=worst, tol=REF_TOL, tiles_visited=visited, tiles_causal=causal,
                flash_attn_fwd_launches=launches[0], flash_attn_bwd_launches=launches[1])


def tf_train_row(card: str, algo: str = "PPO", impl: str = "flash", updates: int = TF_UPDATES,
                 warmup: int = TF_WARMUP, profiled: int = TF_PROFILE,
                 dtype: str = "bfloat16") -> dict:
    """The transformer's learner at full width (TF_TRAIN_CFG at compute
    dtype ``dtype``) with ``algo`` and attention ``impl``:
    get_algo(algo).build and its train_step on one
    seeded 16 x 2048 batch, ``warmup`` untimed then ``updates`` timed
    updates, then ``profiled`` updates under the profiler. The B4 launch
    counters are zeroed just before the timed updates and read just after:
    n_layers x K_epoch x updates each with flash, 0 otherwise. With
    blockwise, the tiles' share of device time is the attention's own
    forward and backward (timed alone on the step's shape and segments) x
    n_layers x K_epoch over the update's device time."""
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import attention as A

    cfg = Config.from_dict(dict(TF_TRAIN_CFG, algo=algo, attention_impl=impl,
                                compute_dtype=dtype))
    _family, state, train_step = get_algo(algo).build(
        cfg, torch.Generator().manual_seed(0), device="cuda"
    )
    # the bf16 model's build makes its products reduce in f32, as tpu_rl's do
    if dtype == "bfloat16" and torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        fail("building the bf16 transformer left cuBLAS free to reduce bf16 products in bf16")
    batch = tf_batch(cfg, 0, "cuda")
    for _ in range(warmup):
        state, metrics = train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.FLASH_FWD_LAUNCHES = A.FLASH_BWD_LAUNCHES = 0
    enqueue = []  # host time until train_step returns: what the host spends issuing it
    t0 = time.perf_counter()
    for _ in range(updates):
        t1 = time.perf_counter()
        state, metrics = train_step(state, batch)
        enqueue.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fwd, bwd = A.FLASH_FWD_LAUNCHES, A.FLASH_BWD_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * cfg.K_epoch * updates if impl == "flash" else 0
    tag = f"transformer training {algo} {impl}" + ("" if dtype == "bfloat16" else f" {dtype}")
    if fwd != want or bwd != want:
        fail(f"{tag} launched flash_attn_fwd {fwd} and flash_attn_bwd {bwd} times, want {want} "
             "each")
    host = {k: float(v) for k, v in metrics.items() if k != "diag"}
    if not all(np.isfinite(v) for v in host.values()) or host["nonfinite-updates"] != 0.0:
        fail(f"{tag} metrics not finite: {host}")
    if not all(bool(torch.isfinite(p).all()) for p in state.params["actor"].values()):
        fail(f"{tag} params not finite")

    # B4's share of device time, device time per update and the device
    # busy share over a few updates.
    b4_share = busy = device_ms_per_update = None
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(profiled):
                state, _m = train_step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in events)
        if device_us > 0:
            busy = device_us / 1e6 / wall
            b4_share = sum(e.self_device_time_total for e in events if "flash_" in e.key) / device_us
            device_ms_per_update = device_us / 1e3 / profiled
    except (RuntimeError, AttributeError) as e:
        print(f"{tag} profile: not measured ({e!r})", flush=True)
    tiles = tiles_share = None
    if impl == "blockwise":
        tiles = blockwise_step_ms(cfg, batch)
        if device_ms_per_update is not None:
            tiles_share = cfg.n_layers * cfg.K_epoch * tiles / device_ms_per_update

    n, s = cfg.batch_size, cfg.seq_len
    out = dict(
        algo=algo, impl=impl, updates=updates, batch=n, seq=s, hidden=cfg.hidden_size,
        heads=cfg.n_heads, layers=cfg.n_layers, dtype=cfg.compute_dtype,
        ms_per_update=dt / updates * 1e3, transitions_per_s=updates * n * s / dt,
        max_memory_allocated=peak, enqueue_ms=statistics.median(enqueue) * 1e3,
        device_ms_per_update=device_ms_per_update, b4_device_share=b4_share,
        blockwise_fwd_bwd_ms=tiles, tiles_device_share=tiles_share, device_busy=busy,
        flash_attn_fwd_launches=fwd, flash_attn_bwd_launches=bwd, loss=host["loss"],
    )
    nm = "not measured"
    print(
        f"{tag} B={n} T={s} d={cfg.hidden_size} heads={cfg.n_heads} layers={cfg.n_layers} "
        f"{cfg.compute_dtype}: {updates} updates, ms/update={out['ms_per_update']:.4f} "
        f"transitions/s={out['transitions_per_s']:.1f} host enqueue ms/update="
        f"{out['enqueue_ms']:.4f} device ms/update="
        f"{nm if device_ms_per_update is None else f'{device_ms_per_update:.4f}'} "
        f"max_memory_allocated={peak} B4 share of device time="
        f"{nm if b4_share is None else f'{b4_share:.4f}'}"
        + ("" if impl != "blockwise" else
           f" blockwise attention fwd+bwd {tiles:.4f} ms a layer, tiles' share of device time="
           f"{nm if tiles_share is None else f'{tiles_share:.4f}'}")
        + f" device_busy={nm if busy is None else f'{busy:.4f}'} loss={host['loss']:.6f} "
        f"flash_attn_fwd launches={fwd} flash_attn_bwd launches={bwd} (want {want}) [{card}]",
        flush=True,
    )
    return out


def tf_train_phase(card: str) -> dict:
    """The transformer's learner: the small card-vs-CPU PPO steps, then
    bench.py's PPO-transformer@longctx-flash row and, beside it, its
    longctx-blockwise row (the same model and batch, blockwise attention:
    B4 launches 0) and the longctx-flash row at compute dtype float32,
    tpu_rl's default (B4's f32 kernels)."""
    reference = {dt: tf_reference_check(dt) for dt in ("float32", "bfloat16")}
    reference["float32 flash D=64"] = tf_f32_ref_check(card)
    flash = tf_train_row(card)
    blockwise = tf_train_row(card, impl="blockwise", updates=TF_BLOCKWISE_UPDATES)
    flash_f32 = tf_train_row(card, updates=TF_F32_UPDATES, dtype="float32")
    return dict(flash, reference=reference, blockwise=blockwise, flash_f32=flash_f32)


def tf_colocated_phase(card: str, impl: str = "blockwise") -> dict:
    """The transformer's colocated loop: ColocatedLoop.program on
    configs/longcontext_singlechip.example.json at LONGCTX_LAYERS layers
    (env_mode set to colocated)
    for TF_COLOCATED_UPDATES updates of KV-cached acting and training, with
    the config's own blockwise attention (B4 launches 0) or with ``impl``
    in its place (flash: B4 launches n_layers x K_epoch x updates each
    way)."""
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import attention as A
    from tpu_rl_torch.runtime.colocated import ColocatedLoop

    raw = longctx_config()
    if raw["attention_impl"] != "blockwise":
        fail(f"the long-context config asks for {raw['attention_impl']!r}, not blockwise")
    cfg = Config.from_dict(dict(raw, env_mode="colocated", attention_impl=impl))
    loop = ColocatedLoop(cfg, seed=0, device="cuda")
    state, carry, stats = loop.state, loop.init_carry(), loop.init_stats()
    torch.cuda.synchronize()
    A.FLASH_FWD_LAUNCHES = A.FLASH_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(TF_COLOCATED_UPDATES):
        state, carry, stats, metrics = loop.program(state, carry, stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fwd, bwd = A.FLASH_FWD_LAUNCHES, A.FLASH_BWD_LAUNCHES
    want = cfg.n_layers * cfg.K_epoch * TF_COLOCATED_UPDATES if impl == "flash" else 0
    if fwd != want or bwd != want:
        fail(f"the {impl} colocated loop launched flash_attn_fwd {fwd} and flash_attn_bwd "
             f"{bwd} times, want {want} each")
    host = {k: float(v) for k, v in metrics.items() if k != "diag"}
    if not all(np.isfinite(v) for v in host.values()) or host["nonfinite-updates"] != 0.0:
        fail(f"transformer colocated metrics not finite: {host}")
    episodes = int(stats["episodes"])
    if episodes < 1:
        fail("the transformer colocated loop finished no episode")

    # One acting tick (decode, sampling, env step), where the rollout's time
    # goes: host clock over 32 ticks, device time over 8 in the profiler.
    params = {"actor": state.params["actor"]}
    with torch.no_grad():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(32):
            carry, _ys = loop._tick(params, carry, loop.generator)
        torch.cuda.synchronize()
        tick_ms = (time.perf_counter() - t1) / 32 * 1e3
        tick_device_ms = tick_events = None
        try:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(8):
                    carry, _ys = loop._tick(params, carry, loop.generator)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            if events:
                tick_device_ms = sum(e.self_device_time_total for e in events) / 1e3 / 8
                tick_events = sum(e.count for e in events) / 8
        except (RuntimeError, AttributeError) as e:
            print(f"tick profile: not measured ({e!r})", flush=True)
    n, s = loop.cfg.batch_size, loop.cfg.seq_len
    out = dict(
        impl=impl, updates=TF_COLOCATED_UPDATES, batch=n, seq=s, act_ctx=cfg.effective_act_ctx,
        ms_per_update=dt / TF_COLOCATED_UPDATES * 1e3,
        transitions_per_s=TF_COLOCATED_UPDATES * n * s / dt, episodes=episodes,
        mean_return=float(stats["ret_sum"]) / episodes, loss=host["loss"],
        flash_attn_fwd_launches=fwd, flash_attn_bwd_launches=bwd, tick_ms=tick_ms,
        tick_device_ms=tick_device_ms, tick_device_events=tick_events,
    )
    print(
        f"transformer colocated PPO CartPole B={n} T={s} act_ctx={cfg.effective_act_ctx} "
        f"d={cfg.hidden_size} {cfg.compute_dtype} {cfg.attention_impl}: {TF_COLOCATED_UPDATES} "
        f"updates, ms/update={out['ms_per_update']:.1f} transitions/s="
        f"{out['transitions_per_s']:.1f} episodes={episodes} mean_return="
        f"{out['mean_return']:.2f} loss={host['loss']:.6f} flash launches {fwd}/{bwd} (want "
        f"{want}: n_layers x K_epoch x updates with flash, 0 with blockwise); one tick "
        f"{tick_ms:.4f} ms, device "
        f"{'not measured' if tick_device_ms is None else f'{tick_device_ms:.4f}'} ms in "
        f"{tick_events} device events [{card}]",
        flush=True,
    )
    return out


# ------------------------------------------------- blockwise attention
def episode_firsts(B: int, T: int, g: torch.Generator, lo: int = EPISODE_LO,
                   hi: int = EPISODE_HI) -> torch.Tensor:
    """(B, T) int32 episode firsts from CartPole-like episode lengths, drawn
    uniformly from [lo, hi]; every row starts an episode."""
    firsts = torch.zeros((B, T), dtype=torch.int32)
    for b in range(B):
        t = 0
        while t < T:
            firsts[b, t] = 1
            t += int(torch.randint(lo, hi + 1, (1,), generator=g))
    return firsts


def seg_pos(firsts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Segment ids and segment-relative positions from (B, T) firsts, as the
    transformer's unroll makes them."""
    B, T = firsts.shape
    idx = torch.arange(T, dtype=torch.int32).expand(B, T)
    seam = torch.cummax(torch.where(firsts > 0, idx, 0), dim=1).values
    return torch.cumsum(firsts, 1, dtype=torch.int32), (idx - seam).to(torch.int32)


def blockwise_phase(card: str) -> list[dict]:
    """Blockwise attention (the port's plain-PyTorch tile loop, block 512)
    against full attention on the card at bench.py's longctx-blockwise
    attention shape (16, 2048, 8, 64), with seams from CartPole-like
    episodes: the output and the q/k/v gradients of a weighted loss. f32:
    tpu_rl's bars (value rtol 2e-5; o and grads rtol and atol 2e-4). bf16:
    blockwise and full round different values to bf16 (the unnormalised
    tile probabilities; the softmax), so each is held against full attention
    in f32 on the same bf16 inputs within BLOCKWISE_BF16_BAR x max|ref| per
    tensor (full in bf16's own share is printed beside). The peak memory of
    one forward and backward of each (torch.cuda.max_memory_allocated above
    the inputs) must differ by one (B,H,T,T) f32 score tensor or more; the
    device times of the forward and backward are timed beside B4's on the
    same inputs (B4 launches here are comparisons, not the main path)."""
    from tpu_rl_torch.ops import attention as A
    from tpu_rl_torch.parallel.sequence import BLOCKWISE_BLOCK, blockwise_attention, full_attention

    B, T, H, D = BLOCKWISE_SHAPE
    g = torch.Generator().manual_seed(17)
    seg, pos = (x.cuda() for x in seg_pos(episode_firsts(B, T, g)))
    scores_bytes = B * H * T * T * 4
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn((B, T, 3, H, D), generator=g).to(dtype).cuda()
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        w = torch.randn((B, T, H, D), generator=g).cuda()

        def run(fn, dt):
            xs = [x.detach().to(dt).requires_grad_() for x in (q, k, v)]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            o = fn(*xs, pos, seg)
            loss = (o.float() * w).sum()  # a sum: O(1) gradients, so the f32 bars bite
            grads = torch.autograd.grad(loss, xs)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            return float(loss.detach()), [o.detach(), *grads], peak

        got_loss, got, blk_peak = run(blockwise_attention, dtype)
        ref_loss, ref, _ = run(full_attention, torch.float32)
        _full_loss, full, full_peak = run(full_attention, dtype)
        names = ("o", "dq", "dk", "dv")
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        if dtype == torch.float32:
            val_used = abs(got_loss - ref_loss) / (2e-5 * abs(ref_loss))
            used = {n: float(((a - r).abs() / (2e-4 + 2e-4 * r.abs())).max())
                    for n, a, r in zip(names, got, ref, strict=True)}
            full_used = None
        else:
            val_used = None
            bar = {n: BLOCKWISE_BF16_BAR * float(r.abs().max()) for n, r in zip(names, ref)}
            used = {n: max_err(a, r) / bar[n] for n, a, r in zip(names, got, ref, strict=True)}
            full_used = {n: max_err(a, r) / bar[n] for n, a, r in zip(names, full, ref, strict=True)}
        errs = {n: max_err(a, r) for n, a, r in zip(names, got, ref, strict=True)}
        saved = full_peak - blk_peak
        tag = f"blockwise attention B={B} T={T} H={H} D={D} {str(dtype).split('.')[-1]}"
        if not finite or max(used.values()) > 1.0 or (val_used is not None and val_used > 1.0):
            fail(f"{tag} vs full: errors {errs}, share of the bar {used}, value {val_used}, "
                 f"finite {finite}")
        if saved < scores_bytes:
            fail(f"{tag}: peak memory {blk_peak} bytes, full attention's {full_peak}: below by "
                 f"{saved}, less than one (B,H,T,T) f32 score tensor ({scores_bytes})")

        kw = dict(iters=3, reps=3, warmup=1)
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        out = blockwise_attention(*xs, pos, seg)
        do = torch.randn(out.shape, generator=g).to(dtype).cuda()
        with torch.no_grad():
            fwd_ms = device_ms(lambda: blockwise_attention(q, k, v, pos, seg), **kw)
        bwd_ms = device_ms(lambda: torch.autograd.grad(out, xs, do, retain_graph=True), **kw)
        plan = A.tile_plan(seg)
        o4, lse4 = A.flash_fwd(q, k, v, seg, plan)
        b4_fwd_ms = device_ms(lambda: A.flash_fwd(q, k, v, seg, plan), **kw)
        b4_bwd_ms = device_ms(lambda: A.flash_bwd(q, k, v, seg, o4, lse4, do, plan), **kw)
        row = dict(dtype=str(dtype).split(".")[-1], shape=dict(B=B, T=T, H=H, D=D),
                   block=BLOCKWISE_BLOCK, errs=errs, bar_used=used, value_bar_used=val_used,
                   full_bf16_bar_used=full_used, peak_bytes=blk_peak, full_peak_bytes=full_peak,
                   saved_bytes=saved, fwd_ms=fwd_ms, bwd_ms=bwd_ms, b4_fwd_ms=b4_fwd_ms,
                   b4_bwd_ms=b4_bwd_ms)
        rows.append(row)
        print(
            f"{tag} block {BLOCKWISE_BLOCK} vs full: max_abs_err "
            + ", ".join(f"{n} {errs[n]:.3e} (used {used[n]:.3f})" for n in names)
            + ("" if val_used is None else f", value used {val_used:.3f} (rtol 2e-5)")
            + ("" if full_used is None else
               f"; bar {BLOCKWISE_BF16_BAR:g} x max|ref| vs full in f32 on the same bf16 inputs, "
               "full attention in bf16 uses " + ", ".join(f"{n} {full_used[n]:.3f}" for n in names))
            + f"; peak memory {blk_peak} vs full {full_peak} bytes (below by {saved}, bar "
            f"{scores_bytes}); device ms fwd {fwd_ms:.4f} bwd {bwd_ms:.4f}, B4 fwd "
            f"{b4_fwd_ms:.4f} bwd {b4_bwd_ms:.4f} [{card}]",
            flush=True,
        )
        del qkv, q, k, v, w, got, ref, full, xs, out, do, o4, lse4, plan
        torch.cuda.empty_cache()
    return rows


def blockwise_step_ms(cfg, batch) -> float:
    """Device ms of one blockwise attention forward and backward at the
    train step's shape (B, T, heads, hidden/heads), in the compute dtype,
    on the batch's segments and positions: one layer's tiles."""
    from tpu_rl_torch.parallel.sequence import blockwise_attention

    B, T, H = cfg.batch_size, cfg.seq_len, cfg.n_heads
    D = cfg.hidden_size // H
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    seg, pos = (x.cuda() for x in seg_pos(batch.is_fir[..., 0].cpu().to(torch.int32)))
    g = torch.Generator().manual_seed(23)
    xs = [torch.randn((B, T, H, D), generator=g).to(dtype).cuda().requires_grad_()
          for _ in range(3)]
    do = torch.randn((B, T, H, D), generator=g).to(dtype).cuda()

    def fwd_bwd():
        torch.autograd.grad(blockwise_attention(*xs, pos, seg), xs, do)

    return device_ms(fwd_bwd, iters=3, reps=3, warmup=1)


# ------------------------------------------- transformer IMPALA and V-MPO
def tf_algos_phase(card: str) -> dict:
    """IMPALA and V-MPO on the transformer: each TF_REF row's step on the
    card against the same step on the CPU, from one seeded state, batch and
    shared noise, at REF_TOL; then each at full width (TF_TRAIN_CFG, flash)
    for TF_ALGO_UPDATES timed updates with the B4 launches counted."""
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.config import Config

    out = {}
    for algo in ("IMPALA", "V-MPO"):
        cfg = Config.from_dict(dict(TF_REF, algo=algo))
        _f, state_cpu, step_cpu = get_algo(algo).build(cfg, torch.Generator().manual_seed(0),
                                                       device="cpu")
        _f, _s, step_dev = get_algo(algo).build(cfg, torch.Generator().manual_seed(0),
                                                device="cuda")
        noise = step_noise(algo, cfg, None, torch.Generator().manual_seed(2))
        want_state, want = step_cpu(state_cpu, tf_batch(cfg, 1, "cpu"), **noise)
        got_state, got = step_dev(state_to(state_cpu, "cuda"), tf_batch(cfg, 1, "cuda"),
                                  **on_device(noise, "cuda"))
        torch.cuda.synchronize()
        tag = f"transformer {algo}@ref"
        errs, worst = card_vs_cpu(tag, got, want, got_state, want_state)
        print(
            f"{tag} B={cfg.batch_size} T={cfg.seq_len} d={cfg.hidden_size} heads={cfg.n_heads} "
            f"layers={cfg.n_layers} {cfg.attention_impl} f32: the card's step vs the CPU's: "
            + " ".join(f"{k} {v:.3e} (bar {REF_TOL[k]:g}{', ' + worst[k] if k in worst else ''})"
                       for k, v in errs.items()) + f" [{card}]",
            flush=True,
        )
        wide = tf_train_row(card, algo, "flash", updates=TF_ALGO_UPDATES, warmup=1, profiled=1)
        out[algo] = dict(ref=dict(errs=errs, worst=worst, tol=REF_TOL), wide=wide)
    return out


# ------------------------------------------------- transformer serving
def longctx_config() -> dict:
    """configs/longcontext_singlechip.example.json at LONGCTX_LAYERS layers."""
    raw = json.loads((ROOT / "configs" / "longcontext_singlechip.example.json").read_text())
    return dict(raw, n_layers=LONGCTX_LAYERS)


def tf_serve_cfg(dtype: str, compute_dtype: str | None = None, **kw):
    """configs/longcontext_singlechip.example.json's model (CartPole's obs 4
    and 2 actions, LONGCTX_LAYERS layers) behind the serving keys of
    SERVE_CFG, unfused (act_kernel "xla": the fused kernel covers the LSTM
    only), at ``inference_dtype=dtype``."""
    from tpu_rl_torch.config import Config

    raw = longctx_config()
    serve = {k: v for k, v in SERVE_CFG.items() if k.startswith(("inference", "worker"))}
    raw.update(serve, obs_shape=(4,), action_space=2, act_kernel="xla", inference_dtype=dtype,
               **kw)
    if compute_dtype is not None:
        raw["compute_dtype"] = compute_dtype
    return Config.from_dict(raw)


def tf_streams(k: int, envs: int, acts: int) -> tuple[np.ndarray, np.ndarray]:
    """Client ``k``'s obs (acts, envs, 4) and firsts (acts, envs): env 0 runs
    one episode through every act (past act_ctx, so its ring wraps); the
    others restart after CartPole-like lengths (``episode_firsts``)."""
    g = torch.Generator().manual_seed(1000 + k)
    obs = (0.5 * torch.randn((acts, envs, 4), generator=g)).numpy()
    firsts = episode_firsts(envs, acts, g).T.numpy().astype(np.float32)
    firsts[1:, 0] = 0.0
    return obs, firsts


def tf_serve_phase(card: str, dtype: str = "f32", compute_dtype: str | None = None,
                   mixes: tuple = TF_SERVE_MIXES) -> dict:
    """The transformer served through InferenceService over a LocalRouter
    (tf_serve_cfg), KV caches in the service's carry table on the card:
    the mixes with episode resets; every reply of the TF_SERVE_KEEP clients
    (mix 1's always, mix 2's under f32 compute) against a replay of
    family.act on the card from their obs and first streams (the served,
    widened params), at TF_REPLAY_BAR; mix 1's client 0's env 0, whose
    episode runs through the mix, against _act_transformer_window for its
    first act_ctx steps (1e-5 under f32 compute, tpu_rl's bf16 bar, rtol
    0.05 and atol 0.03, under bf16 compute); host-to-device bytes per flush
    against obs, first and slot alone; a param swap served with its
    version; the device time and kernels of the act step per 256-row flush
    under the profiler."""
    from tpu_rl_torch.models.families import _act_transformer_window, build_family
    from tpu_rl_torch.models.quant import dequantize_tree, quantize_tree
    from tpu_rl_torch.runtime.inference_service import InferenceService
    from tpu_rl_torch.runtime.local_router import LocalRouter
    from tpu_rl_torch.utils.timer import ExecutionTimer

    cfg = tf_serve_cfg(dtype, compute_dtype)
    family = build_family(cfg, device="cuda")
    params = seeded_params(family, 0)
    served = {"actor": dequantize_tree(quantize_tree(params, dtype))["actor"]}
    tol = (0.0, 1e-5) if cfg.compute_dtype == "float32" else (0.05, 0.03)  # (rtol, atol)
    tag = f"transformer serving {dtype} weights, {cfg.compute_dtype} compute"
    router = LocalRouter()
    timer = ExecutionTimer(window=1_000_000)
    svc = InferenceService(cfg, family, params, router, timer, seed=0, device="cuda").start()
    results = []
    try:
        if not svc.wait_ready(300.0) or svc.error is not None:
            fail(f"{tag}: the service did not start: {svc.error!r}")
        f32 = cfg.compute_dtype == "float32"
        for n_clients, acts, name in mixes:
            timer.elapsed.clear()
            timer.gauges.clear()
            mix = drive(cfg, router, n_clients, 4, acts, f"{dtype}-{name}",
                        streams=lambda k, acts=acts: tf_streams(k, 4, acts),
                        keep=TF_SERVE_KEEP[name] if name == "mix1" or f32 else (), carry=False)
            mix["flush_ms"] = timer.mean_elapsed("inference-step-time") * 1e3
            mix["flush_rows"] = timer.mean_gauge("inference-batch-size")
            mix["name"] = name
            results.append(mix)
            if mix["client_failures"] or mix["bad_replies"]:
                fail(f"{tag} {name}: {mix['client_failures']} requests unanswered, "
                     f"{mix['bad_replies']} replies malformed")

        # the host-to-device copies so far: obs, first and slot per row of
        # each warm-up and flush, at the bucket's rows
        row_bytes = 4 * (int(cfg.obs_shape[0]) + 2)
        want_h2d = sum((svc.n_flush_bucket.get(b, 0) + 1) * b * row_bytes for b in svc.buckets)
        if svc.h2d_bytes != want_h2d:
            fail(f"{tag}: {svc.h2d_bytes} bytes went to the card, want obs/first/slot's "
                 f"{want_h2d}")
        flushes = svc.n_batches

        # replay the kept clients' streams through family.act on the card
        hw, cw = family.carry_widths
        replays = {}
        for mix in results:
            ks = sorted(mix["kept"])
            if not ks:
                continue
            streams = [tf_streams(k, 4, mix["acts"]) for k in ks]
            h = torch.zeros((4 * len(ks), hw), device="cuda")
            c = torch.zeros((4 * len(ks), cw), device="cuda")
            err = 0.0
            with torch.no_grad():
                for t in range(mix["acts"]):
                    obs = torch.from_numpy(np.concatenate([s[0][t] for s in streams])).cuda()
                    keep_ = torch.from_numpy(np.concatenate([s[1][t] for s in streams]) < 0.5)
                    keep_ = keep_.cuda()[:, None]
                    h, c = torch.where(keep_, h, 0.0), torch.where(keep_, c, 0.0)
                    _a, logits, _lp, h, c = family.act(served, obs, h, c)
                    got = np.concatenate([mix["kept"][k][t]["logits"] for k in ks])
                    err = max(err, float(np.abs(got - logits.cpu().numpy()).max()))
            replays[mix["name"]] = dict(clients=list(ks), err=err, bar=TF_REPLAY_BAR[mix["name"]])
            if err > TF_REPLAY_BAR[mix["name"]]:
                fail(f"{tag} {mix['name']}: clients {ks}' replies differ from their replay by "
                     f"{err:.3e}, bar {TF_REPLAY_BAR[mix['name']]:g}")
        # the window oracle: mix 1's client 0's env 0 for its first act_ctx steps
        mix1 = next(m for m in results if m["name"] == "mix1")
        obs0 = tf_streams(0, 4, mix1["acts"])[0]
        ctx = cfg.effective_act_ctx
        hist, count = torch.zeros((1, ctx * 4), device="cuda"), torch.zeros((1, 1), device="cuda")
        window_used = window_err = 0.0
        with torch.no_grad():
            for t in range(min(ctx, mix1["acts"])):
                obs = torch.from_numpy(obs0[t][:1]).cuda()
                _a, logits, _lp, hist, count = _act_transformer_window(
                    family.actor, ctx, 4, served, obs, hist, count)
                want = logits.cpu().numpy()
                got = mix1["kept"][0][t]["logits"][:1]
                err = np.abs(got - want)
                window_err = max(window_err, float(err.max()))
                window_used = max(window_used, float((err / (tol[1] + tol[0] * np.abs(want))).max()))
        if window_used > 1.0:
            fail(f"{tag}: replies vs the window oracle {window_err:.3e} (share "
                 f"{window_used:.3f}); bar rtol {tol[0]} atol {tol[1]}")

        # the act step alone at 256 rows, caches full (device time); then
        # the device time and kernels per flush of a mix-2 burst under the
        # profiler (gather, widening, act step, scatter, copies)
        g = torch.Generator().manual_seed(29)
        obs = torch.randn((256, 4), generator=g).cuda()
        h = torch.randn((256, hw), generator=g).cuda()
        c = torch.randn((256, cw), generator=g).cuda()
        c[:, -1] = ctx - 1
        with torch.no_grad():
            act_ms = device_ms(lambda: family.act(served, obs, h, c), iters=5, reps=3, warmup=2)
        del h, c
        flush_device_ms = flush_kernels = flush_rows = None
        big = [m for m in mixes if m[2] == "mix2"]
        if big:
            from torch.profiler import ProfilerActivity, profile

            before, by_bucket = svc.n_batches, dict(svc.n_flush_bucket)
            try:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    drive(cfg, router, big[0][0], 4, TF_SERVE_PROFILED, f"{dtype}-prof",
                          streams=lambda k: tf_streams(k, 4, TF_SERVE_PROFILED), carry=False)
                    torch.cuda.synchronize()
                n = svc.n_batches - before
                events = [e for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA]
                if events and n:
                    flush_device_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
                    flush_kernels = sum(e.count for e in events) / n
                    flush_rows = sum(b * (k - by_bucket.get(b, 0))
                                     for b, k in svc.n_flush_bucket.items()) / n
            except (RuntimeError, AttributeError) as e:
                print(f"{tag} profile: not measured ({e!r})", flush=True)

        probe = router.client(b"probe")
        first = np.ones(4, np.float32)
        r1 = probe.act(obs0[0], first)
        svc.set_params(seeded_params(family, 1), version=7)
        r2 = probe.act(obs0[0], first)
        if r1 is None or r2 is None or r2["ver"] != 7 or np.allclose(r1["logits"], r2["logits"]):
            fail(f"{tag}: a param swap was not served with its version")
    finally:
        svc.close()
    if svc.error is not None:
        fail(f"{tag}: the service died: {svc.error!r}")
    out = dict(
        dtype=dtype, compute_dtype=cfg.compute_dtype, act_ctx=cfg.effective_act_ctx,
        mixes=[{k: v for k, v in m.items() if k != "kept"} for m in results],
        flushes=flushes, n_flush_bucket=dict(sorted(svc.n_flush_bucket.items())),
        h2d_bytes=svc.h2d_bytes, h2d_bytes_per_row=row_bytes, carry_bytes=svc.carry_bytes,
        carry_bytes_per_row=4 * (hw + cw), param_bytes=svc.param_bytes,
        replays=replays, window_err=window_err,
        window_bar_used=window_used, act_device_ms_256=act_ms,
        flush_device_ms=flush_device_ms, flush_kernels=flush_kernels,
        flush_bucket_rows=flush_rows,
    )
    for m in out["mixes"]:
        print(f"{tag} {m['name']} {m['clients']} clients x {m['envs']} envs x {m['acts']} acts: "
              f"acts/s={m['acts_per_s']:.1f} p50_ms={m['p50_ms']:.4f} p99_ms={m['p99_ms']:.4f} "
              f"flush_ms={m['flush_ms']:.4f} flush_rows={m['flush_rows']:.1f} client_failures="
              f"{m['client_failures']} [{card}]", flush=True)
    nm = "not measured"
    print(
        f"{tag}: flushes per bucket {out['n_flush_bucket']}; host-to-device {svc.h2d_bytes} bytes "
        f"= {row_bytes} a row (obs, first, slot) over warm-ups and flushes; carry table "
        f"{svc.carry_bytes} bytes on the card ({out['carry_bytes_per_row']} a row); param_bytes "
        f"{svc.param_bytes}; replays: "
        + "; ".join(f"{n} clients {r['clients']}: max err {r['err']:.3e} (bar {r['bar']:g})"
                    for n, r in replays.items())
        + f"; window oracle over {min(ctx, mix1['acts'])} steps: "
        f"{window_err:.3e} (share {window_used:.3f}); family.act alone at 256 rows, caches "
        f"full: {act_ms:.4f} device ms; a mix-2 burst under the profiler: "
        f"{nm if flush_device_ms is None else f'{flush_device_ms:.4f}'} device ms and "
        f"{nm if flush_kernels is None else f'{flush_kernels:.1f}'} kernels a flush "
        f"(mean bucket rows {nm if flush_rows is None else f'{flush_rows:.1f}'}) [{card}]",
        flush=True,
    )
    return out


# --------------------------------------------------------- telemetry plane
def free_port() -> int:
    """A port free to bind, outside every block :func:`free_block` has
    handed out."""
    import socket

    while True:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        if not any(lo <= port < hi for lo, hi in _BLOCKS):
            return port


def gauges_of(loop) -> dict:
    """The colocated loop's registry: {name: value} of its counters and
    gauges (unlabeled series)."""
    snap = loop.aggregator.registry.snapshot()
    return {e[0]: e[2] for kind in ("counters", "gauges") for e in snap[kind] if not e[1]}


def telemetry_colocated_check(card: str) -> dict:
    """(a) The training config's colocated loop on the card with the plane
    on, through ColocatedLoop.run: scrapes /metrics, /healthz and /goodput
    mid-run, asks /prof for a bounded capture, and holds the files, the
    FLOPs per update (against the CPU's count of the same update), the B1/B2
    launches (= updates) and the trace's kernel names. Then ms/update with
    the plane on and off in turns, and params bit for bit equal."""
    import shutil
    import tempfile
    import urllib.request

    from tpu_rl_torch.config import Config
    from tpu_rl_torch.obs import PerfTracker
    from tpu_rl_torch.ops import lstm as L
    from tpu_rl_torch.runtime.colocated import ColocatedLoop
    from tpu_rl_torch.utils.tree import tree_leaves

    # the CPU's count of the same update (the plain versions beneath B1/B2)
    cpu = ColocatedLoop(Config(**TRAIN_CFG), seed=0, device="cpu")
    tracker = PerfTracker("cpu")
    tracker.call(cpu.program, cpu.state, cpu.init_carry(), cpu.init_stats())
    cpu_flops = tracker.flops_per_call

    with tempfile.TemporaryDirectory(prefix="tpu_rl_telemetry_") as d:
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        cfg = Config(**TRAIN_CFG, result_dir=d, telemetry_port=port,
                     loss_log_interval=TELEMETRY_LOG, telemetry_interval_s=1e-3,
                     slo_spec=TELEMETRY_SLO)
        loop = ColocatedLoop(cfg, seed=0, max_updates=TELEMETRY_UPDATES, device="cuda")
        scraped, prof = {}, {}
        tick = loop._telemetry_tick

        def tick_and_scrape(updates, *a):
            tick(updates, *a)
            if updates == TELEMETRY_LOG:
                # a bounded capture through /prof, given a second to start
                with urllib.request.urlopen(f"{base}/prof?ms=5000", timeout=60) as r:
                    prof.update(json.loads(r.read()), status=r.status)
                time.sleep(1.0)
            if updates == 2 * TELEMETRY_LOG:  # the first window's diag is published
                for path in ("/metrics", "/healthz", "/goodput"):
                    with urllib.request.urlopen(base + path, timeout=60) as r:
                        scraped[path] = (r.status, r.read().decode())

        loop._telemetry_tick = tick_and_scrape
        L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
        run = loop.run(log=False)
        fwd, bwd = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
        files = sorted(os.listdir(d))
        doc = json.loads(open(os.path.join(d, "telemetry.json")).read())
        learn = [json.loads(x) for x in open(os.path.join(d, "learn.jsonl"))]
        slo = json.loads(open(os.path.join(d, "slo.json")).read())
        history_files = os.listdir(os.path.join(d, "history"))
        trace_path = os.path.join(prof.get("trace_dir", ""), "trace.json")
        kernels = set()
        if os.path.exists(trace_path):
            events = json.loads(open(trace_path).read()).get("traceEvents", [])
            kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
        # the run's files but the profiler trace, for report_compare_check
        kept_dir = tempfile.mkdtemp(prefix="tpu_rl_telemetry_run_")
        shutil.copytree(d, kept_dir, ignore=shutil.ignore_patterns("prof"), dirs_exist_ok=True)
    gauges = {g[0]: g[2] for src in doc["sources"] for g in src["gauges"] + src["counters"]
              if not g[1]}
    want = TELEMETRY_UPDATES * cfg.K_epoch
    checks = {
        "files": {"telemetry.json", "learn.jsonl", "goodput.jsonl", "slo.json", "history",
                  "prof"} <= set(files) and bool(history_files),
        "flops_card_equals_cpu": gauges.get("colocated-flops-per-step") == cpu_flops > 0,
        "launches": fwd == bwd == want,
        "recompiles": gauges.get("colocated-xla-recompiles") == 0,
        "learn_cadence": [r["idx"] for r in learn] == list(
            range(TELEMETRY_LOG, TELEMETRY_UPDATES + 1, TELEMETRY_LOG)),
        "slo": slo.get("ok") is True,
        "metrics": scraped.get("/metrics", (0, ""))[0] == 200
        and "\ncolocated_mfu{" in scraped["/metrics"][1]
        and "\nlearner_diag_entropy{" in scraped["/metrics"][1],
        "healthz": scraped.get("/healthz", (0,))[0] == 200,
        "goodput": scraped.get("/goodput", (0,))[0] == 200
        and json.loads(scraped["/goodput"][1])["colocated"]["buckets"]["compute"] > 0,
        "prof": prof.get("status") == 200
        and any("lstm_fwd" in k for k in kernels) and any("lstm_bwd" in k for k in kernels),
    }
    print(
        f"telemetry (a) colocated PPO B={loop.cfg.batch_size} S={cfg.seq_len} H={cfg.hidden_size} "
        f"{TELEMETRY_UPDATES} updates: flops/update card {gauges.get('colocated-flops-per-step')} "
        f"cpu {cpu_flops}; achieved_flops/s {gauges.get('colocated-achieved-flops')} "
        f"mfu {gauges.get('colocated-mfu')} (bf16 peak); device_mem {gauges.get('colocated-device-mem-bytes')} "
        f"peak {gauges.get('colocated-device-mem-peak-bytes')} bytes; lstm launches {fwd}/{bwd}; "
        f"files {files}; learn idx {[r['idx'] for r in learn]}; slo ok {slo.get('ok')}; "
        f"trace kernels {sorted(k for k in kernels if 'lstm' in k)} [{card}]",
        flush=True,
    )
    print(f"telemetry (a) checks {checks}", flush=True)
    if not all(checks.values()):
        fail(f"telemetry (a): failed checks {[k for k, v in checks.items() if not v]}")

    # ms/update with the plane on and off, in turns: over the whole run
    # (the plane's one-time count of the first update included), and the
    # median of the log windows after the first (steady state); params bit
    # for bit
    timed, steady, states = {"off": [], "on": []}, {"off": [], "on": []}, {}
    for mode in ("off", "on", "on", "off"):
        with tempfile.TemporaryDirectory(prefix="tpu_rl_telemetry_") as d:
            extra = dict(result_dir=d, slo_spec=TELEMETRY_SLO) if mode == "on" else {}
            loop = ColocatedLoop(Config(**TRAIN_CFG, loss_log_interval=TELEMETRY_LOG, **extra),
                                 seed=0, max_updates=TELEMETRY_TIMED, device="cuda")
            windows = []
            tick = loop._telemetry_tick

            def tick_and_note(updates, env_steps, episodes, ups, tps, chunk_s, *a,
                              tick=tick, windows=windows):
                windows.append(chunk_s)
                tick(updates, env_steps, episodes, ups, tps, chunk_s, *a)

            loop._telemetry_tick = tick_and_note
            out = loop.run(log=False)
        timed[mode].append(out["elapsed_s"] / TELEMETRY_TIMED * 1e3)
        steady[mode].append(statistics.median(windows[1:]) * 1e3)
        states.setdefault(mode, loop.state)
    equal = all(
        torch.equal(a, b) for tree in ("params", "opt_state")
        for a, b in zip(tree_leaves(getattr(states["off"], tree)),
                        tree_leaves(getattr(states["on"], tree)), strict=True)
    )
    print(
        f"telemetry (a) ms/update over {TELEMETRY_TIMED} updates (off, on, on, off): whole run "
        f"off {[round(x, 6) for x in timed['off']]} on {[round(x, 6) for x in timed['on']]}; "
        f"median log window after the first: off {[round(x, 6) for x in steady['off']]} on "
        f"{[round(x, 6) for x in steady['on']]}; params and moments bit for bit equal on/off: "
        f"{equal} [{card}]",
        flush=True,
    )
    if not equal:
        fail("telemetry (a): params with the plane on differ from the plane off")
    return dict(updates=TELEMETRY_UPDATES, result_dir=kept_dir,
                flops_per_update=gauges.get("colocated-flops-per-step"),
                cpu_flops_per_update=cpu_flops,
                achieved_flops=gauges.get("colocated-achieved-flops"),
                mfu=gauges.get("colocated-mfu"), lstm_fwd_launches=fwd, lstm_bwd_launches=bwd,
                ms_per_update_off=timed["off"], ms_per_update_on=timed["on"],
                steady_ms_per_update_off=steady["off"], steady_ms_per_update_on=steady["on"],
                trace_kernels=sorted(kernels), checks=checks)


def telemetry_wide_check(card: str) -> dict:
    """(b) IMPALA at bench.py's wide-lstm width in the colocated loop with
    the plane on (a log tick every update), WIDE_COLOCATED_WARMUP +
    WIDE_COLOCATED_UPDATES updates: the FLOPs per update, achieved FLOP/s
    and MFU as the plane reports them (over every update) and over the
    timed updates alone, and the memory gauges against
    torch.cuda.max_memory_allocated()."""
    import tempfile

    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import lstm as L
    from tpu_rl_torch.runtime.colocated import ColocatedLoop

    n_up = WIDE_COLOCATED_WARMUP + WIDE_COLOCATED_UPDATES
    with tempfile.TemporaryDirectory(prefix="tpu_rl_telemetry_") as d:
        cfg = Config(**WIDE_COLOCATED_CFG, result_dir=d, loss_log_interval=1,
                     telemetry_interval_s=1e-3)
        loop = ColocatedLoop(cfg, seed=0, max_updates=n_up, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
        out = loop.run(log=False)
        fwd, bwd = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
        torch_peak = torch.cuda.max_memory_allocated()
    g = gauges_of(loop)
    perf = loop._perf
    timed = list(perf._dts)[WIDE_COLOCATED_WARMUP:]
    ms = statistics.median(timed) * 1e3
    achieved = perf.flops_per_call / (ms / 1e3)
    res = dict(
        batch=loop.cfg.batch_size, seq=cfg.seq_len, hidden=cfg.hidden_size,
        flops_per_update=perf.flops_per_call, achieved_flops=g.get("colocated-achieved-flops"),
        mfu=g.get("colocated-mfu"), ms_per_update_timed=ms, achieved_flops_timed=achieved,
        mfu_timed=achieved / perf.peak if perf.peak else None,
        device_mem_bytes=g.get("colocated-device-mem-bytes"),
        device_mem_peak_bytes=g.get("colocated-device-mem-peak-bytes"),
        max_memory_allocated=torch_peak, lstm_fwd_launches=fwd, lstm_bwd_launches=bwd,
        loss_finite=bool(np.isfinite(out["mean_return_overall"])),
    )
    print(
        f"telemetry (b) colocated IMPALA CartPole B={res['batch']} S={res['seq']} "
        f"H={res['hidden']}: flops/update {res['flops_per_update']} achieved_flops/s (plane, all "
        f"{n_up} updates) {res['achieved_flops']} mfu {res['mfu']}; timed {WIDE_COLOCATED_UPDATES}: "
        f"ms/update {ms:.6f} achieved_flops/s {achieved:.6e} mfu {res['mfu_timed']}; device_mem "
        f"{res['device_mem_bytes']} peak gauge {res['device_mem_peak_bytes']} "
        f"torch.cuda.max_memory_allocated {torch_peak}; lstm launches {fwd}/{bwd} [{card}]",
        flush=True,
    )
    if fwd != n_up or bwd != n_up:
        fail(f"telemetry (b): lstm launches {fwd}/{bwd}, want {n_up} each")
    if res["device_mem_peak_bytes"] != torch_peak:
        fail("telemetry (b): the device-mem-peak gauge is not torch.cuda.max_memory_allocated()")
    if not perf.flops_per_call > 0 or res["mfu"] is None:
        fail(f"telemetry (b): no FLOPs or MFU: {res}")
    return res


def telemetry_serving_check(card: str) -> dict:
    """(c) Serving mix 1 with the plane on and off, in turns (off, on, on,
    off): the bucket counters publish_serving_metrics replays against the
    service's flushes and B3's launches (one warm-up each), no recompile,
    each bucket's FLOPs by B3's formula."""
    from tpu_rl_torch.ops import fused_act as FA

    runs = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        r = serve_phase(mixes=TELEMETRY_SERVE_MIX, telemetry=mode == "on")
        serving_checks(r, f"serving telemetry {mode}", card)
        runs[mode].append(r)
    for r in runs["on"]:
        t = r["telemetry"]
        flushes = {b: n for b, n in r["n_flush_bucket"].items()}
        from_launches = {b: n - 1 for b, n in r["launches_by_rows"].items() if n > 1}
        formula = {b: FA.act_flops(b, 4, SERVE_CFG["hidden_size"], SERVE_CFG["action_space"])
                   for b in r["buckets"]}
        print(
            f"telemetry (c) serving mix1: inference-xla-recompiles {t['recompiles']}; "
            f"inference-bucket-flushes {t['bucket_flushes']} n_flush_bucket {flushes} "
            f"LAUNCHES_BY_ROWS - 1 {from_launches}; flops/act step {t['flops_per_act_step']}; "
            f"achieved_flops/s {t['achieved_flops']} mfu {t['mfu']}; goodput {t['goodput']} "
            f"[{card}]",
            flush=True,
        )
        if t["recompiles"] != 0:
            fail(f"telemetry (c): {t['recompiles']} recompiles")
        if not (t["bucket_flushes"] == flushes == from_launches):
            fail("telemetry (c): the bucket counters disagree with the flushes or B3's launches")
        if t["flops_per_act_step"] != formula:
            fail(f"telemetry (c): FLOPs per act step {t['flops_per_act_step']}, want {formula}")
    acts = {m: [r["mixes"][0]["acts_per_s"] for r in rs] for m, rs in runs.items()}
    print(f"telemetry (c) serving mix1 acts/s (off, on, on, off): off {acts['off']} on "
          f"{acts['on']} [{card}]", flush=True)
    return dict(acts_per_s=acts, launches=runs["on"][0]["launches"],
                telemetry=runs["on"][0]["telemetry"])


def telemetry_transformer_count(card: str) -> dict:
    """(d) One transformer train step at full width (bench.py's
    longctx-flash row) counted on the card: B4's operators are charged
    their formula once per launch."""
    from torch.utils.flop_counter import FlopCounterMode

    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import attention as A

    cfg = Config.from_dict(TF_TRAIN_CFG)
    _family, state, train_step = get_algo("PPO").build(
        cfg, torch.Generator().manual_seed(0), device="cuda")
    batch = tf_batch(cfg, 0, "cuda")
    A.FLASH_FWD_LAUNCHES = A.FLASH_BWD_LAUNCHES = 0
    with FlopCounterMode(display=False) as counter:
        state, metrics = train_step(state, batch)
    torch.cuda.synchronize()
    counts = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    B, T, H = cfg.batch_size, cfg.seq_len, cfg.n_heads
    D = cfg.hidden_size // H
    fwd, bwd = A.FLASH_FWD_LAUNCHES, A.FLASH_BWD_LAUNCHES
    want = {"tpu_rl_torch.flash_fwd": fwd * A.attn_flops(B, T, H, D),
            "tpu_rl_torch.flash_bwd": bwd * A.attn_flops(B, T, H, D, True)}
    total = counter.get_total_flops()
    b4 = sum(want.values())
    print(f"telemetry (d) transformer train step {B}x{T} d{cfg.hidden_size} L{cfg.n_layers}: "
          f"flops/update {total}, B4 {counts.get('tpu_rl_torch.flash_fwd')} + "
          f"{counts.get('tpu_rl_torch.flash_bwd')} ({b4 / total:.4f} of it) for {fwd}/{bwd} "
          f"launches [{card}]", flush=True)
    if fwd != cfg.n_layers * cfg.K_epoch or bwd != fwd or any(
            counts.get(k) != v for k, v in want.items()):
        fail(f"telemetry (d): B4 counted {counts}, want {want} for {fwd}/{bwd} launches")
    return dict(flops_per_update=total, b4_flops=b4, flash_fwd_launches=fwd,
                flash_bwd_launches=bwd)


def telemetry_phase(card: str) -> dict:
    """The telemetry and performance plane on the card: (a)-(d) above."""
    return dict(colocated=telemetry_colocated_check(card), wide=telemetry_wide_check(card),
                serving=telemetry_serving_check(card),
                transformer=telemetry_transformer_count(card))


# ------------------------------------------------ the off-policy slice
class DeviceSpecEnv:
    """A gymnasium-shaped env (``reset(seed=)``, ``step`` returning
    terminated and truncated, ``observation_space.shape``,
    ``action_space.n`` or ``.shape``) over one of the port's device env
    specs: one env on the CPU, truncated at gymnasium's horizon. It stands
    in for gymnasium where gymnasium is not installed (:func:`env_source`);
    the dynamics are the port's float32 copies of gymnasium's
    (``tpu_rl_torch/envs``)."""

    HORIZON = {"CartPole-v1": 500, "Pendulum-v1": 200}

    def __init__(self, name: str):
        from types import SimpleNamespace

        from tpu_rl_torch.envs import get_spec

        self.spec = get_spec(name)
        self.horizon = self.HORIZON[name]
        self.observation_space = SimpleNamespace(shape=self.spec.obs_shape)
        self.action_space = (SimpleNamespace(shape=(self.spec.action_space,))
                             if self.spec.is_continuous else SimpleNamespace(n=self.spec.action_space))
        self.generator = torch.Generator()
        self.state, self.t = None, 0

    def reset(self, seed: int | None = None):
        if seed is not None:
            self.generator.manual_seed(seed)
        self.state, obs = self.spec.reset(1, self.generator, torch.device("cpu"))
        self.t = 0
        return obs[0].numpy(), {}

    def step(self, action):
        a = torch.as_tensor(np.asarray(action, np.float32).reshape(1, 1))
        self.state, obs, rew, term = self.spec.step(self.state, a)
        self.t += 1
        return obs[0].numpy(), float(rew[0]), bool(term[0]), self.t >= self.horizon, {}

    def close(self) -> None:
        pass


def env_source() -> str:
    """Where the inline trainer's envs come from: gymnasium when it is
    installed; else a stand-in ``gymnasium`` module whose ``make`` builds a
    :class:`DeviceSpecEnv` (CartPole-v1 and Pendulum-v1)."""
    try:
        import gymnasium
    except ImportError:
        from types import ModuleType

        stand_in = ModuleType("gymnasium")
        stand_in.make = DeviceSpecEnv
        sys.modules["gymnasium"] = stand_in
        return "chip_smoke.DeviceSpecEnv over tpu_rl_torch/envs (gymnasium is not installed)"
    if "gym_stand_in" in (getattr(gymnasium, "__file__", None) or ""):
        # gym_stand_in()'s package, put on the path for the clusters' children
        return ("chip_smoke.DeviceSpecEnv over tpu_rl_torch/envs (gymnasium is not installed; "
                "gym_stand_in()'s package)")
    return f"gymnasium {gymnasium.__version__}"


def inline_run(run_kw: dict) -> dict:
    """``tpu_rl_torch.examples.train_inline.run(**run_kw)`` on the card, with
    the family's act timed (host clock around the act and the read back the
    trainer makes right after it) and every update's loss and skip count
    kept; B1/B2's counts are set to 0 just before the run and read just
    after."""
    import dataclasses
    from types import SimpleNamespace

    from tpu_rl_torch.examples import train_inline
    from tpu_rl_torch.ops import lstm as L

    rec = dict(act_s=[], losses=[], nonfinite=[])
    real_get = train_inline.get_algo

    def get_algo(name):
        spec = real_get(name)

        def build(cfg, generator, device):
            family, state, step = spec.build(cfg, generator, device=device)
            act = family.act

            def timed_act(*a, **kw):
                t0 = time.perf_counter()
                out = act(*a, **kw)
                torch.cuda.synchronize()  # the trainer reads the action back next
                rec["act_s"].append(time.perf_counter() - t0)
                return out

            def kept_step(state, batch, generator=None):
                state, metrics = step(state, batch, generator=generator)
                rec["losses"].append(metrics["loss"].detach())
                rec["nonfinite"].append(metrics["nonfinite-updates"].detach())
                return state, metrics

            rec["cfg"] = cfg
            return dataclasses.replace(family, act=timed_act), state, kept_step

        return SimpleNamespace(name=spec.name, make_train_step=spec.make_train_step, build=build)

    train_inline.get_algo = get_algo
    try:
        L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
        stats = train_inline.run(**run_kw, device="cuda")
        fwd, bwd = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
    finally:
        train_inline.get_algo = real_get
    losses = torch.stack(rec["losses"]).cpu()
    act_s = rec["act_s"][: stats["env_steps"]]  # the training steps' (the eval's follow)
    return dict(stats=stats, cfg=rec["cfg"], lstm_fwd_launches=fwd, lstm_bwd_launches=bwd,
                losses_finite=bool(torch.isfinite(losses).all()) and len(losses) == stats["updates"],
                nonfinite_updates=float(torch.stack(rec["nonfinite"]).sum()),
                act_ms_median=statistics.median(act_s) * 1e3,
                act_ms_mean=sum(act_s) / len(act_s) * 1e3,
                act_share_of_wallclock=sum(act_s) / max(stats["wallclock_s"], 1e-9))


def inline_step_profile(cfg, card: str) -> dict:
    """One train step of ``cfg`` (the inline run's algorithm and shape) on a
    seeded batch: host enqueue (median over INLINE_STEP_TIMED updates), the
    synchronized ms per update, and device time per update over a profiler
    window of INLINE_STEP_PROFILED updates with B1 + B2's share of it."""
    from tpu_rl_torch.algos.registry import get_algo

    _family, state, step = get_algo(cfg.algo).build(cfg, torch.Generator().manual_seed(0),
                                                    device="cuda")
    batch = lstm_batch(cfg, 0, continuous=cfg.is_continuous)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for _ in range(3):
        state, _m = step(state, batch, generator=gen)
    torch.cuda.synchronize()
    enqueue = []
    t0 = time.perf_counter()
    for _ in range(INLINE_STEP_TIMED):
        t1 = time.perf_counter()
        state, _m = step(state, batch, generator=gen)
        enqueue.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    ms_per_update = (time.perf_counter() - t0) / INLINE_STEP_TIMED * 1e3
    device_ms = share = kernels = None
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(INLINE_STEP_PROFILED):
                state, _m = step(state, batch, generator=gen)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in events)
        if device_us > 0:
            device_ms = device_us / 1e3 / INLINE_STEP_PROFILED
            share = sum(e.self_device_time_total for e in events
                        if "lstm_fwd_" in e.key or "lstm_bwd_" in e.key) / device_us
            kernels = sum(e.count for e in events) / INLINE_STEP_PROFILED
    except (RuntimeError, AttributeError) as e:
        print(f"inline step profile: not measured ({e!r})", flush=True)
    out = dict(enqueue_ms=statistics.median(enqueue) * 1e3, ms_per_update=ms_per_update,
               device_ms_per_update=device_ms, b1_b2_device_share=share,
               device_kernels_per_update=kernels)
    print(
        f"inline {cfg.algo} train step B={cfg.batch_size} S={cfg.seq_len} H={cfg.hidden_size}: "
        f"host enqueue {out['enqueue_ms']:.4f} ms (median of {INLINE_STEP_TIMED}), "
        f"{ms_per_update:.4f} ms/update synchronized; device "
        f"{'not measured' if device_ms is None else f'{device_ms:.4f}'} ms/update in "
        f"{'not measured' if kernels is None else f'{kernels:.1f}'} device kernels over "
        f"{INLINE_STEP_PROFILED} profiled updates, B1+B2 share "
        f"{'not measured' if share is None else f'{share:.4f}'} [{card}]",
        flush=True,
    )
    return out


def inline_sac_phase(card: str, lstm_rows: list[dict]) -> dict:
    """(a) SAC-Continuous learns from its replay through the port's inline
    trainer on the card: MountainCarContinuous-v0 with run_baselines.py's
    recipe and bar where gymnasium is installed, else Pendulum-v1 over the
    device dynamics with its bar; B1/B2 launches per update =
    LAUNCHES_PER_EPOCH x K_epoch; B1/B2's kernel time at the inline shape
    (32,5,64) beside its bound (lstm_phase's row); one train step's host vs
    device time; the act step's host time per env step. Then SAC on
    CartPole-v1 (INLINE_SAC): launches 8/3 per epoch, every loss finite."""
    from tpu_rl_torch.config import Config

    source = env_source()
    gym = source.startswith("gymnasium")
    cont = INLINE_CONT_GYM if gym else INLINE_CONT_DEVICE
    print(f"inline: env source {source}; {cont['algo']} on {cont['env_name']}, "
          f"{cont['updates']} updates at most, target {cont['target']} [{card}]", flush=True)
    runs = {}
    for tag, run_kw in (("continuous", cont), ("discrete", INLINE_SAC)):
        r = inline_run(run_kw)
        st, cfg = r["stats"], r["cfg"]
        want = tuple(n * cfg.K_epoch for n in LAUNCHES_PER_EPOCH[cfg.algo])
        per_update = (r["lstm_fwd_launches"] / st["updates"], r["lstm_bwd_launches"] / st["updates"])
        checks = {
            "launches": per_update == want,
            "losses_finite": r["losses_finite"],
            "no_skipped_update": r["nonfinite_updates"] == 0.0,
        }
        if tag == "continuous":
            checks["reached_target"] = st["reached_target"] is True
            if gym:
                checks["greedy"] = (st["greedy_eval_mean_20"] is not None
                                    and st["greedy_eval_mean_20"] >= INLINE_GREEDY_BAR)
        else:
            checks["updates"] = st["updates"] == run_kw["updates"]
        print(
            f"inline {cfg.algo} on {cfg.env} (seed {st['seed']}): updates {st['updates']} env "
            f"steps {st['env_steps']} wallclock {st['wallclock_s']} s env_steps_per_s "
            f"{st['env_steps_per_s']} reached_target {st['reached_target']} (target "
            f"{st['target']}) time_to_target {st['time_to_target_s']} s final_mean_50 "
            f"{st['final_mean_50']:.4f} best_episode {st['best_epi_rew']} greedy_eval_mean_20 "
            f"{st['greedy_eval_mean_20']}; lstm launches {r['lstm_fwd_launches']}/"
            f"{r['lstm_bwd_launches']} = {per_update[0]}/{per_update[1]} per update (want "
            f"{want[0]}/{want[1]}); act step {r['act_ms_median']:.4f} ms median, "
            f"{r['act_ms_mean']:.4f} ms mean per env step (host clock, read back included), "
            f"{r['act_share_of_wallclock']:.4f} of the wallclock [{card}]",
            flush=True,
        )
        print(f"inline {cfg.algo} checks {checks}", flush=True)
        if not all(checks.values()):
            fail(f"inline {cfg.algo}: failed checks {[k for k, v in checks.items() if not v]}")
        runs[tag] = dict({k: v for k, v in r.items() if k != "cfg"}, checks=checks)
        if tag == "continuous":
            step_cfg = cfg
    step = inline_step_profile(Config.from_dict(dict(
        algo=step_cfg.algo, obs_shape=step_cfg.obs_shape, action_space=step_cfg.action_space,
        is_continuous=True, batch_size=step_cfg.batch_size, seq_len=step_cfg.seq_len,
        hidden_size=step_cfg.hidden_size, lr=step_cfg.lr)), card)
    row = next(x for x in lstm_rows if x["shape"] == dict(B=32, S=5, H=64))
    for name in ("lstm_fwd", "lstm_bwd"):
        print(f"inline {name} at (32,5,64): {row[name]['ms']:.6f} ms vs bound "
              f"{row[name]['bound_ms']:.6f} ms ({row[name]['bound_by']}), plain "
              f"{row[name]['plain_ms']:.6f} ms [{card}]", flush=True)
    return dict(env_source=source, runs=runs, step=step,
                lstm_fwd_launches=runs["continuous"]["lstm_fwd_launches"],
                lstm_bwd_launches=runs["continuous"]["lstm_bwd_launches"],
                kernel_ms={n: row[n]["ms"] for n in ("lstm_fwd", "lstm_bwd")},
                bound_ms={n: row[n]["bound_ms"] for n in ("lstm_fwd", "lstm_bwd")})


def seeded_window(layout, rng, n_actions: int) -> dict:
    """One seeded trajectory window: obs and carries N(0, 1) and N(0,
    0.25), action indices below ``n_actions``, log-softmax logits and the
    action's log-prob, small rewards, an episode start at step 0 with
    probability 1/4."""
    from tpu_rl_torch.types import BATCH_FIELDS

    S = layout.seq_len
    w = {f: np.empty((S, layout.width(f)), np.float32) for f in BATCH_FIELDS}
    w["obs"][:] = rng.normal(size=w["obs"].shape)
    w["act"][:] = rng.integers(0, n_actions, size=w["act"].shape)
    logits = rng.normal(size=w["logits"].shape)
    w["logits"][:] = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    w["log_prob"][:] = np.take_along_axis(w["logits"], w["act"].astype(np.int64), -1)
    w["rew"][:] = 0.1 * rng.normal(size=w["rew"].shape)
    w["is_fir"][:] = 0.0
    w["is_fir"][0] = float(rng.random() < 0.25)
    w["hx"][:] = 0.5 * rng.normal(size=w["hx"].shape)
    w["cx"][:] = 0.5 * rng.normal(size=w["cx"].shape)
    return w


def feed_writer(handles, cfg_kw: dict, n_windows: int, pool: int, seed: int, stop) -> None:
    """The storage side, in a spawn child: ``pool`` seeded windows written in
    order, window i = pool[i % pool], ``n_windows`` in all, through the
    port's store over the parent's handles (put_many bursts of one batch;
    an on-policy store takes them as the learner consumes)."""
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.data import BatchLayout, make_store

    cfg = Config(**cfg_kw)
    layout = BatchLayout.from_config(cfg)
    store = make_store(cfg, layout, handles)
    rng = np.random.default_rng(seed)
    windows = [seeded_window(layout, rng, cfg.action_space) for _ in range(pool)]
    i = 0
    while i < n_windows and not stop.is_set():
        k = min(cfg.batch_size, n_windows - i)
        n = store.put_many([windows[(i + j) % pool] for j in range(k)], list(range(i, i + k)))
        i += n
        if n == 0:
            time.sleep(0.0002)


def start_writer(cfg, n_windows: int, pool: int, seed: int):
    """A fresh store for ``cfg`` and a spawn child writing into it."""
    import dataclasses
    import multiprocessing as mp

    from tpu_rl_torch.data import BatchLayout, make_store
    from tpu_rl_torch.data.shm_ring import alloc_handles

    ctx = mp.get_context("spawn")
    layout = BatchLayout.from_config(cfg)
    off = cfg.algo.startswith("SAC")
    handles = alloc_handles(layout, cfg.buffer_size if off else cfg.batch_size, ctx=ctx)
    stop = ctx.Event()
    cfg_kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "extra"}
    child = ctx.Process(target=feed_writer, args=(handles, cfg_kw, n_windows, pool, seed, stop),
                        daemon=True)
    child.start()
    return make_store(cfg, layout, handles), child, stop


def stop_writer(child, stop) -> None:
    stop.set()
    child.join(60)
    if child.is_alive():
        child.terminate()
        child.join(10)


def feed_run(cfg, store, kind: str, updates: int) -> dict:
    """``updates`` train steps of ``cfg.algo`` on the card from one initial
    state (seed 0) and train generator, fed by ``kind`` ("sync":
    SynchronousFeed, "prefetch": PrefetchPipeline at PREFETCH_DEPTH) with
    device_batch through pinned staging on a side stream; the sampler's
    generator is seeded the same way each run. After each step a copy of
    the batch is made on the consumer's stream (so the batch itself is
    dropped while the step may still read it); every raw batch the feed
    fetched is kept on the host."""
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.config import is_off_policy
    from tpu_rl_torch.data import PrefetchPipeline, SynchronousFeed
    from tpu_rl_torch.data.prefetch import DeviceStager, device_batch, wait_ready
    from tpu_rl_torch.ops import lstm as L
    from tpu_rl_torch.types import BATCH_FIELDS

    _family, state, step = get_algo(cfg.algo).build(cfg, torch.Generator().manual_seed(0),
                                                    device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rng = np.random.default_rng(7)
    raws = []

    def fetch():
        raw = store.sample(cfg.batch_size, rng) if is_off_policy(cfg.algo) else store.consume()
        if raw is not None:
            raws.append(raw)
        return raw

    stager = DeviceStager("cuda", slots=PREFETCH_DEPTH + 1)

    def assemble(r):
        return device_batch(r, "cuda", stager)

    feed = (SynchronousFeed(fetch, assemble) if kind == "sync"
            else PrefetchPipeline(fetch, assemble, depth=PREFETCH_DEPTH))
    kept, feed_secs = [], []
    torch.cuda.synchronize()
    L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    deadline = time.time() + 300
    while len(kept) < updates:
        if time.time() > deadline:
            feed.close()
            fail(f"feed {kind} {cfg.algo}: {len(kept)} of {updates} batches in 300 s")
        item = feed.get(timeout=0.05)
        if item is None:
            time.sleep(feed.poll_sleep)
            continue
        batch = wait_ready(item[0])
        state, _metrics = step(state, batch, generator=gen)
        kept.append({f: getattr(batch, f).clone() for f in BATCH_FIELDS})
        feed_secs.append(item[1])
        del batch, item
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fwd, bwd = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
    feed.close()
    equal = all(
        torch.equal(k[f].cpu(), torch.from_numpy(raw[f]))
        for k, raw in zip(kept, raws, strict=False) for f in BATCH_FIELDS
    ) and len(raws) >= updates
    want = tuple(updates * cfg.K_epoch * n for n in LAUNCHES_PER_EPOCH[cfg.algo])
    return dict(state=state, raw=raws[0], ms_per_update=dt / updates * 1e3, batches_equal=equal,
                lstm_fwd_launches=fwd, lstm_bwd_launches=bwd, launches_ok=(fwd, bwd) == want,
                feed_ms_median=statistics.median(feed_secs) * 1e3, h2d_bytes=stager.h2d_bytes)


def h2d_ms(raw: dict) -> dict:
    """One raw batch's host copy into pinned buffers (host clock) and its
    host-to-device copy (CUDA events on a side stream), medians of 5."""
    from tpu_rl_torch.types import BATCH_FIELDS

    pinned = {f: torch.empty(raw[f].shape, pin_memory=True) for f in BATCH_FIELDS}
    stream = torch.cuda.Stream()
    host, dev = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        for f in BATCH_FIELDS:
            np.copyto(pinned[f].numpy(), raw[f])
        host.append((time.perf_counter() - t0) * 1e3)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record()
            _out = [pinned[f].to("cuda", non_blocking=True) for f in BATCH_FIELDS]
            end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end))
    nbytes = sum(raw[f].nbytes for f in BATCH_FIELDS)
    return dict(bytes=nbytes, host_copy_ms=statistics.median(host), h2d_ms=statistics.median(dev),
                h2d_gb_per_s=nbytes / (statistics.median(dev) * 1e-3) / 1e9)


def states_equal(a, b) -> bool:
    """Two train states (TrainState or SACState) equal bit for bit."""
    import dataclasses

    from tpu_rl_torch.utils.tree import tree_leaves

    for f in dataclasses.fields(a):
        la, lb = tree_leaves(getattr(a, f.name)), tree_leaves(getattr(b, f.name))
        if len(la) != len(lb) or not all(torch.equal(x, y) for x, y in zip(la, lb, strict=True)):
            return False
    return True


def replay_feed_phase(card: str) -> dict:
    """(b) The data plane onto the card. A ReplayStore at the reference's
    capacity (REPLAY_FEED_CFG: 10240 windows at SAC@ref's 128 x 5, H 64, obs
    4) filled by a spawn child with seeded windows; REPLAY_FEED_UPDATES SAC
    train steps through SynchronousFeed and through PrefetchPipeline from one
    state, sampler seed and train generator: every batch on the card equals
    its numpy sample bit for bit, and the final states are equal bit for
    bit. Then the same on an OnPolicyStore at IMPALA@wide-lstm's shape
    (WIDE_FEED_CFG, a fresh writer per run): ms/update sync vs prefetch and
    the host-to-device time of one batch, with no bar."""
    from tpu_rl_torch.config import Config

    out = {}
    for tag, cfg, updates, pool in (
        ("replay SAC@ref", Config.from_dict(REPLAY_FEED_CFG), REPLAY_FEED_UPDATES, None),
        ("on-policy IMPALA@wide-lstm", Config.from_dict(WIDE_FEED_CFG), WIDE_FEED_UPDATES,
         WIDE_FEED_POOL),
    ):
        off = pool is None
        runs = {}
        if off:  # one ring, filled once, sampled by both runs
            store, child, stop = start_writer(cfg, cfg.buffer_size, cfg.buffer_size, 0)
            deadline = time.time() + 120
            while store.total_puts < cfg.buffer_size and time.time() < deadline:
                time.sleep(0.05)
            if store.total_puts < cfg.buffer_size:
                fail(f"feed {tag}: the writer filled {store.total_puts} of {cfg.buffer_size}")
        for kind in ("sync", "prefetch"):
            if not off:  # a fresh store and writer: both runs consume the same windows
                store, child, stop = start_writer(cfg, updates * cfg.batch_size, pool, 0)
                deadline = time.time() + 120  # the child's start is no part of the run
                while store.size < cfg.batch_size and time.time() < deadline:
                    time.sleep(0.01)
            runs[kind] = feed_run(cfg, store, kind, updates)
            if not off:
                stop_writer(child, stop)
        if off:
            stop_writer(child, stop)
        h2d = h2d_ms(runs["sync"]["raw"])
        equal_states = states_equal(runs["sync"]["state"], runs["prefetch"]["state"])
        checks = {"batches_equal_sync": runs["sync"]["batches_equal"],
                  "batches_equal_prefetch": runs["prefetch"]["batches_equal"],
                  "final_state_equal": equal_states,
                  "launches": runs["sync"]["launches_ok"] and runs["prefetch"]["launches_ok"]}
        print(
            f"feed {tag} B={cfg.batch_size} S={cfg.seq_len} H={cfg.hidden_size} capacity "
            f"{cfg.buffer_size if off else cfg.batch_size}, {updates} updates: ms/update sync "
            f"{runs['sync']['ms_per_update']:.4f} prefetch(depth {PREFETCH_DEPTH}) "
            f"{runs['prefetch']['ms_per_update']:.4f}; feed ms a batch (fetch + staging, median) "
            f"sync {runs['sync']['feed_ms_median']:.4f} prefetch "
            f"{runs['prefetch']['feed_ms_median']:.4f}; a batch {h2d['bytes']} bytes: host copy "
            f"into pinned {h2d['host_copy_ms']:.4f} ms, H2D {h2d['h2d_ms']:.4f} ms "
            f"({h2d['h2d_gb_per_s']:.2f} GB/s); lstm launches sync "
            f"{runs['sync']['lstm_fwd_launches']}/{runs['sync']['lstm_bwd_launches']} prefetch "
            f"{runs['prefetch']['lstm_fwd_launches']}/{runs['prefetch']['lstm_bwd_launches']} "
            f"[{card}]",
            flush=True,
        )
        print(f"feed {tag} checks {checks}", flush=True)
        if not all(checks.values()):
            fail(f"feed {tag}: failed checks {[k for k, v in checks.items() if not v]}")
        out[tag] = dict(updates=updates, h2d=h2d, checks=checks,
                        **{k: {m: v for m, v in r.items() if m not in ("state", "raw")}
                           for k, r in runs.items()})
    return out


def report_compare_check(result_dir: str, card: str) -> dict:
    """(c) The port's ``obs.report.main`` over the result dir of the
    telemetry phase's colocated run, and ``obs.compare.main`` comparing the
    run with itself: both exit 0 and the comparison reports no regression."""
    import shutil

    from tpu_rl_torch.obs import compare, report

    try:
        rc_report = report.main([result_dir])
        doc_path = os.path.join(result_dir, "compare.json")
        rc_compare = compare.main([result_dir, result_dir, "--json", doc_path])
        doc = json.loads(open(doc_path).read())
        files = sorted(os.listdir(result_dir))
    finally:
        shutil.rmtree(result_dir, ignore_errors=True)
    checks = {
        "report_exit_0": rc_report == 0,
        "report_files": {"report.json", "report.md", "report.html"} <= set(files),
        "compare_exit_0": rc_compare == 0,
        "no_regression": doc["ok"] is True and not any(
            doc["counts"].get(v) for v in ("regressed", "no-data")),
    }
    print(f"report/compare over the telemetry run: report exit {rc_report}, compare exit "
          f"{rc_compare}, verdicts {doc['counts']}, {len(doc['rows'])} channels [{card}]",
          flush=True)
    print(f"report/compare checks {checks}", flush=True)
    if not all(checks.values()):
        fail(f"report/compare: failed checks {[k for k, v in checks.items() if not v]}")
    return dict(counts=doc["counts"], channels=len(doc["rows"]), checks=checks)



# ------------------------------------------------- the distributed runtime
# tpu_rl's default config (PPO, CartPole-v1, H 64, seq_len 5, batch 128; one
# worker machine of 2 processes, worker_num_envs 1) with the worker throttle
# off, run (a) with local acting over TCP and the raw relay, run (b) with
# every act step served by the learner's InferenceService through B3 and
# the manager -> storage hop over shm. inference_timeout_ms 60000 is tpu_rl's
# own remote-acting test recipe: a worker's first request must not time out
# into local acting while the learner starts.
CLUSTER_UPDATES = 20  # cut from 50 for the time limit (PERF.md §4)
CLUSTER_PROFILE = (5, 5)  # profile_start, profile_steps (updates)
CLUSTER_RUNS = (
    ("a", dict(act_mode="local", transport="tcp", relay_mode="raw")),
    ("b", dict(act_mode="remote", act_kernel="pallas", transport="auto",
               inference_timeout_ms=60000)),
)
# Depth cut to keep the smoke inside its time limit (PERF.md §4): run (b),
# the slowest (0.3-0.7 updates/s), to 12 updates (from 30); the
# fleet's run (d) 30. The profiler window ends at 10. Runs (a) and (c)
# take CLUSTER_UPDATES.
CLUSTER_UPDATES_BY_RUN = {"b": 12, "d": 30}
CLUSTER_TIMEOUT_S = 300.0


def gym_stand_in() -> str:
    """Where the cluster's worker processes get their envs. Where gymnasium
    is not installed, write a stand-in ``gymnasium`` package whose ``make``
    is :class:`DeviceSpecEnv` into the git-ignored ``.chip_scratch/`` and put
    it first on ``PYTHONPATH`` and on this process's ``sys.path`` (spawned
    children take their ``sys.path`` from this process)."""
    mod = sys.modules.get("gymnasium")
    if mod is not None and getattr(mod, "__file__", None) and "gym_stand_in" not in mod.__file__:
        return f"gymnasium {mod.__version__}"
    if mod is None:
        try:
            import gymnasium

            return f"gymnasium {gymnasium.__version__}"
        except ImportError:
            pass
    root = ROOT / ".chip_scratch" / "gym_stand_in"
    pkg = root / "gymnasium"
    pkg.mkdir(parents=True, exist_ok=True)
    (pkg / "__init__.py").write_text(
        '"""A gymnasium stand-in for machines without gymnasium: make() builds\n'
        'chip_smoke.DeviceSpecEnv over the port\'s device env dynamics."""\n'
        "from chip_smoke import DeviceSpecEnv as make  # noqa: F401\n"
        '__version__ = "stand-in"\n'
    )
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(root), str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    sys.modules.pop("gymnasium", None)
    return "stand-in gymnasium package (chip_smoke.DeviceSpecEnv over tpu_rl_torch/envs) in every process"


# [base, base + n) of every block handed out in this run: phases on two
# threads bind their blocks' ports later (a replica the autopilot spawns
# minutes on), so no later block may overlap an earlier one
_BLOCKS: list[tuple[int, int]] = []
_BLOCKS_LOCK = threading.Lock()


def free_block(n: int = 8) -> int:
    """A base port whose ``n`` ports are all free to bind and overlap no
    block this run has already handed out."""
    with _BLOCKS_LOCK:
        base = _free_block(n)
        _BLOCKS.append((base, base + n))
        return base


def _free_block(n: int) -> int:
    import socket

    for _ in range(200):
        base = free_port()
        if base + n >= 65535 or any(base < hi and lo < base + n for lo, hi in _BLOCKS):
            continue
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("0.0.0.0", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    fail("no free block of ports")


def cuda_pids() -> list[int] | None:
    """PIDs holding a CUDA context on the card, as nvidia-smi reports them
    (None when nvidia-smi lists no process at all). In a container they may
    read as another namespace's PIDs; their count still counts contexts."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout
    pids = [int(x) for x in out.split() if x.strip().isdigit()]
    return pids or None


def card_fds(pid: int) -> list[str]:
    """The card device nodes (``/dev/nvidia<N>``) process ``pid`` holds open:
    a process opens its card's node when it makes a context there."""
    import re

    out = []
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if re.fullmatch(r"/dev/nvidia\d+", target):
                out.append(target)
    except OSError:
        pass
    return sorted(set(out))


def telemetry_sources(result_dir: Path) -> list[dict]:
    path = result_dir / "telemetry.json"
    try:
        return json.loads(path.read_text())["sources"]
    except (OSError, ValueError, KeyError):
        return []


def metric(snap: dict, name: str, kind: str = "counters"):
    for n, _labels, value in snap.get(kind, ()):
        if n == name:
            return value
    return None


def trace_kernels(prof_dir: Path) -> dict:
    """Device time of the learner's profiler window, by kernel family."""
    traces = sorted(prof_dir.glob("prof-window-*/trace.json"))
    if len(traces) != 1:
        return {}
    doc = json.loads(traces[0].read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    out = {"all_us": 0.0, "b3_us": 0.0, "b1_b2_us": 0.0, "kernels": 0}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        out["all_us"] += float(e.get("dur", 0.0))
        out["kernels"] += 1
        name = e.get("name", "")
        if "fused_act" in name:
            out["b3_us"] += float(e.get("dur", 0.0))
        elif "lstm_fwd" in name or "lstm_bwd" in name:
            out["b1_b2_us"] += float(e.get("dur", 0.0))
    return out


def cluster_run(tag: str, over: dict, card: str, ranks: int = 1) -> dict:
    """One ``local_cluster`` run to CLUSTER_UPDATES updates (runs (b), (d):
    CLUSTER_UPDATES_BY_RUN); telemetry.json
    (storage's aggregate of every role's snapshots, every second) is read
    while it runs and after. With ``ranks`` > 1 the learner is that many
    data-parallel ranks (``mesh_data``) sharing the card; each rank's
    launches come in the learner's closing snapshot. With
    ``inference_replicas`` N > 1 in ``over`` the fleet's replicas 1..N-1
    are children holding the card beside the learner (replica 0)."""
    import shutil

    from tpu_rl_torch.config import Config, MachinesConfig, WorkerMachine
    from tpu_rl_torch.runtime.env import probe_spaces
    from tpu_rl_torch.runtime.runner import local_cluster

    rdir = ROOT / ".chip_scratch" / f"cluster-{tag}"
    shutil.rmtree(rdir, ignore_errors=True)
    start, steps = CLUSTER_PROFILE
    cfg = probe_spaces(Config.from_dict(dict(
        worker_step_sleep=0.0, result_dir=str(rdir), profile_dir=str(rdir / "prof"),
        profile_start=start, profile_steps=steps, telemetry_interval_s=1.0, **over,
    )))
    base = free_block()
    machines = MachinesConfig(learner_port=base, workers=[WorkerMachine(num_p=2, port=base + 5)])
    samples: list[tuple[float, float, float]] = []  # (ts, update index, windows)
    ctx_checks: list[dict] = []
    done = threading.Event()
    t0 = time.perf_counter()
    n_updates = CLUSTER_UPDATES_BY_RUN.get(tag, CLUSTER_UPDATES)
    replicas = int(over.get("inference_replicas", 1))
    sup = local_cluster(cfg, machines, max_updates=n_updates)
    children = {c.name: c for c in sup.children}

    learner = children["learner"]
    # the children that hold the card: the learner's ranks and the replicas
    holders = [p for n in ["learner"] + [f"inference-{i}" for i in range(1, replicas)]
               for p in getattr(children[n].proc, "procs", [children[n].proc])]
    # A fleet's hold (FLEET_HOLD): inference-1 stopped, so that the learner's
    # replica 0 serves the workers, then resumed.
    victim = children["inference-1"].proc if replicas > 1 else None
    hold: dict = {}

    def hold_step(lrn: dict, sto: dict) -> None:
        idx = metric(lrn, "learner-update-index", "gauges") or 0
        r0 = metric(lrn, "inference-batches") or 0
        if "stopped_at" not in hold and idx >= FLEET_HOLD["at_update"]:
            os.kill(victim.pid, signal.SIGSTOP)
            hold.update(stopped_at=time.monotonic(), ts=float(sto["ts"]), at_update=idx,
                        r0_flushes_before=r0)
        elif "stopped_at" in hold and "resumed_after_s" not in hold and (
                r0 - hold["r0_flushes_before"] >= FLEET_HOLD["flushes"]
                or time.monotonic() - hold["stopped_at"] >= FLEET_HOLD["max_s"]):
            os.kill(victim.pid, signal.SIGCONT)
            hold.update(resumed_after_s=time.monotonic() - hold["stopped_at"],
                        r0_flushes_seen=r0 - hold["r0_flushes_before"])

    def watch() -> None:
        while not done.wait(0.25):
            srcs = telemetry_sources(rdir)
            lrn = next((s for s in srcs if s.get("role") == "learner"), None)
            sto = next((s for s in srcs if s.get("role") == "storage"), None)
            if sto is None:
                continue
            windows = float(metric(sto, "storage-windows") or 0)
            if lrn is not None:
                idx = float(metric(lrn, "learner-update-index", "gauges") or 0.0)
                samples.append((float(sto["ts"]), idx, windows))
                if victim is not None:
                    hold_step(lrn, sto)
            # mid-run: windows flow (the workers are up), every process that
            # should hold the card has opened its node (made its context),
            # and the learner is alive before and after the sample (a short
            # run may end between two telemetry writes)
            if (windows >= 1 and len(ctx_checks) < 3 and learner.proc.is_alive()
                    and all(card_fds(p.pid) for p in holders)):
                check = {"pids": cuda_pids(),
                         "children": {n: c.proc.pid for n, c in children.items()},
                         "fds": {n: card_fds(c.proc.pid) for n, c in children.items()}}
                if learner.proc.is_alive():
                    ctx_checks.append(check)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        deadline = time.monotonic() + CLUSTER_TIMEOUT_S
        while learner.proc.is_alive() and time.monotonic() < deadline:
            time.sleep(0.25)
        wall = time.perf_counter() - t0
        exitcode = learner.proc.exitcode
        # storage writes telemetry.json every second: wait for the learner's
        # closing snapshot (sent after its service and feed stopped)
        until = time.monotonic() + 20.0
        while exitcode == 0 and time.monotonic() < until and not any(
            s.get("role") == "learner" and s.get("closing") for s in telemetry_sources(rdir)
        ):
            time.sleep(0.25)
    finally:
        done.set()
        watcher.join(5)
        if "stopped_at" in hold and "resumed_after_s" not in hold:
            os.kill(victim.pid, signal.SIGCONT)  # a stopped child would not take SIGTERM
        sup.stop()
    if exitcode != 0:
        fail(f"cluster ({tag}): the learner exited {exitcode} (alive: {learner.proc.is_alive()})")
    if victim is not None and "resumed_after_s" not in hold:
        fail(f"cluster ({tag}): inference-1 was never stopped and resumed: {hold}")
    srcs = telemetry_sources(rdir)
    lrn = next((s for s in srcs if s.get("role") == "learner" and s.get("closing")), None)
    sto = next((s for s in srcs if s.get("role") == "storage"), None)
    mgr = next((s for s in srcs if s.get("role") == "manager"), None)
    workers = [s for s in srcs if s.get("role") == "worker"]
    if lrn is None or sto is None or mgr is None or len(workers) != 2:
        fail(f"cluster ({tag}): telemetry.json lacks a role: {[s.get('role') for s in srcs]}")
    updates = int(metric(lrn, "learner-update-index", "gauges"))
    fwd = int(metric(lrn, "learner-lstm-fwd-launches"))
    bwd = int(metric(lrn, "learner-lstm-bwd-launches"))
    k = cfg.K_epoch
    if updates != n_updates:
        fail(f"cluster ({tag}): {updates} updates, expected {n_updates}")
    if (fwd, bwd) != (updates * k, updates * k):
        fail(f"cluster ({tag}): B1/B2 launches {fwd}/{bwd}, expected updates x K_epoch = {updates * k}")
    per_rank = None
    if ranks > 1:
        per_rank = [(metric(lrn, f"learner-lstm-fwd-launches-rank{r}"),
                     metric(lrn, f"learner-lstm-bwd-launches-rank{r}"),
                     metric(lrn, f"learner-updates-run-rank{r}")) for r in range(ranks)]
        if any(tuple(x) != (updates * k, updates * k, updates) for x in per_rank):
            fail(f"cluster ({tag}): per-rank (B1, B2, updates) {per_rank}, expected "
                 f"({updates * k}, {updates * k}, {updates}) on every rank")
        if metric(lrn, "mesh-world", "gauges") != ranks:
            fail(f"cluster ({tag}): mesh-world {metric(lrn, 'mesh-world', 'gauges')}")
    rejected = {
        "storage": metric(sto, "storage-rejected-frames"),
        "manager": metric(mgr, "manager-rejected-frames"),
        "workers": sum(metric(w, "worker-rejected-frames") or 0 for w in workers),
        "learner mailbox (fleet total)": metric(lrn, "transport-rejected-frames"),
    }
    dropped = {
        "manager drop-oldest": metric(mgr, "manager-dropped-frames"),
        "shm ring full": metric(mgr, "shm-dropped-full"),
        "shm no consumer yet": metric(mgr, "shm-dropped-no-peer"),
        "storage stale epoch": metric(sto, "storage-stale-epoch-frames"),
    }
    if any(v for v in rejected.values()):
        fail(f"cluster ({tag}): frames rejected {rejected}")
    out = dict(tag=tag, config=over, updates=updates, K_epoch=k, learner_exit=exitcode,
               wall_s=wall, lstm_fwd_launches=fwd, lstm_bwd_launches=bwd,
               launches_by_rank=per_rank, mesh_staged_bytes=metric(lrn, "mesh-staged-bytes"),
               scattered_bytes=metric(lrn, "learner-scattered-bytes"),
               frames_rejected=rejected, frames_dropped=dropped,
               forwarded_frames=metric(mgr, "manager-forwarded-frames"),
               windows=metric(sto, "storage-windows"))
    # rates over the run's samples once updates flow (storage's clock), up
    # to a fleet's hold (its failover stall is not the fleet's rate)
    live = [s for s in samples if s[1] >= 1 and s[0] <= hold.get("ts", float("inf"))]
    if len(live) >= 2 and live[-1][0] > live[0][0]:
        dt = live[-1][0] - live[0][0]
        out["updates_per_s"] = (live[-1][1] - live[0][1]) / dt
        out["env_steps_ingested_per_s"] = (live[-1][2] - live[0][2]) * cfg.seq_len / dt
    else:
        out["updates_per_s"] = out["env_steps_ingested_per_s"] = None
    # host enqueue: the learner's own "train-step" spans (trace.json; the
    # dispatch's host clock, no sync), median past the first 5 (the first
    # counts FLOPs and meets every kernel's first launch)
    spans = [e["dur"] for e in json.loads((rdir / "trace.json").read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("name") == "train-step"]
    if len(spans) < 10:
        fail(f"cluster ({tag}): the learner's trace holds {len(spans)} train-step spans")
    out["host_enqueue_ms_per_update"] = statistics.median(spans[5:]) / 1e3
    out["host_enqueue_ms_first_update"] = spans[0] / 1e3
    kern = trace_kernels(rdir / "prof")
    if not kern:
        fail(f"cluster ({tag}): the learner wrote no single profiler window under {rdir / 'prof'}")
    out["device_ms_per_update"] = kern["all_us"] / 1e3 / steps
    out["b1_b2_device_ms_per_update"] = kern["b1_b2_us"] / 1e3 / steps
    out["b3_device_ms_per_update"] = kern["b3_us"] / 1e3 / steps
    out["device_kernels_per_update"] = kern["kernels"] / steps
    # only the learner (and the fleet's replica children) hold a CUDA
    # context: nvidia-smi counts this process, the learner's ranks and the
    # replicas, and of the children only those hold the card's device node
    card_children = ["learner"] + [f"inference-{i}" for i in range(1, replicas)]
    if not ctx_checks:
        fail(f"cluster ({tag}): no mid-run sample of the CUDA contexts")
    for check in ctx_checks:
        n_ctx = len(check["pids"] or [])
        if n_ctx != ranks + replicas:
            fail(f"cluster ({tag}): nvidia-smi lists {n_ctx} compute processes mid-run, "
                 f"expected {ranks + replicas} (this process, the learner's ranks and "
                 f"{replicas - 1} replica children): {check}")
        holders = sorted(n for n, fds in check["fds"].items() if fds)
        if holders != sorted(card_children):
            fail(f"cluster ({tag}): children holding the card: {holders}, expected {card_children}")
    out["cuda_contexts"] = len(ctx_checks[0]["pids"])
    out["card_nodes_by_child"] = ctx_checks[0]["fds"]
    if over["act_mode"] == "remote":
        b3 = int(metric(lrn, "inference-fused-act-launches"))
        warm = int(metric(lrn, "inference-warmups"))
        flushes = int(metric(lrn, "inference-batches"))
        fallbacks = sum(metric(w, "worker-remote-fallbacks") or 0 for w in workers)
        if b3 != warm + flushes or flushes == 0:
            fail(f"cluster ({tag}): B3 launches {b3}, expected warm-ups {warm} + flushes {flushes}")
        if fallbacks != 0:
            fail(f"cluster ({tag}): {fallbacks} remote-acting fallbacks (local acting would hide B3)")
        out.update(fused_act_launches=b3, inference_warmups=warm, inference_flushes=flushes,
                   worker_remote_fallbacks=fallbacks,
                   inference_requests=metric(lrn, "inference-requests"),
                   inference_replies=metric(lrn, "inference-replies"))
    if replicas > 1:
        out["fleet"] = fleet_checks(tag, srcs, lrn, sto, workers, replicas, hold)
    print(
        f"cluster ({tag}) {over}: learner exit {exitcode}, {updates} updates in {wall:.1f} s "
        f"(from spawn), updates/s {out['updates_per_s']}, env steps ingested/s "
        f"{out['env_steps_ingested_per_s']}, host enqueue {out['host_enqueue_ms_per_update']:.4f} ms "
        f"vs device {out['device_ms_per_update']:.4f} ms an update (B1+B2 "
        f"{out['b1_b2_device_ms_per_update']:.4f}, B3 {out['b3_device_ms_per_update']:.4f}; "
        f"profiler over {steps} updates), B1/B2 launches {fwd}/{bwd} = updates x K_epoch, "
        f"rejected {rejected}, dropped {dropped}"
        + (f", B3 launches {out['fused_act_launches']} = warm-ups {out['inference_warmups']} + "
           f"flushes {out['inference_flushes']}, fallbacks {out['worker_remote_fallbacks']}"
           if over["act_mode"] == "remote" else "")
        + f", {out['cuda_contexts']} CUDA contexts (this process, the learner"
        + (f" and {replicas - 1} replica children" if replicas > 1 else "")
        + f"), card nodes by child {out['card_nodes_by_child']}"
        + (f"; fleet {out['fleet']}" if replicas > 1 else "") + f" [{card}]",
        flush=True,
    )
    return out


def cluster_phase(card: str) -> dict:
    """The distributed runtime on the card: ``local_cluster`` twice (see
    CLUSTER_RUNS); the children's envs from :func:`gym_stand_in`."""
    return {tag: cluster_run(tag, over, card) for tag, over in CLUSTER_RUNS}


# ------------------------------------------------------ the inference fleet
# (F1) cluster run (d): run (b)'s config with a fleet of two replicas (the
# learner's service is replica 0, one inference-1 child), no hedge timer.
# Left alone, the workers' FleetClients send every act to inference-1 (the
# lower RTT) and replica 0 serves almost nothing, so inference-1 is held
# (SIGSTOP) from update at_update until the learner's replica 0 has served
# `flushes` flushes in its place, at most max_s, then resumed (SIGCONT).
# A request in flight to the stopped replica fails over at the request
# timeout: 20 s here (run (b)'s 60 s is tpu_rl's recipe for one service;
# with two lanes a worker's first requests still have minutes before a
# fallback), so the stall costs 20 s, not 60.
# (F2) tpu_rl's loadgen smoke (tpu_rl_torch/examples/loadgen_smoke.py:
# 12000 clients from 2 driver processes, 100/250/600 rps, 6 s a stage, a
# SIGKILL of the busier replica at 8 s, tpu_rl's bars), then a sweep without a kill
# and without bars: the two-replica fleet's saturation curve on this card.
# (F3) the sharded replica (inference_mesh_data=2) at the serving config.
FLEET_RUN = ("d", dict(CLUSTER_RUNS[1][1], inference_replicas=2, inference_hedge_ms=0,
                      inference_timeout_ms=20000))
FLEET_HOLD = dict(at_update=12, flushes=200, max_s=60.0)
FLEET_SWEEP = dict(clients=12_000, rates=(100.0, 250.0, 600.0), duration=6.0, kill_at=8.0)
# (the saturation curve has no bar: its stages cut from 6 s to 3 s, then 2 s,
# and its 4800 rps stage, past saturation, dropped, for the time limit,
# PERF.md §4)
FLEET_CURVE = dict(clients=12_000, rates=(600.0, 1200.0, 2400.0), duration=2.0,
                   kill_at=None)
SHARDED_ACTS, SHARDED_CLIENTS, SHARDED_ENVS = 20, 4, 4


def fleet_checks(tag: str, srcs: list[dict], lrn: dict, sto: dict, workers: list[dict],
                 replicas: int, hold: dict) -> dict:
    """A fleet cluster's replicas and storage's fleet gauges: every replica
    answered, B3 launched warm-ups + flushes times in each (the learner's
    replica 0 from its closing snapshot, each child from its last snapshot,
    read at a flush boundary), replica 0 served at least FLEET_HOLD's
    flushes while inference-1 was held and the workers failed over to it,
    and storage leased every child (again, after the hold) and raised the
    version floor."""
    children = {int(s["rid"]): s for s in srcs if s.get("role") == "inference"}
    if sorted(children) != list(range(1, replicas)):
        fail(f"cluster ({tag}): replica snapshots from {sorted(children)}, "
             f"expected 1..{replicas - 1}")
    rows = {0: lrn, **children}
    out: dict = {"replies": {}, "b3": {}}
    for rid, snap in sorted(rows.items()):
        b3 = int(metric(snap, "inference-fused-act-launches"))
        warm = int(metric(snap, "inference-warmups"))
        flushes = int(metric(snap, "inference-batches"))
        replies = int(metric(snap, "inference-replies"))
        if replies <= 0:
            fail(f"cluster ({tag}): replica {rid} answered no request")
        if b3 != warm + flushes:
            fail(f"cluster ({tag}): replica {rid} B3 launches {b3}, expected warm-ups {warm} + "
                 f"flushes {flushes}")
        out["replies"][rid] = replies
        out["b3"][rid] = dict(launches=b3, warmups=warm, flushes=flushes)
        if rid > 0 and metric(snap, "inference-flush-deadline") != 0:
            fail(f"cluster ({tag}): replica {rid} flushed on a deadline")
    total = sum(out["replies"].values())
    out["reply_share"] = {rid: n / total for rid, n in out["replies"].items()}
    out["hold"] = hold
    if out["b3"][0]["flushes"] < FLEET_HOLD["flushes"]:
        fail(f"cluster ({tag}): replica 0 flushed {out['b3'][0]['flushes']} times, expected "
             f">= {FLEET_HOLD['flushes']} with inference-1 held: {hold}")
    active = metric(sto, "fleet-replicas-active", "gauges")
    floor = metric(sto, "fleet-version-floor", "gauges")
    if active != replicas - 1 or floor is None or floor < 0:
        fail(f"cluster ({tag}): storage's fleet-replicas-active {active} (expected "
             f"{replicas - 1}), fleet-version-floor {floor} (expected >= 0)")
    out.update(replicas_active=active, version_floor=floor,
               min_active_version=metric(sto, "fleet-min-active-version", "gauges"))
    out.update(replicas_joined=metric(sto, "fleet-replicas-joined"),
               replicas_evicted=metric(sto, "fleet-replicas-evicted"))
    for name in ("fleet-hedge-fired", "fleet-failovers", "fleet-dedup-replies",
                 "fleet-floor-rejects", "fleet-reprobes"):
        out[name] = sum(metric(w, name) or 0 for w in workers)
    if out["fleet-failovers"] < 1:
        fail(f"cluster ({tag}): no worker failed over while inference-1 was held: {out}")
    return out


def loadgen_row(doc: dict, snaps: dict[int, dict], tag: str) -> dict:
    """One sweep's curve, with each replica's B3 launches (its last
    snapshot: warm-ups + flushes, read at a flush boundary)."""
    b3 = {}
    for rid, snap in sorted(snaps.items()):
        launches = int(metric(snap, "inference-fused-act-launches"))
        warm, flushes = int(metric(snap, "inference-warmups")), int(metric(snap, "inference-batches"))
        if launches != warm + flushes or flushes == 0:
            fail(f"loadgen ({tag}): replica {rid} B3 launches {launches}, expected warm-ups "
                 f"{warm} + flushes {flushes} (> 0)")
        b3[rid] = dict(launches=launches, warmups=warm, flushes=flushes,
                       replies=int(metric(snap, "inference-replies")),
                       recompiles=metric(snap, "inference-xla-recompiles"))
    curve = [{k: st.get(k) for k in ("offered_rps", "achieved_rps", "p50_ms", "p99_ms",
                                     "success_rate", "hedges", "failovers", "version_floor")}
             for st in doc["stages"]]
    return dict(curve=curve, overall=doc["overall"], b3_by_replica=b3,
                killed_replica=doc.get("killed_replica"))


def sharded_phase(card: str) -> dict:
    """(F3) A replica over ``inference_mesh_data`` 2 devices: with one card
    it must refuse, naming the device count; with two or more, it and a
    one-device replica answer the same scripted stream (obs, episode
    starts, and so carries) from the same params, held at the serving bar
    (logits and carries 1e-5; each reply's log-prob its logits at its
    action, 1e-6), with B3 launched once a device a flush."""
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.fleet import InferenceReplica
    from tpu_rl_torch.models.families import build_family
    from tpu_rl_torch.ops import fused_act as FA
    from tpu_rl_torch.runtime.local_router import LocalRouter

    cfg1 = Config.from_dict(dict(SERVE_CFG, act_mode="remote", inference_replicas=2))
    cfg2 = cfg1.replace(inference_mesh_data=2)
    family = build_family(cfg1, device="cpu")
    params = seeded_params(family, 0)
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        try:
            InferenceReplica(cfg2, family, params, LocalRouter())
        except ValueError as e:
            if "requested 2 devices, only 1 visible" not in str(e):
                fail(f"sharded replica on one card raised the wrong error: {e}")
            print(f"sharded replica (inference_mesh_data=2) on {n_cards} card: refused, "
                  f"'{e}' [{card}]", flush=True)
            return dict(cards=n_cards, refused=str(e))
        fail("sharded replica (inference_mesh_data=2) on one card did not refuse")

    D = int(cfg1.obs_shape[0])

    def streams(k):
        rng = np.random.default_rng(100 + k)
        obs = rng.standard_normal((SHARDED_ACTS, SHARDED_ENVS, D)).astype(np.float32)
        first = (rng.random((SHARDED_ACTS, SHARDED_ENVS)) < 0.1).astype(np.float32)
        first[0] = 1.0
        return obs, first

    out: dict = {"cards": n_cards}
    replies = {}
    for n, cfg in ((1, cfg1), (2, cfg2)):
        router = LocalRouter()
        svc = InferenceReplica(cfg, build_family(cfg, device="cuda"), params, router).start()
        if not svc.wait_ready(120.0) or svc.error is not None:
            fail(f"sharded phase: the {n}-device replica failed: {svc.error}")
        FA.LAUNCHES_BY_DEVICE.clear()
        before = FA.LAUNCHES
        r = drive(cfg, router, SHARDED_CLIENTS, SHARDED_ENVS, SHARDED_ACTS, f"shard{n}",
                  streams=streams, keep=range(SHARDED_CLIENTS))
        svc.close()
        flushes = svc.n_batches
        by_dev = dict(FA.LAUNCHES_BY_DEVICE)
        if r["client_failures"] or r["bad_replies"]:
            fail(f"sharded phase ({n} devices): {r['client_failures']} failures, "
                 f"{r['bad_replies']} bad replies")
        if FA.LAUNCHES - before != n * flushes or sorted(by_dev) != list(range(n)) or any(
                v != flushes for v in by_dev.values()):
            fail(f"sharded phase ({n} devices): B3 launches {by_dev} over {flushes} flushes, "
                 f"expected one a device a flush")
        replies[n] = r.pop("kept")
        out[f"{n}_devices"] = dict(r, flushes=flushes, b3_by_device=by_dev,
                                   buckets=list(svc.buckets), shards=[str(d) for d in svc.shards])
    errs = {"logits": 0.0, "hx": 0.0, "cx": 0.0}
    for k in range(SHARDED_CLIENTS):
        for got, want in zip(replies[2][k], replies[1][k], strict=True):
            for key in errs:
                errs[key] = max(errs[key], float(np.abs(got[key] - want[key]).max()))
    out["max_abs_err"] = errs
    if max(errs.values()) > 1e-5:
        fail(f"sharded replica vs one-device replica beyond 1e-5: {errs}")
    print(f"sharded replica over {n_cards} cards (inference_mesh_data=2) vs one device: "
          f"{out} [{card}]", flush=True)
    return out


def fleet_cluster_phase(card: str) -> dict:
    """(F1) cluster run (d)."""
    tag, over = FLEET_RUN
    out = cluster_run(tag, over, card)
    fl = out["fleet"]
    print(f"fleet cluster (d): {out['updates_per_s']} updates/s, "
          f"{out['env_steps_ingested_per_s']} env steps/s, reply share by replica "
          f"{fl['reply_share']}, B3 by replica {fl['b3']}, inference-1 held {fl['hold']}, "
          f"failovers {fl['fleet-failovers']}, storage floor {fl['version_floor']}, active "
          f"{fl['replicas_active']}, joined {fl['replicas_joined']}, evicted "
          f"{fl['replicas_evicted']} [{card}]", flush=True)
    return out


def fleet_sweeps_phase(card: str) -> dict:
    """(F2) the load sweeps: the kill sweep, then the curve."""
    from tpu_rl_torch.examples import loadgen_smoke

    out = {}
    for name, kw in (("kill", FLEET_SWEEP), ("curve", FLEET_CURVE)):
        rdir = ROOT / ".chip_scratch" / f"loadgen-{name}"
        t0 = time.perf_counter()
        doc, snaps, failures = loadgen_smoke.run(base_port=free_block(12), result_dir=str(rdir),
                                                 device="cuda", **kw)
        if failures:
            fail(f"loadgen ({name}): {failures}")
        row = loadgen_row(doc, snaps, name)
        row["wall_s"] = time.perf_counter() - t0
        out[f"loadgen_{name}"] = row
        print(f"loadgen ({name}, {kw['clients']} clients, 2 drivers, 2 replicas"
              + (f", SIGKILL of replica {row['killed_replica']} at {kw['kill_at']} s"
                 if kw["kill_at"] else "")
              + f"): overall {row['overall']}, curve {row['curve']}, B3 by replica "
              f"{row['b3_by_replica']} [{card}]", flush=True)
    return out


# ------------------------------------------ data and sequence parallelism
# The multi-GPU slice on one card. NCCL refuses two ranks on one device, so
# at world size 1 every data-parallel path runs over a real one-rank NCCL
# communicator in this process, and two ranks share the card over gloo (the
# mesh stages each collective through host memory) in spawned children.
# Nothing here is a scaling number: one card cannot show one.
DP_WARMUP, DP_UPDATES = 2, 5  # (P1) IMPALA@wide-lstm, untimed + timed
# (P2) the default config's colocated loop: updates, then a run saving every
# DP_SAVE_EVERY updates to DP_SAVED and one resuming from it to DP_RESUMED
DP_COLOCATED_UPDATES, DP_SAVE_EVERY, DP_SAVED, DP_RESUMED = 10, 5, 5, 8
# tests/test_parallel.py:83-96's bars: loss (rtol, atol), params (rtol, atol)
DP_LOSS_TOL, DP_PARAM_TOL = (2e-4, 2e-5), (2e-3, 2e-5)
DP_RANKS = 2
DP_RANK_TIMEOUT_S = 420.0
# (P4) ring and Ulysses at PPO-transformer@longctx-flash's attention shape
SP_SHAPE = (16, 2048, 8, 64)
SP_BF16_BAR = 2.0**-6  # PERF.md §2's blockwise bar, per tensor: share of max|ref|
SP_TIMED = 3
DP_FLASH_UPDATES = 3
DP_CLUSTER_RUN = ("c", dict(CLUSTER_RUNS[0][1], mesh_data=DP_RANKS))


def dp_init_world1():
    """This process as a one-rank NCCL world (file:// rendezvous under the
    git-ignored .chip_scratch/); returns its mesh."""
    from tpu_rl_torch.parallel.mesh import init_process_group, make_mesh

    rdv = ROOT / ".chip_scratch" / f"rdv-world1-{os.getpid()}"
    rdv.parent.mkdir(parents=True, exist_ok=True)
    rdv.unlink(missing_ok=True)
    backend = init_process_group(f"file://{rdv}", 1, 0, torch.device("cuda", 0), False)
    if backend != "nccl":
        fail(f"world size 1 on the card joined {backend}, expected nccl")
    return make_mesh(1, device=torch.device("cuda", 0))


def flat_params(state) -> torch.Tensor:
    leaves = state_leaves(state)
    return torch.cat([x.reshape(-1).float() for v in leaves.values() for x in v])


def close_to(got: torch.Tensor, want: torch.Tensor, tol: tuple[float, float]) -> float:
    """Largest |got - want| / (atol + rtol |want|): <= 1 passes."""
    rtol, atol = tol
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def dp_step_run(cfg, mesh, updates: int, warmup: int):
    """(final state, last metrics, timing) of ``warmup`` + ``updates``
    updates of ``cfg``'s step on ``lstm_batch(cfg, 0)`` (this rank's rows
    under a mesh) from the seed-0 state; B1/B2's counters zeroed before
    the timed updates."""
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.ops import lstm as L
    from tpu_rl_torch.parallel.dp import make_parallel_train_step, replicate, shard_batch

    _f, state, step = get_algo(cfg.algo).build(
        cfg, torch.Generator().manual_seed(0), device=mesh.device if mesh else "cuda", mesh=mesh)
    batch = lstm_batch(cfg, 0, device=str(mesh.device) if mesh else "cuda")
    if mesh is not None:
        replicate(state, mesh)
        step = make_parallel_train_step(step, mesh, cfg)
        batch = shard_batch(batch, mesh)
    for _ in range(warmup):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
    staged0 = mesh.staged_bytes if mesh else 0
    enqueue = []
    t0 = time.perf_counter()
    for _ in range(updates):
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        enqueue.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timing = dict(ms_per_update=wall / updates * 1e3, enqueue_ms=statistics.median(enqueue) * 1e3,
                  lstm_fwd_launches=L.LSTM_FWD_LAUNCHES, lstm_bwd_launches=L.LSTM_BWD_LAUNCHES,
                  staged_bytes_per_update=((mesh.staged_bytes - staged0) / updates) if mesh else 0,
                  rows=batch.obs.shape[0])

    def one():
        nonlocal state
        state, _m = step(state, batch)

    timing["device_ms_per_update"] = device_ms(one, iters=2, reps=3, warmup=1)
    return state, metrics, timing


def dp_colocated(cfg_kw: dict, updates: int, model_dir: str | None = None,
                 resume_to: int | None = None):
    """The default config's colocated loop (world from the process group):
    ``updates`` updates, or with ``model_dir`` a run saving every
    DP_SAVE_EVERY updates to ``updates`` and a fresh loop resuming from the
    newest committed one to ``resume_to``. Returns (state, record)."""
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import lstm as L
    from tpu_rl_torch.runtime.colocated import ColocatedLoop

    kw = dict(TRAIN_CFG, **cfg_kw, loss_log_interval=updates)
    if model_dir is not None:
        kw.update(model_dir=model_dir, model_save_interval=DP_SAVE_EVERY)
    L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
    loop = ColocatedLoop(Config(**kw), seed=0, max_updates=updates, device="cuda")
    out = loop.run(log=False)
    rec = dict(updates=out["updates"], episodes=out["episodes"],
               lstm_fwd_launches=L.LSTM_FWD_LAUNCHES, lstm_bwd_launches=L.LSTM_BWD_LAUNCHES)
    if model_dir is None:
        return loop.state, rec
    again = ColocatedLoop(Config(**dict(kw, loss_log_interval=resume_to)), seed=0,
                          max_updates=resume_to, device="cuda")
    out2 = again.run(log=False)
    rec.update(resumed_from=again._start_it, run_epoch=again.run_epoch,
               resumed_updates=out2["updates"], episodes_after_resume=out2["episodes"])
    return again.state, rec


def sp_attention(mesh, impl: str) -> dict:
    """Ring or Ulysses attention over ``mesh``'s seq group at SP_SHAPE in
    bf16: this rank's block of o and of the grads of sum(o * do) against
    full attention in f32 on the same bf16 inputs, per tensor as a share of
    max|ref|; and the fwd+bwd wall time of one layer's attention (staged
    collectives block the host)."""
    from tpu_rl_torch.ops import attention as A
    from tpu_rl_torch.parallel.sequence import ATTENTION_IMPLS, full_attention

    B, T, H, D = SP_SHAPE
    q, k, v, seg, do = attn_inputs(B, T, H, D, torch.bfloat16, 8, 41)
    pos = torch.arange(T, dtype=torch.int32, device="cuda").expand(B, T).contiguous()
    tl = slice(mesh.seq_index * (T // mesh.n_seq), (mesh.seq_index + 1) * (T // mesh.n_seq))
    ins = [x[:, tl].contiguous().requires_grad_() for x in (q, k, v)]
    fn = ATTENTION_IMPLS[impl]

    def call():
        for x in ins:
            x.grad = None
        o = fn(*ins, pos[:, tl], seg[:, tl], causal=True, mesh=mesh)
        (o.float() * do[:, tl].float()).sum().backward()
        return o

    # B4's launches in this path's calls (the f32 reference runs none)
    A.FLASH_FWD_LAUNCHES = A.FLASH_BWD_LAUNCHES = 0
    o = call()
    launches = [A.FLASH_FWD_LAUNCHES, A.FLASH_BWD_LAUNCHES]
    got = {"o": o.detach(), "dq": ins[0].grad, "dk": ins[1].grad, "dv": ins[2].grad}
    ref_in = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref = full_attention(*ref_in, pos, seg, causal=True)
    (ref * do.float()).sum().backward()
    want = {"o": ref.detach(), "dq": ref_in[0].grad, "dk": ref_in[1].grad, "dv": ref_in[2].grad}
    errs = {n: float((got[n].float() - want[n][:, tl]).abs().max() / want[n].abs().max())
            for n in got}
    del ref, ref_in, want
    torch.cuda.synchronize()
    A.FLASH_FWD_LAUNCHES = A.FLASH_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(SP_TIMED):
        call()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / SP_TIMED * 1e3
    return dict(impl=impl, errs=errs, bar=SP_BF16_BAR, ms_fwd_bwd_per_layer=ms,
                flash_fwd_launches=launches[0] + A.FLASH_FWD_LAUNCHES,
                flash_bwd_launches=launches[1] + A.FLASH_BWD_LAUNCHES)


def rank_main(argv: list[str]) -> None:
    """One of ``W`` ranks (``--rank R --world W --rdv FILE --out DIR``), on
    the card and backend the port's rule gives it (one card: every rank on
    it, gloo; a card a rank: NCCL): (P1) the DP step at IMPALA@wide-lstm on
    this rank's rows, (P2) the colocated loop with its checkpoint resume,
    (P4) ring and Ulysses attention. Results go to ``DIR/rank<R>.json``
    and ``DIR/rank<R>-*.pt``."""
    args = dict(zip(argv[0::2], argv[1::2]))
    rank, world = int(args["--rank"]), int(args["--world"])
    out = Path(args["--out"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.parallel.mesh import (
        init_process_group,
        make_mesh,
        make_sp_mesh,
        rank_device,
    )

    dev, share = rank_device(rank, world)
    backend = init_process_group(f"file://{args['--rdv']}", world, rank, dev, share)
    res: dict = {"rank": rank, "backend": backend, "device": str(dev)}
    mesh = make_mesh(world, device=dev)
    res["host_staging"] = mesh.host_staging
    cfg = Config.from_dict(dict(WIDE_LSTM_CFG, algo="IMPALA"))
    state, metrics, timing = dp_step_run(cfg, mesh, DP_UPDATES, DP_WARMUP)
    res["p1"] = dict(timing, loss=float(metrics["loss"]))
    torch.save(flat_params(state).cpu(), out / f"rank{rank}-p1.pt")
    del state
    import tempfile

    st, rec = dp_colocated({"mesh_data": world}, DP_COLOCATED_UPDATES)
    torch.save(flat_params(st).cpu(), out / f"rank{rank}-p2.pt")
    res["p2"] = rec
    ck = Path(tempfile.gettempdir()) / "chip_smoke_dp_ckpt"
    if rank == 0:
        import shutil

        shutil.rmtree(ck, ignore_errors=True)
    torch.distributed.barrier()
    st, rec = dp_colocated({"mesh_data": world}, DP_SAVED, str(ck), DP_RESUMED)
    torch.save(flat_params(st).cpu(), out / f"rank{rank}-p2r.pt")
    res["p2_resume"] = rec
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    sp = make_sp_mesh(1, world, device=dev)
    res["p4"] = {impl: sp_attention(sp, impl) for impl in ("ring", "ulysses")}
    res["staged_bytes"] = mesh.staged_bytes + sp.staged_bytes
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def spawn_ranks(world: int, out: Path, timeout: float = DP_RANK_TIMEOUT_S) -> list[int | None]:
    """``world`` children running :func:`rank_main`; returns their exit
    codes (None for a child killed at the timeout). Every child is stopped
    before this returns."""
    rdv = out / f"rdv-{time.time_ns()}"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--rank", str(r), "--world", str(world),
         "--rdv", str(rdv), "--out", str(out)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    codes: list[int | None] = []
    deadline = time.monotonic() + timeout
    for r, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            codes.append(p.returncode)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
            codes.append(None)
        tail = "\n".join(f"  rank {r}| {ln}" for ln in log.splitlines()[-12:])
        print(f"rank {r} exit {codes[-1]}:\n{tail}", flush=True)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return codes


def dp_ranks_phase(ranks: int = DP_RANKS) -> Path:
    """The DP_RANKS ranks of :func:`dp_phase`, sharing the card over gloo
    (host-staged collectives), run to their end: the folder of their
    results, which :func:`dp_phase` holds against world size 1. They run
    beside the smoke's own phases (they count no context and launch
    nothing in this process); world size 1 runs after, in this process."""
    import shutil

    rdir = ROOT / ".chip_scratch" / "dp-ranks"
    shutil.rmtree(rdir, ignore_errors=True)
    rdir.mkdir(parents=True)
    codes = spawn_ranks(ranks, rdir)
    if any(c != 0 for c in codes):
        docs = [json.loads((rdir / f"rank{r}.json").read_text())
                if (rdir / f"rank{r}.json").exists() else {} for r in range(ranks)]
        fail(f"the {ranks} ranks exited {codes}: {docs}")
    return rdir


def dp_phase(card: str, rdir: Path, cluster: dict, ranks: int = DP_RANKS) -> dict:
    """(P1) the DP train step at IMPALA@wide-lstm, (P2) the colocated loop,
    (P4, DP half) the transformer at longctx-flash width with flash: each at
    world size 1 over NCCL against the plain step or loop (bit for bit),
    then the DP_RANKS ranks sharing the card over gloo (run earlier by
    :func:`dp_ranks_phase` into ``rdir``) against world size 1 at
    tests/test_parallel.py's bars; (P3) the cluster with the learner at
    mesh_data DP_RANKS (``cluster``, run earlier). Launch counts per rank;
    the DP wrapper's cost. On a machine with a card a rank, ``ranks`` ranks
    run over NCCL instead."""
    import tempfile

    import torch.distributed as dist

    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import attention as A
    from tpu_rl_torch.parallel.dp import make_parallel_train_step, replicate

    out: dict = {}
    cfg = Config.from_dict(dict(WIDE_LSTM_CFG, algo="IMPALA"))
    # --- plain first: the loops build no mesh outside a process group
    p_state, p_metrics, p_time = dp_step_run(cfg, None, DP_UPDATES, DP_WARMUP)
    plain_p1 = flat_params(p_state)
    del p_state
    c_state, c_rec = dp_colocated({}, DP_COLOCATED_UPDATES)
    plain_p2 = flat_params(c_state)

    mesh = dp_init_world1()
    d_state, d_metrics, d_time = dp_step_run(cfg, mesh, DP_UPDATES, DP_WARMUP)
    world1_p1 = flat_params(d_state)
    n_grads = world1_p1.numel()
    bitwise_p1 = bool(torch.equal(world1_p1, plain_p1)) and float(d_metrics["loss"]) == float(
        p_metrics["loss"])
    diff_p1 = float((world1_p1 - plain_p1).abs().max())
    want = cfg.K_epoch * DP_UPDATES
    if (d_time["lstm_fwd_launches"], d_time["lstm_bwd_launches"]) != (want, want):
        fail(f"DP step world 1: B1/B2 launches {d_time['lstm_fwd_launches']}/"
             f"{d_time['lstm_bwd_launches']}, want updates x K_epoch = {want}")
    if not bitwise_p1:
        print(f"DP step world 1 vs plain: NOT bit for bit, max |diff| {diff_p1}", flush=True)
        if close_to(world1_p1, plain_p1, DP_PARAM_TOL) > 1.0:
            fail(f"DP step world 1 vs plain: params beyond the bar (max |diff| {diff_p1})")
    buf = torch.zeros(n_grads + 1, device="cuda")
    ar_ms = device_ms(lambda: mesh.all_reduce_(buf), iters=20, reps=3, warmup=3)
    del d_state
    out["p1_world1"] = dict(plain=p_time, dp=d_time, bitwise=bitwise_p1, max_abs_diff=diff_p1,
                            grad_bytes_per_update=4 * (n_grads + 1) * cfg.K_epoch,
                            all_reduce_device_ms=ar_ms, loss=float(d_metrics["loss"]))
    print(
        f"DP step IMPALA@wide-lstm world 1 (nccl) vs plain: bit for bit {bitwise_p1} (max |diff| "
        f"{diff_p1}); ms/update {d_time['ms_per_update']:.4f} vs {p_time['ms_per_update']:.4f}, "
        f"host enqueue {d_time['enqueue_ms']:.4f} vs {p_time['enqueue_ms']:.4f} ms, device "
        f"{d_time['device_ms_per_update']:.4f} vs {p_time['device_ms_per_update']:.4f} ms an "
        f"update; grads all-reduced {4 * (n_grads + 1) * cfg.K_epoch} bytes an update, the "
        f"all-reduce {ar_ms:.6f} ms of device time; B1/B2 launches "
        f"{d_time['lstm_fwd_launches']}/{d_time['lstm_bwd_launches']} (want {want}) [{card}]",
        flush=True,
    )
    w_state, w_rec = dp_colocated({}, DP_COLOCATED_UPDATES)
    world1_p2 = flat_params(w_state)
    bitwise_p2 = bool(torch.equal(world1_p2, plain_p2)) and w_rec["episodes"] == c_rec["episodes"]
    diff_p2 = float((world1_p2 - plain_p2).abs().max())
    if not bitwise_p2 and close_to(world1_p2, plain_p2, DP_PARAM_TOL) > 1.0:
        fail(f"colocated world 1 vs plain: params beyond the bar (max |diff| {diff_p2})")
    want2 = DP_COLOCATED_UPDATES * Config().K_epoch
    if (w_rec["lstm_fwd_launches"], w_rec["lstm_bwd_launches"]) != (want2, want2):
        fail(f"colocated world 1: B1/B2 launches {w_rec}, want {want2}")
    ck = tempfile.mkdtemp(prefix="chip_smoke_dp1_")
    r_state, r_rec = dp_colocated({}, DP_SAVED, ck, DP_RESUMED)
    if (r_rec["resumed_from"], r_rec["run_epoch"], r_rec["resumed_updates"]) != (
            DP_SAVED, 1, DP_RESUMED):
        fail(f"colocated world 1: resume {r_rec}")
    world1_p2r = flat_params(r_state)
    out["p2_world1"] = dict(bitwise=bitwise_p2, max_abs_diff=diff_p2, plain=c_rec, dp=w_rec,
                            resume=r_rec)
    print(f"colocated PPO 128 envs world 1 (nccl) vs plain, {DP_COLOCATED_UPDATES} updates: bit "
          f"for bit {bitwise_p2} (max |diff| {diff_p2}), episodes {w_rec['episodes']} vs "
          f"{c_rec['episodes']}; resume {r_rec} [{card}]", flush=True)

    # --- (P4, DP half) the transformer at longctx-flash width, flash per rank,
    # against the plain step on the same seed, batch and updates
    tcfg = Config.from_dict(TF_TRAIN_CFG)
    t_batch = tf_batch(tcfg, 0)
    _f, t_state, t_step = get_algo(tcfg.algo).build(
        tcfg, torch.Generator().manual_seed(0), device="cuda", mesh=None)
    for _ in range(1 + DP_FLASH_UPDATES):
        t_state, t_metrics = t_step(t_state, t_batch)
    plain_tf, plain_tf_loss = flat_params(t_state), float(t_metrics["loss"])
    del t_state, t_step
    _f, t_state, t_step = get_algo(tcfg.algo).build(
        tcfg, torch.Generator().manual_seed(0), device="cuda", mesh=mesh)
    replicate(t_state, mesh)
    t_step = make_parallel_train_step(t_step, mesh, tcfg)
    t_state, _m = t_step(t_state, t_batch)
    torch.cuda.synchronize()
    A.FLASH_FWD_LAUNCHES = A.FLASH_BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(DP_FLASH_UPDATES):
        t_state, t_metrics = t_step(t_state, t_batch)
    torch.cuda.synchronize()
    tf_ms = (time.perf_counter() - t0) / DP_FLASH_UPDATES * 1e3
    f_fwd, f_bwd = A.FLASH_FWD_LAUNCHES, A.FLASH_BWD_LAUNCHES
    want4 = tcfg.n_layers * tcfg.K_epoch * DP_FLASH_UPDATES
    if (f_fwd, f_bwd) != (want4, want4) or not np.isfinite(float(t_metrics["loss"])):
        fail(f"DP flash transformer world 1: B4 launches {f_fwd}/{f_bwd} (want {want4}), "
             f"loss {float(t_metrics['loss'])}")
    world1_tf = flat_params(t_state)
    bitwise_tf = bool(torch.equal(world1_tf, plain_tf)) and float(t_metrics["loss"]) == plain_tf_loss
    diff_tf = float((world1_tf - plain_tf).abs().max())
    if not bitwise_tf:
        print(f"DP transformer world 1 vs plain: NOT bit for bit, max |diff| {diff_tf}, loss "
              f"{float(t_metrics['loss'])} vs {plain_tf_loss}", flush=True)
        if close_to(world1_tf, plain_tf, DP_PARAM_TOL) > 1.0:
            fail(f"DP transformer world 1 vs plain: params beyond the bar (max |diff| {diff_tf})")
    out["p4_dp_flash_world1"] = dict(ms_per_update=tf_ms, flash_fwd_launches=f_fwd,
                                     flash_bwd_launches=f_bwd, loss=float(t_metrics["loss"]),
                                     bitwise=bitwise_tf, max_abs_diff=diff_tf)
    print(f"DP transformer longctx-flash world 1 (nccl) vs plain, {1 + DP_FLASH_UPDATES} updates: "
          f"bit for bit {bitwise_tf} (max |diff| {diff_tf}); {tf_ms:.4f} ms/update, B4 launches "
          f"{f_fwd}/{f_bwd} = n_layers x K_epoch x updates [{card}]", flush=True)
    del plain_tf
    del t_state, t_step, t_batch
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # --- two ranks sharing the card over gloo (host-staged collectives)
    docs = [json.loads((rdir / f"rank{r}.json").read_text()) for r in range(ranks)]
    p1 = [torch.load(rdir / f"rank{r}-p1.pt") for r in range(ranks)]
    p2 = [torch.load(rdir / f"rank{r}-p2.pt") for r in range(ranks)]
    p2r = [torch.load(rdir / f"rank{r}-p2r.pt") for r in range(ranks)]
    if not all(torch.equal(p1[0], x) and torch.equal(p2[0], y) and torch.equal(p2r[0], z)
               for x, y, z in zip(p1, p2, p2r)):
        fail("the ranks hold different params")
    two = dict(
        p1_vs_world1=close_to(p1[0], world1_p1.cpu(), DP_PARAM_TOL),
        p1_loss_vs_world1=abs(docs[0]["p1"]["loss"] - out["p1_world1"]["loss"])
        / (DP_LOSS_TOL[1] + DP_LOSS_TOL[0] * abs(out["p1_world1"]["loss"])),
        p2_vs_world1=close_to(p2[0], world1_p2.cpu(), DP_PARAM_TOL),
        p2_resumed_vs_world1=close_to(p2r[0], world1_p2r.cpu(), DP_PARAM_TOL),
    )
    bad = {k: v for k, v in two.items() if not v <= 1.0}
    for d in docs:
        t = d["p1"]
        if (t["lstm_fwd_launches"], t["lstm_bwd_launches"]) != (want, want):
            fail(f"rank {d['rank']}: B1/B2 launches {t}, want {want}")
        if d["p2_resume"]["resumed_from"] != DP_SAVED or d["p2_resume"]["run_epoch"] != 1:
            fail(f"rank {d['rank']}: resume {d['p2_resume']}")
        for impl, a in d["p4"].items():
            if not all(e <= SP_BF16_BAR for e in a["errs"].values()):
                bad[f"rank {d['rank']} {impl}"] = a["errs"]
            if (a["flash_fwd_launches"], a["flash_bwd_launches"]) != (0, 0):
                fail(f"rank {d['rank']} {impl}: B4 launches {a['flash_fwd_launches']}/"
                     f"{a['flash_bwd_launches']}, want 0 (ring and Ulysses are plain, as tpu_rl's)")
    if bad:
        fail(f"{ranks} ranks vs world 1 / full attention beyond the bar "
             f"(share of the bar, <= 1 passes): {bad}")
    out["two_ranks"] = dict(share_of_bar=two, ranks=docs)
    for d in docs:
        print(f"rank {d['rank']}/{ranks} on {d['device']} ({d['backend']}, host staging "
              f"{d['host_staging']}): "
              f"DP IMPALA@wide-lstm {d['p1']['rows']} rows {d['p1']['ms_per_update']:.4f} "
              f"ms/update (not a scaling number), host-staged {d['p1']['staged_bytes_per_update']} "
              f"bytes an update, B1/B2 launches {d['p1']['lstm_fwd_launches']}/"
              f"{d['p1']['lstm_bwd_launches']}; colocated {d['p2']}; resume {d['p2_resume']}; "
              + "; ".join(f"{i} errs {a['errs']} (bar {a['bar']}) {a['ms_fwd_bwd_per_layer']:.4f} "
                          f"ms fwd+bwd a layer, B4 launches {a['flash_fwd_launches']}/"
                          f"{a['flash_bwd_launches']}" for i, a in d["p4"].items())
              + f" [{card}]", flush=True)
    print(f"{ranks} ranks vs world 1, share of tests/test_parallel.py's bars: {two} [{card}]",
          flush=True)
    # --- (P3) the cluster with the learner's ranks
    out["cluster"] = cluster
    return out


def sp_phase(card: str, dp: dict, attn_rows: list[dict], blockwise_rows: list[dict]) -> dict:
    """(P4) the transformer at PPO-transformer@longctx-flash width: ring and
    Ulysses attention over a seq group of DP_RANKS ranks sharing the card
    (run by dp_phase's ranks; o and grads against full attention in f32 on
    the same bf16 inputs at SP_BF16_BAR per tensor), beside B4's and
    blockwise attention's fwd+bwd at the same shape from this run; and the
    data-parallel step with flash at world size 1 (B4 per rank)."""
    b4 = next(r for r in attn_rows if (r["shape"]["B"], r["shape"]["T"], r["shape"]["H"],
                                       r["shape"]["D"]) == SP_SHAPE
              and r["shape"]["dtype"] == "bfloat16")
    blk = next((r for r in blockwise_rows if r["dtype"] == "bfloat16"), blockwise_rows[0])
    ranks = {d["rank"]: d["p4"] for d in dp["two_ranks"]["ranks"]}
    out = dict(
        shape=SP_SHAPE, bar=SP_BF16_BAR, by_rank=ranks,
        b4_fwd_bwd_ms=b4["flash_attn_fwd"]["ms"] + b4["flash_attn_bwd"]["ms"],
        blockwise_fwd_bwd_ms=blk["fwd_ms"] + blk["bwd_ms"],
        dp_flash_world1=dp["p4_dp_flash_world1"],
    )
    for impl in ("ring", "ulysses"):
        out[f"{impl}_fwd_bwd_ms"] = max(r[impl]["ms_fwd_bwd_per_layer"] for r in ranks.values())
        out[f"{impl}_max_share_of_max_ref"] = max(max(r[impl]["errs"].values())
                                                 for r in ranks.values())
    print(
        f"SP attention {SP_SHAPE} bf16, fwd+bwd ms a layer: ring {out['ring_fwd_bwd_ms']:.4f} and "
        f"Ulysses {out['ulysses_fwd_bwd_ms']:.4f} ({DP_RANKS} ranks sharing the card over gloo, "
        f"collectives staged through host memory: wall time, not a scaling number), B4 "
        f"{out['b4_fwd_bwd_ms']:.4f}, blockwise {out['blockwise_fwd_bwd_ms']:.4f} (device time, "
        f"one card); error as a share of max|ref|: ring {out['ring_max_share_of_max_ref']:.3e}, "
        f"Ulysses {out['ulysses_max_share_of_max_ref']:.3e} (bar {SP_BF16_BAR}); DP flash world 1: "
        f"B4 launches {out['dp_flash_world1']['flash_fwd_launches']}/"
        f"{out['dp_flash_world1']['flash_bwd_launches']} [{card}]",
        flush=True,
    )
    return out


# ------------------------------------------------------------ training topology
# (S1) the Sebulba split with both lanes on the one card, at the default
# config; SEBULBA_UPDATES timed updates each way beside the colocated loop
SEBULBA_UPDATES, SEBULBA_QUEUE = 100, 2
# (M1) the multihost learner: MH_HOSTS hosts of MH_LOCAL ranks sharing the
# card over gloo, each host's storage fed seeded windows at tpu_rl's
# default config (batch 128 a host, S 5, H 64)
MH_HOSTS, MH_LOCAL, MH_UPDATES = 2, 2, 10
MH_CFG = dict(env="CartPole-v1", algo="PPO", obs_shape=(4,), action_space=2, batch_size=128,
              buffer_size=128, seq_len=5, hidden_size=64, loss_log_interval=10)
MH_TIMEOUT_S = 300.0
# (PBT) K colocated PPO members at the default config, member 0 poisoned
# (one evaluation: the second generation's threshold lies past the budget,
# so the exploited member's last incarnation runs updates)
PBT_K, PBT_UPDATES, PBT_INTERVAL, PBT_POISON_LR = 2, 150, 110, 0.05
PBT_TIMEOUT_S = 300.0


def sebulba_phase(card: str) -> dict:
    """(S1) ``SebulbaLoop`` on the test seam's ``["cuda:0", "cuda:0"]``
    (split 1, queue SEBULBA_QUEUE) at the default config (PPO, CartPole-v1,
    H 64, S 5, 128 envs): B1/B2 launches on the learner lane = updates x
    K_epoch (counters zeroed just before the run, read just after); the
    queue peak within the depth and every batch's staleness within depth +
    1; compute and queue-wait on both lane ledgers; the learner's final
    state equal, bit for bit, to the colocated train step replaying the
    batches the lane consumed from the initial state; updates/s and
    transitions/s beside ``ColocatedLoop.run`` at the same config on the
    same card (no scaling number: one card), and the lanes' overlap."""
    import copy
    import tempfile

    from tpu_rl_torch.config import Config
    from tpu_rl_torch.ops import fused_act as FA
    from tpu_rl_torch.ops import lstm as L
    from tpu_rl_torch.runtime.colocated import ColocatedLoop
    from tpu_rl_torch.runtime.sebulba import SebulbaLoop

    kw = dict(TRAIN_CFG, sebulba_split=1, sebulba_queue=SEBULBA_QUEUE,
              loss_log_interval=SEBULBA_UPDATES // 4,
              result_dir=tempfile.mkdtemp(prefix="chip_smoke_sebulba_"))
    loop = SebulbaLoop(Config(**kw), seed=0, max_updates=SEBULBA_UPDATES, device="cuda",
                       devices=["cuda:0", "cuda:0"], record_batches=True)
    init = copy.deepcopy(loop.state)
    torch.cuda.synchronize()
    fa0 = FA.LAUNCHES
    L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
    out = loop.run(log=False)
    fwd, bwd = L.LSTM_FWD_LAUNCHES, L.LSTM_BWD_LAUNCHES
    want = SEBULBA_UPDATES * loop.cfg.K_epoch
    if (out["updates"], fwd, bwd) != (SEBULBA_UPDATES, want, want) or FA.LAUNCHES != fa0:
        fail(f"sebulba: {out['updates']} updates, B1/B2 launches {fwd}/{bwd} (want {want}), "
             f"fused act +{FA.LAUNCHES - fa0}")
    if not 1 <= out["queue_peak_depth"] <= SEBULBA_QUEUE:
        fail(f"sebulba: queue peak {out['queue_peak_depth']} outside [1, {SEBULBA_QUEUE}]")
    if not 0 <= out["max_staleness"] <= SEBULBA_QUEUE + 1:
        fail(f"sebulba: staleness {out['max_staleness']} past depth + 1")
    buckets = {led.role: led.snapshot()["buckets"] for led in loop._ledgers()}
    for role, b in buckets.items():
        if not (b["compute"] > 0 and b["queue-wait"] > 0):
            fail(f"sebulba: the {role} ledger has compute {b['compute']}, queue-wait "
                 f"{b['queue-wait']}")
    ref = ColocatedLoop(Config(**TRAIN_CFG), seed=0, device="cuda")
    state = init
    for _it, seed_it, _ver, batch in loop.consumed:
        state, _m = ref.train_step(state, batch, torch.Generator("cuda").manual_seed(seed_it))
    if not states_equal(state, loop.state):
        fail("sebulba: the learner's state is not the replay of the batches it consumed")
    del loop.consumed[:]
    coloc = ColocatedLoop(Config(**dict(TRAIN_CFG, loss_log_interval=SEBULBA_UPDATES // 4)),
                          seed=0, max_updates=SEBULBA_UPDATES, device="cuda")
    base = coloc.run(log=False)
    wall = out["elapsed_s"]
    overlap = max(0.0, buckets["sebulba-actor"]["compute"]
                  + buckets["sebulba-learner"]["compute"] - wall) / wall
    rec = dict(
        updates=out["updates"], lstm_fwd_launches=fwd, lstm_bwd_launches=bwd,
        queue_peak_depth=out["queue_peak_depth"], max_staleness=out["max_staleness"],
        updates_per_s=out["updates"] / wall, transitions_per_s=out["transitions_per_s"],
        colocated_updates_per_s=base["updates"] / base["elapsed_s"],
        colocated_transitions_per_s=base["transitions_per_s"],
        ledgers=buckets, overlap_share=overlap,
        lane_compute_share={r: b["compute"] / wall for r, b in buckets.items()},
        # each lane's compute per batch, beside train_phase's rollout_ms and
        # train_step_ms (the same work, one thread)
        lane_ms_per_update={r: b["compute"] / out["updates"] * 1e3 for r, b in buckets.items()},
        episodes=out["episodes"], replay_bit_for_bit=True,
    )
    print(
        f"(S1) sebulba split 1 on cuda:0 + cuda:0, queue {SEBULBA_QUEUE}, PPO CartPole 128 "
        f"envs H 64: {out['updates']} updates, {rec['updates_per_s']:.4f} updates/s, "
        f"{rec['transitions_per_s']:.1f} transitions/s (colocated loop "
        f"{rec['colocated_updates_per_s']:.4f} updates/s, "
        f"{rec['colocated_transitions_per_s']:.1f} transitions/s; one card, no scaling "
        f"number); lane compute shares {rec['lane_compute_share']} (ms an update "
        f"{rec['lane_ms_per_update']}), overlap {overlap:.4f} of "
        f"the wall; queue peak {out['queue_peak_depth']}/{SEBULBA_QUEUE}, staleness max "
        f"{out['max_staleness']} (<= depth + 1); B1/B2 launches {fwd}/{bwd} (= updates x "
        f"K_epoch); learner state = replay, bit for bit [{card}]",
        flush=True,
    )
    return rec


SEBULBA_CLI = [sys.executable, "-m", "tpu_rl_torch", "local", "--env-mode", "colocated",
               "--sebulba-split", "1", "--max-updates", "20", "--no-result-dir"]


def sebulba_cli_start() -> subprocess.Popen:
    """(S2)'s command, started (it runs beside (M1), which checks no
    context count)."""
    return subprocess.Popen(SEBULBA_CLI, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def sebulba_cli_phase(card: str, proc: subprocess.Popen | None = None) -> dict:
    """(S2) ``python -m tpu_rl_torch local --env-mode colocated
    --sebulba-split 1`` (``proc``, started by :func:`sebulba_cli_start`):
    on one card it refuses, naming the count of cards; on two or more it
    runs to its budget."""
    n = torch.cuda.device_count()
    cmd = SEBULBA_CLI
    proc = proc or sebulba_cli_start()
    try:
        stdout, stderr = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail("(S2) the split's CLI did not end in 300 s")
    p = subprocess.CompletedProcess(cmd, proc.returncode, stdout, stderr)
    if n == 1:
        want = "sebulba_split=1 must partition torch.cuda.device_count()=1"
        if p.returncode == 0 or want not in p.stderr:
            fail(f"(S2) on one card the split should refuse naming the count: rc "
                 f"{p.returncode}, stderr {p.stderr[-1500:]}")
    elif p.returncode != 0 or "[sebulba] done" not in p.stdout:
        fail(f"(S2) on {n} cards the split should run: rc {p.returncode}, "
             f"{p.stdout[-1000:]} {p.stderr[-1500:]}")
    last = (p.stderr.strip().splitlines() or [""])[-1]
    print(f"(S2) {' '.join(cmd[1:])} on {n} card(s): rc {p.returncode}: {last[:200]} [{card}]",
          flush=True)
    return dict(cards=n, rc=p.returncode, message=last)


def mh_rank_main(argv: list[str]) -> None:
    """One rank of (M1) (``--mh-rank R --coord HOST:PORT --out DIR``, with
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set): a multihost
    ``LearnerService`` at MH_CFG on the card, its host's store fed seeded
    windows tagged with the host's index in ``obs[..., 0]`` by a thread
    (a host's rank 0 reads it; the others get their rows from it).
    Writes DIR/mh<R>.json (updates, B1/B2 launches, the host tags of the
    rows it trained on, ms per update) and DIR/mh<R>.pt (its params, and a
    host's rank 0's assembled batches)."""
    args = dict(zip(argv[0::2], argv[1::2]))
    rank, out = int(args["--mh-rank"]), Path(args["--out"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.data.layout import BatchLayout
    from tpu_rl_torch.data.shm_ring import alloc_handles, make_store
    from tpu_rl_torch.ops import lstm as L
    from tpu_rl_torch.parallel.multihost import host_rank
    from tpu_rl_torch.runtime.learner_service import LearnerService, RankChannel
    from tpu_rl_torch.runtime.mailbox import STAT_SLOTS
    from tpu_rl_torch.types import BATCH_FIELDS
    from tpu_rl_torch.utils.tree import tree_leaves

    host = rank // host_rank()[1]
    cfg = Config.from_dict(dict(MH_CFG, multihost={
        "coordinator": args["--coord"], "num_processes": MH_HOSTS, "process_id": host}))
    layout = BatchLayout.from_config(cfg)
    handles = alloc_handles(layout, cfg.batch_size)
    store = make_store(cfg, layout, handles=handles)
    stop = threading.Event()
    rng = np.random.default_rng(100 + host)

    def feed():
        while not stop.is_set():
            w = {f: rng.standard_normal((layout.seq_len, layout.width(f))).astype(np.float32)
                 * 0.1 for f in BATCH_FIELDS}
            w["act"] = rng.integers(0, 2, w["act"].shape).astype(np.float32)
            w["is_fir"][:] = 0.0
            w["is_fir"][0] = 1.0
            w["log_prob"][:] = -0.7
            w["obs"][:, 0] = float(host)
            while not stop.is_set() and not store.put(w):
                time.sleep(0.001)

    assembled, tags, steps = [], set(), []
    assemble, unpack = LearnerService._assemble_device, RankChannel._unpack

    def assembling(self, raws, dev, stager):
        assembled.extend({k: np.array(v) for k, v in r.items() if k != "ver"} for r in raws)
        return assemble(self, raws, dev, stager)

    def unpacking(self, flat):
        b = unpack(self, flat)
        tags.update(b.obs[..., 0].unique().tolist())
        steps.append(time.perf_counter())
        return b

    LearnerService._assemble_device = assembling
    RankChannel._unpack = unpacking
    last = {}
    publish = LearnerService._publish

    def recording(self, pub, state, ver=-1):
        last["params"] = torch.cat([t.reshape(-1) for t in tree_leaves(state.params)]).cpu()
        return publish(self, pub, state, ver)

    LearnerService._publish = recording
    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    L.LSTM_FWD_LAUNCHES = L.LSTM_BWD_LAUNCHES = 0
    svc = LearnerService(cfg, handles, model_port=int(args["--model-port"]),
                         stat_array=[0.0] * STAT_SLOTS, max_updates=MH_UPDATES,
                         stop_event=threading.Event())
    try:
        svc.run()
    finally:
        stop.set()
        feeder.join(10)
    params = svc.state.params if getattr(svc, "state", None) is not None else None
    if params is not None:
        last["params"] = torch.cat([t.reshape(-1) for t in tree_leaves(params)]).cpu()
    gaps = np.diff(steps[1:]) if len(steps) > 2 else np.array([float("nan")])
    res = dict(rank=rank, host=host, world=svc.mesh.world, backend=svc.mesh.backend,
               device=str(svc.device), updates=svc.n_updates,
               lstm_fwd_launches=L.LSTM_FWD_LAUNCHES, lstm_bwd_launches=L.LSTM_BWD_LAUNCHES,
               tags=sorted(tags), rows=len(assembled) and int(assembled[0]["obs"].shape[0]),
               ms_per_update=float(np.median(gaps)) * 1e3,
               staged_bytes=svc.mesh.staged_bytes)
    torch.save({"params": last.get("params"), "assembled": assembled[:MH_UPDATES]},
               out / f"mh{rank}.pt")
    (out / f"mh{rank}.json").write_text(json.dumps(res))


def multihost_ranks_phase() -> dict:
    """(M1)'s ranks, run to their end: MH_HOSTS hosts of MH_LOCAL ranks
    each, every rank a process sharing the one card over gloo (``python3
    chip_smoke.py --mh-rank R ...``). Returns the folder of their results
    and the seconds from spawn; :func:`multihost_phase` checks them. They
    run beside the smoke's own phases (they count no context and launch
    nothing in this process)."""
    import shutil

    rdir = ROOT / ".chip_scratch" / "mh-ranks"
    shutil.rmtree(rdir, ignore_errors=True)
    rdir.mkdir(parents=True)
    world = MH_HOSTS * MH_LOCAL
    coord = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mh-rank", str(r), "--coord", coord,
         "--model-port", str(free_port()), "--out", str(rdir)],
        cwd=ROOT, env=dict(os.environ, LOCAL_RANK=str(r % MH_LOCAL),
                           LOCAL_WORLD_SIZE=str(MH_LOCAL)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    t0 = time.perf_counter()
    codes, deadline = [], time.monotonic() + MH_TIMEOUT_S
    for r, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            codes.append(p.returncode)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
            codes.append(None)
        if codes[-1] != 0:
            print("\n".join(f"  mh rank {r}| {ln}" for ln in log.splitlines()[-15:]), flush=True)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    if any(c != 0 for c in codes):
        fail(f"(M1) the {world} multihost ranks exited {codes}")
    return dict(rdir=rdir, wall_s=wall)


def multihost_phase(card: str, run: dict) -> dict:
    """(M1) the multihost learner on hosts of several ranks (run earlier by
    :func:`multihost_ranks_phase`): each host's rank 0 sampling only its own
    storage and scattering the rows over its host-local group. B1/B2 on
    every rank = updates x K_epoch; every rank trained only on its host's
    rows; every rank ends on the same params, which equal one card's plain
    train step on the global batches (each host's batch in host order) at
    tests/test_parallel.py's bars, stepped here. Its ms per update is
    host-staged gloo on one card: no scaling number."""
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.types import Batch

    rdir, wall, world = run["rdir"], run["wall_s"], MH_HOSTS * MH_LOCAL
    docs = [json.loads((rdir / f"mh{r}.json").read_text()) for r in range(world)]
    blobs = [torch.load(rdir / f"mh{r}.pt", weights_only=False) for r in range(world)]
    want = MH_UPDATES * Config().K_epoch
    for d in docs:
        if (d["world"], d["updates"]) != (world, MH_UPDATES):
            fail(f"(M1) rank {d['rank']}: world {d['world']}, updates {d['updates']}")
        if (d["lstm_fwd_launches"], d["lstm_bwd_launches"]) != (want, want):
            fail(f"(M1) rank {d['rank']}: B1/B2 launches {d['lstm_fwd_launches']}/"
                 f"{d['lstm_bwd_launches']}, want updates x K_epoch = {want}")
        if d["tags"] != [float(d["host"])]:
            fail(f"(M1) rank {d['rank']} of host {d['host']} trained on rows of hosts {d['tags']}")
    if not all(b["params"] is not None and torch.equal(b["params"], blobs[0]["params"])
               for b in blobs):
        fail("(M1) the ranks hold different params")
    leaders = [blobs[h * MH_LOCAL]["assembled"] for h in range(MH_HOSTS)]
    cfg = Config.from_dict(MH_CFG)
    _f, state, step = get_algo(cfg.algo).build(cfg, torch.Generator().manual_seed(0),
                                               device="cuda")
    for k in range(MH_UPDATES):
        glob = {f: np.concatenate([h[k][f] for h in leaders]) for f in leaders[0][k]}
        state, _m = step(state, Batch.from_mapping(glob, device="cuda"))
    from tpu_rl_torch.utils.tree import tree_leaves

    mine = torch.cat([t.reshape(-1) for t in tree_leaves(state.params)])
    share = close_to(blobs[0]["params"].cuda(), mine, DP_PARAM_TOL)
    if not share <= 1.0:
        fail(f"(M1) the pod vs one card's steps on the global batches: {share} of the bar")
    rec = dict(hosts=MH_HOSTS, local_ranks=MH_LOCAL, updates=MH_UPDATES, ranks=docs,
               vs_one_card_share_of_bar=share, wall_s=wall,
               ms_per_update=max(d["ms_per_update"] for d in docs))
    for d in docs:
        print(f"(M1) rank {d['rank']}/{world} (host {d['host']}, {d['backend']} on "
              f"{d['device']}): {d['updates']} updates, B1/B2 launches {d['lstm_fwd_launches']}/"
              f"{d['lstm_bwd_launches']} (= updates x K_epoch), rows from hosts {d['tags']}, "
              f"{d['ms_per_update']:.4f} ms/update, host-staged {d['staged_bytes']} bytes "
              f"[{card}]", flush=True)
    print(f"(M1) {MH_HOSTS} hosts x {MH_LOCAL} ranks on one card over gloo vs one card's plain "
          f"steps on the global batches: {share:.4f} of tests/test_parallel.py's params bar; "
          f"{wall:.1f} s from spawn (no scaling number) [{card}]", flush=True)
    return rec


def population_main(argv: list[str]) -> None:
    """The (PBT) controller process (``--population CFG.json --out
    FILE``): ``PopulationController`` with member 0 poisoned
    (lr PBT_POISON_LR). It opens no CUDA context; its members do."""
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.population.controller import PopulationController

    args = dict(zip(argv[0::2], argv[1::2]))
    cfg = Config.from_json(args["--population"])
    ctrl = PopulationController(cfg, max_updates=PBT_UPDATES,
                                initial_values={0: {"lr": PBT_POISON_LR}})
    # every member incarnation's newest counters, keyed by its pid (a
    # respawned member's telemetry.json is rewritten by its next process)
    incarnations: dict = {}
    scrape = ctrl._scrape

    def watching(m):
        scrape(m)
        for src in telemetry_sources(Path(m.dir)):
            ran = metric(src, "colocated-updates-run")
            if ran is not None:
                fwd = metric(src, "colocated-lstm-fwd-launches")
                bwd = metric(src, "colocated-lstm-bwd-launches")
                incarnations[f"{m.idx}:{src['pid']}"] = dict(
                    member=m.idx, pid=src["pid"], updates_run=int(ran),
                    lstm_fwd_launches=-1 if fwd is None else int(fwd),
                    lstm_bwd_launches=-1 if bwd is None else int(bwd))

    ctrl._scrape = watching
    doc = ctrl.run()
    doc["incarnations"] = list(incarnations.values())
    doc["cuda_initialized"] = torch.cuda.is_initialized()
    Path(args["--out"]).write_text(json.dumps(doc))
    raise SystemExit(0 if doc["ok"] else 1)


def population_phase(card: str) -> dict:
    """(PBT) a population of PBT_K colocated PPO members on the card at
    the default config, member 0 poisoned: its controller a process of its
    own (``python3 chip_smoke.py --population ...``) holding no CUDA
    context, each member one (nvidia-smi's count: this process and the
    members; /proc fds: the card's node in each member, none in the
    controller); at least one exploit, whose loser resumes the copied
    committed checkpoint at a bumped run epoch; B1/B2 in each member
    process = its updates run x K_epoch, read from its telemetry by the
    controller at every scrape (every incarnation of a member)."""
    import tempfile

    from tpu_rl_torch.config import Config

    rdir = Path(tempfile.mkdtemp(prefix="chip_smoke_pbt_"))
    cfg = Config(**dict(
        TRAIN_CFG, result_dir=str(rdir), model_save_interval=PBT_INTERVAL // 4,
        loss_log_interval=10, telemetry_interval_s=0.25, supervise_poll_s=0.25,
        pop_spec=f"lr:log[1e-4,1e-3] interval={PBT_INTERVAL}u k={PBT_K} quantile=0.5",
        pop_seed=3))
    cfg_path = rdir / "population-config.json"
    cfg.to_json(cfg_path)
    out_path = rdir / "population-doc.json"
    t0 = time.perf_counter()
    ctl = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--population", str(cfg_path),
         "--out", str(out_path)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    contexts = None
    log_lines: list[str] = []
    reader = threading.Thread(target=lambda: log_lines.extend(ctl.stdout), daemon=True)
    reader.start()
    deadline = time.monotonic() + PBT_TIMEOUT_S
    while ctl.poll() is None and time.monotonic() < deadline:
        # a process opens the card's node before its context shows in
        # nvidia-smi: keep the sample with the most contexts while every
        # member holds the node
        members = []
        for p in children_of(ctl.pid):
            try:
                if "spawn_main" in Path(f"/proc/{p}/cmdline").read_text(errors="ignore"):
                    members.append(p)
            except OSError:
                pass
        if len(members) == PBT_K and all(card_fds(p) for p in members):
            pids = cuda_pids()
            if contexts is None or len(pids or ()) > len(contexts["pids"] or ()):
                contexts = dict(pids=pids, controller_fds=card_fds(ctl.pid),
                                member_fds={p: card_fds(p) for p in members})
        time.sleep(0.5)
    if ctl.poll() is None:
        for p in [ctl.pid, *subtree(ctl.pid)]:  # the controller and its members
            try:
                os.kill(p, signal.SIGKILL)
            except ProcessLookupError:
                pass
        ctl.wait()
        fail(f"(PBT) the population did not finish in {PBT_TIMEOUT_S} s: {log_lines[-20:]}")
    reader.join(10)
    wall = time.perf_counter() - t0
    if ctl.returncode != 0 or not out_path.exists():
        fail(f"(PBT) the controller exited {ctl.returncode}: {''.join(log_lines[-20:])}")
    doc = json.loads(out_path.read_text())
    if contexts is None:
        fail("(PBT) never saw every member holding the card at once")
    if doc["cuda_initialized"] or contexts["controller_fds"]:
        fail(f"(PBT) the controller holds a CUDA context: {contexts}")
    if contexts["pids"] is None or len(contexts["pids"]) != 1 + PBT_K:
        fail(f"(PBT) nvidia-smi counts {contexts['pids']} contexts, want this process and "
             f"{PBT_K} members")
    if doc["counts"]["exploits"] < 1:
        fail(f"(PBT) no exploit: {doc['counts']}")
    events = [json.loads(x) for x in (rdir / "population.jsonl").read_text().splitlines()]
    exploits = [e for e in events if e["ev"] == "exploit"]
    e0 = exploits[-1]  # a member's last exploit is the one its process resumes
    resumes = [json.loads(x) for x in (rdir / f"member-{e0['loser']}" / "learner_resume.jsonl")
               .read_text().splitlines()]
    if not any(r["idx"] == e0["dst_idx"] and r["epoch"] == e0["epoch"] + 1 for r in resumes):
        fail(f"(PBT) the loser never resumed the copied checkpoint: {e0} {resumes}")
    # each member process counts its own launches: every incarnation the
    # controller scraped, and their sums a member
    k_epoch = cfg.K_epoch
    for inc in doc["incarnations"]:
        want = inc["updates_run"] * k_epoch
        if (inc["lstm_fwd_launches"], inc["lstm_bwd_launches"]) != (want, want):
            fail(f"(PBT) member {inc['member']} (pid {inc['pid']}): B1/B2 launches "
                 f"{inc['lstm_fwd_launches']}/{inc['lstm_bwd_launches']}, want updates run x "
                 f"K_epoch = {want}")
    members = {k: dict(incarnations=[i for i in doc["incarnations"] if i["member"] == k])
               for k in range(PBT_K)}
    for m in members.values():
        for key in ("updates_run", "lstm_fwd_launches", "lstm_bwd_launches"):
            m[key] = sum(i[key] for i in m["incarnations"])
    if not all(m["updates_run"] > 0 for m in members.values()):
        fail(f"(PBT) a member's telemetry shows no update: {members}")
    rec = dict(k=PBT_K, updates=PBT_UPDATES, wall_s=wall, counts=doc["counts"],
               exploits=exploits, members=members, contexts=contexts,
               leaderboard=doc["leaderboard"])
    print(f"(PBT) {PBT_K} colocated PPO members, 128 envs H 64, {PBT_UPDATES} updates each, "
          f"member 0 at lr {PBT_POISON_LR}: {wall:.1f} s from the controller's spawn; counts "
          f"{doc['counts']}; last exploit {e0['winner']} -> {e0['loser']} at generation "
          f"{e0['gen']} (committed idx {e0['src_idx']} copied as {e0['dst_idx']}, resumed at "
          f"epoch {e0['epoch'] + 1}); B1/B2 per member, summed over its processes, = updates "
          f"run x K_epoch: {members}; contexts {contexts} [{card}]", flush=True)
    return rec


# ------------------------------------------------- the operations planes
# (X1) a chaos cluster: cluster run (b)'s config (remote acting through B3,
# the shm hop) under tpu_rl's chaos-smoke plan (examples/chaos_smoke.py:
# a worker SIGKILL, rollout corruption at the storage edge, relay send
# delays) plus a 5 ms stall before every flush of the learner's service,
# run under the supervisor's loop (the chaos poll and the respawn).
CHAOS_RUN = dict(CLUSTER_RUNS[1][1], worker_step_sleep=0.0, rollout_lag_sec=30.0, time_horizon=100,
                 telemetry_interval_s=0.5, telemetry_stale_s=120.0, supervise_poll_s=0.5,
                 chaos_spec="kill:worker-0-1@t+6s,corrupt:rollout@p=0.02,"
                            "delay:manager@10ms@p=0.2,stall:inference@5ms",
                 chaos_seed=7)
CHAOS_UPDATES = 8  # tpu_rl's chaos smoke: 8
# (X2) the heal plane under data chaos: tpu_rl's heal smoke run 2
# (examples/heal_smoke.py: its DEFAULT_SPEC and healing config, the small
# config of tests/conftest.py, 10 updates), the learner on the card. One
# divergence: the workers keep tpu_rl's default throttle (worker_step_sleep
# 0.05 s) where tpu_rl's smoke sets 0. The port's learner starts training at
# once, where tpu_rl's first jit holds it for seconds: unthrottled, it spends
# its whole rollback budget within a second of the logp poison and the run
# ends before worker 1's poison window closes, so it never un-quarantines.
HEAL_SPEC = ("nan:rollout@p=0.4@t+4s@for=6s@wid=1,spike:rollout@p=0.2@t+4s@for=6s@wid=1,"
             "nan:logp@p=0.5@t+2s@for=25s@wid=0")
HEAL_RUN = dict(env="CartPole-v1", algo="PPO", hidden_size=16, seq_len=5, batch_size=8,
                buffer_size=32, obs_shape=(4,), action_space=2, worker_step_sleep=0.05,
                rollout_lag_sec=30.0, time_horizon=100, loss_log_interval=2,
                model_save_interval=2, ckpt_keep=4, telemetry_interval_s=0.5,
                telemetry_stale_s=120.0, supervise_poll_s=0.5, update_guard=True,
                watchdog_enabled=True, watchdog_nonfinite=2, max_rollbacks=10,
                rollback_window_s=600.0, ingress_validate=True, quarantine_strikes=3,
                quarantine_clear_s=2.0, chaos_seed=11)
HEAL_UPDATES = 10
OPS_TIMEOUT_S = 300.0
# (A1) the autopilot smoke (tpu_rl_torch/examples/autopilot_smoke.py) with
# its replicas on the card; its schedule is cut for the time limit
# (PERF.md §4): the first valley and shoulder shorter, the peak to 45 s;
# the falling shoulder and the last valley keep tpu_rl's 12 s and 55 s
# (scale-in needs 50 clean polls once the peak's burn has left the 15 s
# window, and the processes beside it slow the clean streak).
AUTOPILOT_SCHEDULE = [(20, 10), (120, 8), (205, 45), (120, 12), (20, 55)]
AUTOPILOT_TIMEOUT_S = 420.0


def beside_start(card: str, t_start: float) -> dict:
    """Start, on a thread, every phase whose processes hold the card, one
    after the other, beside the smoke's own phases (which launch kernels
    in this process only): first (A1) the autopilot smoke, and while it
    runs the phases that count no context, (F2) the load sweeps, the DP
    ranks over gloo, (M1)'s ranks, (S2) and (X2) the heal plane; then,
    each alone, those that count the card's contexts (nothing else may
    hold one): (X1) the chaos cluster, the cluster runs (a) and (b), the
    population (PBT), (F1) cluster run (d) and (P3) cluster run (c). A
    failed bar ends the thread; :func:`beside_failed` reads it between the
    smoke's own phases and :func:`beside_finish` waits for the thread."""
    st: dict = {"out": {}, "error": None}
    out = st["out"]
    print(f"cluster env source: {gym_stand_in()}", flush=True)
    steps = (
        ("A1 start", lambda: autopilot_start(card)),
        ("F2", lambda: fleet_sweeps_phase(card)),
        ("dp ranks", dp_ranks_phase),
        ("S2 start", sebulba_cli_start),
        ("M1 ranks", multihost_ranks_phase),
        ("S2", lambda: sebulba_cli_phase(card, out.pop("S2 start"))),
        ("X2", lambda: heal_phase(card)),
        ("A1", lambda: autopilot_finish(out.pop("A1 start"), card)),
        ("X1", lambda: chaos_cluster_phase(card)),
        ("cluster", lambda: cluster_phase(card)),
        ("population", lambda: population_phase(card)),
        ("F1", lambda: fleet_cluster_phase(card)),
        ("P3", lambda: cluster_run(*DP_CLUSTER_RUN, card, ranks=DP_RANKS)),
    )

    def run() -> None:
        for name, fn in steps:
            t0 = time.perf_counter()
            try:
                out[name] = fn()
            except (Exception, SystemExit) as e:  # noqa: BLE001 — fail() raises SystemExit here
                st["error"] = f"({name}) {type(e).__name__}: {e}"
                return
            print(f"phase {name} (beside the smoke's own phases): "
                  f"{time.perf_counter() - t0:.1f} s (at {time.perf_counter() - t_start:.1f} s)",
                  flush=True)

    st["thread"] = threading.Thread(target=run, name="beside", daemon=True)
    st["thread"].start()
    return st


def beside_failed(st: dict) -> None:
    """Fail the run at once if a phase on the thread has failed."""
    if st["error"] is not None:
        fail(f"a phase beside the smoke's own ones failed: {st['error']}")


def beside_finish(st: dict) -> dict:
    st["thread"].join()
    beside_failed(st)
    return st["out"]


def role_sum(srcs: list[dict], role: str, name: str) -> float:
    """A counter summed over every source of one role (a respawned
    process's last snapshot stays among them)."""
    return sum(metric(s, name) or 0 for s in srcs if s.get("role") == role)


def ops_cluster(tag: str, cfg_kw: dict, updates: int, watch_model: bool = False) -> dict:
    """One ``local_cluster`` under the supervisor's own loop (the chaos
    poll, respawns, its telemetry), to ``updates``: the learner's exit
    code, the supervisor's restarts, telemetry.json after the learner's
    closing snapshot, the audit files, each child's card nodes mid-run (and
    nvidia-smi's count), and, with ``watch_model``, every Model frame the
    learner broadcast: its versions and whether each leaf was finite."""
    import shutil

    from tpu_rl_torch.config import Config, MachinesConfig, WorkerMachine
    from tpu_rl_torch.runtime.env import probe_spaces
    from tpu_rl_torch.runtime.protocol import Protocol
    from tpu_rl_torch.runtime.runner import local_cluster
    from tpu_rl_torch.runtime.transport import MODEL_HWM, Sub

    rdir = ROOT / ".chip_scratch" / f"ops-{tag}"
    shutil.rmtree(rdir, ignore_errors=True)
    cfg = probe_spaces(Config.from_dict(dict(cfg_kw, result_dir=str(rdir))))
    base = free_block()
    machines = MachinesConfig(learner_port=base, workers=[WorkerMachine(num_p=2, port=base + 5)])
    frames: list[tuple[int, bool]] = []  # (version, every leaf finite)
    done = threading.Event()
    sub = Sub("127.0.0.1", machines.model_port, bind=False, hwm=MODEL_HWM) if watch_model else None

    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        else:
            yield np.asarray(tree)

    def watch_frames() -> None:
        while not done.is_set():
            for proto, payload in sub.drain(max_msgs=64):
                if proto == Protocol.Model:
                    frames.append((int(payload.get("ver", -1)),
                                   all(np.isfinite(x).all() for x in leaves(payload["actor"]))))
            done.wait(0.02)

    t0 = time.perf_counter()
    sup = local_cluster(cfg, machines, max_updates=updates)
    children = {c.name: c for c in sup.children}
    learner = children["learner"]
    ctx: dict = {}
    loop = threading.Thread(target=sup.loop, daemon=True)
    loop.start()
    watcher = threading.Thread(target=watch_frames, daemon=True) if sub is not None else None
    if watcher is not None:
        watcher.start()
    try:
        deadline = time.monotonic() + OPS_TIMEOUT_S
        while not sup.stop_event.is_set() and time.monotonic() < deadline:
            if not ctx and learner.proc.is_alive() and card_fds(learner.proc.pid):
                time.sleep(1.0)  # every child up and past its imports
                ctx = {"pids": cuda_pids(),
                       "fds": {n: card_fds(c.proc.pid) for n, c in children.items()
                               if c.proc.is_alive()}}
            time.sleep(0.25)
        if not sup.stop_event.is_set():
            fail(f"({tag}) the cluster did not finish within {OPS_TIMEOUT_S} s")
        loop.join(10)
        learner.proc.join(30)
        exitcode = learner.proc.exitcode
        wall = time.perf_counter() - t0
        # storage writes telemetry.json every half second: wait for the
        # learner's closing snapshot
        until = time.monotonic() + 20.0
        while time.monotonic() < until and not any(
                s.get("role") == "learner" and s.get("closing") for s in telemetry_sources(rdir)):
            time.sleep(0.25)
        time.sleep(1.0)  # and one more write, with every role's last snapshot
    finally:
        done.set()
        if watcher is not None:
            watcher.join(5)
            sub.close()
        sup.stop()
    srcs = telemetry_sources(rdir)
    lrn = next((s for s in srcs if s.get("role") == "learner" and s.get("closing")), None)
    if lrn is None:
        fail(f"({tag}) no closing snapshot of the learner: {[s.get('role') for s in srcs]}")

    def jsonl(name: str) -> list[dict]:
        path = rdir / name
        return [json.loads(x) for x in path.read_text().splitlines() if x.strip()] \
            if path.exists() else []

    return dict(exitcode=exitcode, wall_s=wall, srcs=srcs, lrn=lrn, K_epoch=cfg.K_epoch,
                restarts=sum(c.restarts for c in sup.children), ctx=ctx, frames=frames,
                chaos=jsonl("chaos.jsonl"), rollbacks=jsonl("learner_rollback.jsonl"))


def learner_launches(tag: str, run: dict, want_updates: int | None = None) -> dict:
    """B1/B2 in the learner = updates run x K_epoch (every step runs, a
    guarded one's result discarded), from its closing snapshot."""
    lrn = run["lrn"]
    ran = int(metric(lrn, "learner-updates-run") or 0)
    fwd = int(metric(lrn, "learner-lstm-fwd-launches") or 0)
    bwd = int(metric(lrn, "learner-lstm-bwd-launches") or 0)
    if want_updates is not None and int(metric(lrn, "learner-update-index", "gauges")) != want_updates:
        fail(f"({tag}) learner index {metric(lrn, 'learner-update-index', 'gauges')}, "
             f"want {want_updates}")
    if ran < 1 or (fwd, bwd) != (ran * run["K_epoch"], ran * run["K_epoch"]):
        fail(f"({tag}) B1/B2 launches {fwd}/{bwd}, want updates run {ran} x K_epoch "
             f"{run['K_epoch']}")
    return dict(updates_run=ran, lstm_fwd_launches=fwd, lstm_bwd_launches=bwd)


def chaos_cluster_phase(card: str) -> dict:
    """(X1) CHAOS_RUN to CHAOS_UPDATES: the learner exits 0 at exactly its
    budget; the SIGKILLed worker respawned and audited in chaos.jsonl;
    corruptions injected == frames rejected across the fleet, exactly; at
    least one delayed send and one stalled flush; B1/B2 = updates x
    K_epoch; B3 = warm-ups + flushes with no remote-acting fallback; only
    the learner holds a CUDA context."""
    run = ops_cluster("X1", CHAOS_RUN, CHAOS_UPDATES)
    srcs, lrn = run["srcs"], run["lrn"]
    if run["exitcode"] != 0:
        fail(f"(X1) the learner exited {run['exitcode']}")
    out = dict(wall_s=run["wall_s"], restarts=run["restarts"],
               **learner_launches("X1", run, CHAOS_UPDATES))
    injected = role_sum(srcs, "storage", "chaos-corrupted-frames")
    rejected = {r: role_sum(srcs, r, f"{r}-rejected-frames") for r in ("worker", "manager", "storage")}
    out.update(
        kills=role_sum(srcs, "supervisor", "chaos-process-kills"),
        corrupted=injected, rejected=rejected,
        delayed=role_sum(srcs, "manager", "chaos-delayed-frames"),
        stalls=metric(lrn, "inference-chaos-stalls"),
        fused_act_launches=int(metric(lrn, "inference-fused-act-launches") or 0),
        inference_warmups=int(metric(lrn, "inference-warmups") or 0),
        inference_flushes=int(metric(lrn, "inference-batches") or 0),
        fallbacks=role_sum(srcs, "worker", "worker-remote-fallbacks"),
        chaos_records=run["chaos"], contexts=run["ctx"])
    if run["restarts"] < 1 or out["kills"] < 1:
        fail(f"(X1) no supervised restart after the chaos kill: {out}")
    if [(r["ev"], r["action"], r["target"]) for r in run["chaos"]] != [("chaos", "kill", "worker-0-1")]:
        fail(f"(X1) chaos.jsonl: {run['chaos']}")
    if injected < 1 or injected != sum(rejected.values()):
        fail(f"(X1) corruptions injected {injected} != frames rejected {rejected}")
    if out["delayed"] < 1 or not out["stalls"]:
        fail(f"(X1) delayed sends {out['delayed']}, stalled flushes {out['stalls']}")
    if out["fused_act_launches"] != out["inference_warmups"] + out["inference_flushes"] \
            or out["inference_flushes"] == 0:
        fail(f"(X1) B3 launches {out['fused_act_launches']}, want warm-ups "
             f"{out['inference_warmups']} + flushes {out['inference_flushes']}")
    if out["fallbacks"]:
        fail(f"(X1) {out['fallbacks']} remote-acting fallbacks (local acting would hide B3)")
    holders = sorted(n for n, fds in run["ctx"].get("fds", {}).items() if fds)
    if holders != ["learner"] or len(run["ctx"].get("pids") or ()) != 2:
        fail(f"(X1) CUDA contexts mid-run: {run['ctx']} (want this process and the learner)")
    print(f"(X1) chaos cluster {CHAOS_RUN['chaos_spec']!r}: learner exit 0 at {CHAOS_UPDATES} "
          f"updates in {run['wall_s']:.1f} s, restarts {run['restarts']}, corruptions "
          f"{injected:.0f} == rejected {rejected}, delayed sends {out['delayed']:.0f}, stalled "
          f"flushes {out['stalls']:.0f}, B1/B2 {out['lstm_fwd_launches']}/"
          f"{out['lstm_bwd_launches']} = updates x K_epoch, B3 {out['fused_act_launches']} = "
          f"warm-ups {out['inference_warmups']} + flushes {out['inference_flushes']}, fallbacks "
          f"0, contexts {run['ctx']} [{card}]", flush=True)
    return out


def heal_phase(card: str) -> dict:
    """(X2) HEAL_RUN under HEAL_SPEC: the run ends cleanly; at least one
    rollback with a bumped epoch; worker 1 quarantined and released;
    rollout-channel injections == storage's poisoned frames, exactly; at
    least one guarded non-finite update (B2 ran on non-finite cotangents
    and returned); every Model frame the learner broadcast finite; B1/B2 =
    updates run x K_epoch. (tpu_rl's clean run, where the heal plane must
    do nothing, is cut for the time limit: PERF.md §4.)"""
    import shutil

    model_dir = ROOT / ".chip_scratch" / "ops-X2-models"
    shutil.rmtree(model_dir, ignore_errors=True)
    run = ops_cluster("X2", dict(HEAL_RUN, chaos_spec=HEAL_SPEC, model_dir=str(model_dir)),
                      HEAL_UPDATES, watch_model=True)
    srcs, lrn = run["srcs"], run["lrn"]
    if run["exitcode"] != 0:
        fail(f"(X2) the learner exited {run['exitcode']}")
    rec = dict(wall_s=run["wall_s"], **learner_launches("X2", run))
    rec.update(
        rollbacks=len(run["rollbacks"]), epochs=[r.get("epoch") for r in run["rollbacks"]],
        learner_rollbacks=metric(lrn, "learner-rollbacks"),
        nonfinite_updates=metric(lrn, "learner-nonfinite-updates"),
        injected=role_sum(srcs, "worker", "chaos-nan-injected")
        + role_sum(srcs, "worker", "chaos-spike-injected"),
        logp_injected=role_sum(srcs, "worker", "chaos-logp-nan-injected"),
        poisoned=role_sum(srcs, "storage", "storage-poisoned-frames"),
        quarantines=role_sum(srcs, "storage", "storage-quarantines"),
        unquarantines=role_sum(srcs, "storage", "storage-unquarantines"),
        quarantined_frames=role_sum(srcs, "storage", "storage-quarantined-frames"),
        episodes=role_sum(srcs, "worker", "worker-episodes"),
        model_frames=len(run["frames"]),
        nonfinite_model_frames=sum(1 for _v, ok in run["frames"] if not ok))
    if rec["model_frames"] < 1 or rec["nonfinite_model_frames"]:
        fail(f"(X2) Model frames seen {rec['model_frames']}, non-finite "
             f"{rec['nonfinite_model_frames']}")
    if rec["rollbacks"] < 1 or max(rec["epochs"]) < 1 or not rec["learner_rollbacks"]:
        fail(f"(X2) no rollback with a bumped epoch: {run['rollbacks']}")
    if rec["quarantines"] < 1 or rec["unquarantines"] < 1:
        fail(f"(X2) worker 1 quarantined {rec['quarantines']}, released {rec['unquarantines']}")
    if rec["injected"] < 1 or rec["injected"] != rec["poisoned"]:
        fail(f"(X2) rollout injections {rec['injected']} != poisoned {rec['poisoned']}")
    if rec["logp_injected"] < 1 or not rec["nonfinite_updates"]:
        fail(f"(X2) logp injections {rec['logp_injected']}, guarded non-finite updates "
             f"{rec['nonfinite_updates']}")
    if rec["episodes"] < 1:
        fail("(X2) the fleet produced no episode")
    print(f"(X2) heal plane {HEAL_SPEC!r}, {HEAL_UPDATES} updates: learner exit 0 in "
          f"{run['wall_s']:.1f} s; rollbacks {rec['rollbacks']} (epochs {rec['epochs']}); "
          f"guarded non-finite updates {rec['nonfinite_updates']}; rollout injections "
          f"{rec['injected']:.0f} == poisoned {rec['poisoned']:.0f} (logp "
          f"{rec['logp_injected']:.0f}); quarantines {rec['quarantines']:.0f}, released "
          f"{rec['unquarantines']:.0f}; Model frames {rec['model_frames']} all finite; B1/B2 "
          f"{rec['lstm_fwd_launches']}/{rec['lstm_bwd_launches']} = updates run "
          f"{rec['updates_run']} x K_epoch [{card}]", flush=True)
    return rec


def autopilot_start(card: str) -> dict:
    """(A1) start ``python -m tpu_rl_torch.examples.autopilot_smoke
    --device cuda`` (its controller a process of its own) and a thread
    that samples, while it runs, which of its children hold the card (its
    replicas) and whether it does; :func:`autopilot_finish` waits."""
    import tempfile

    rdir = Path(tempfile.mkdtemp(prefix="chip_smoke_autopilot_"))
    out_path = rdir / "autopilot-smoke.json"
    sched = ",".join(f"{r}:{s}" for r, s in AUTOPILOT_SCHEDULE)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_rl_torch.examples.autopilot_smoke", "--device", "cuda",
         "--base-port", str(free_block(14)), "--result-dir", str(rdir), "--schedule", sched,
         "--out", str(out_path)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    st = dict(proc=proc, out=out_path, t0=time.perf_counter(), log=[], seen={},
              controller_fds=[], max_holders=0)

    def sample() -> None:
        while proc.poll() is None:
            kids = subtree(proc.pid)
            holders = []
            for p in kids:
                if running(p):
                    st["seen"].setdefault(p, cmdline(p))
                    if card_fds(p):
                        holders.append(p)
            st["max_holders"] = max(st["max_holders"], len(holders))
            st["controller_fds"] = sorted(set(st["controller_fds"]) | set(card_fds(proc.pid)))
            time.sleep(0.5)

    st["reader"] = threading.Thread(target=lambda: st["log"].extend(proc.stdout), daemon=True)
    st["sampler"] = threading.Thread(target=sample, daemon=True)
    st["reader"].start()
    st["sampler"].start()
    return st


def autopilot_finish(st: dict, card: str) -> dict:
    """(A1) the autopilot smoke's own bars (it exits 0 only when all hold),
    and here: its controller process holds no CUDA context and opened
    none; its replicas held the card; each replica process's B3 launches =
    its warm-ups + flushes (its last telemetry snapshot) and > 0; no
    process it started is left."""
    proc = st["proc"]
    try:
        proc.wait(timeout=max(1.0, AUTOPILOT_TIMEOUT_S - (time.perf_counter() - st["t0"])))
    except subprocess.TimeoutExpired:
        for p in [proc.pid, *subtree(proc.pid)]:
            try:
                os.kill(p, signal.SIGKILL)
            except ProcessLookupError:
                pass
        proc.wait()
        fail(f"(A1) the autopilot smoke did not finish in {AUTOPILOT_TIMEOUT_S} s: "
             f"{''.join(st['log'][-20:])}")
    st["reader"].join(10)
    st["sampler"].join(10)
    wall = time.perf_counter() - st["t0"]
    tail = "".join(st["log"][-30:])
    if proc.returncode != 0 or not st["out"].exists():
        fail(f"(A1) the autopilot smoke exited {proc.returncode}: {tail}")
    res = json.loads(st["out"].read_text())
    doc, snaps = res["doc"], res["replicas"]
    if res["failures"]:
        fail(f"(A1) {res['failures']}")
    if doc["cuda_initialized"] or st["controller_fds"]:
        fail(f"(A1) the controller process holds a CUDA context: {st['controller_fds']}")
    if st["max_holders"] < 2:
        fail(f"(A1) at most {st['max_holders']} replica processes held the card at once")
    b3 = {}
    for pid, snap in snaps.items():
        rid = f"inference-{snap.get('rid', '?')}"
        launches = int(metric(snap, "inference-fused-act-launches") or 0)
        warm = int(metric(snap, "inference-warmups") or 0)
        flushes = int(metric(snap, "inference-batches") or 0)
        b3[f"{rid} (pid {pid})"] = dict(launches=launches, warmups=warm, flushes=flushes,
                                        stalls=metric(snap, "inference-chaos-stalls"))
        if launches != warm + flushes or launches < 1:
            fail(f"(A1) replica {rid} pid {pid}: B3 launches {launches}, want warm-ups {warm} + "
                 f"flushes {flushes}")
    time.sleep(1.0)
    left = {p: c for p, c in st["seen"].items() if running(p)}
    if left:
        fail(f"(A1) processes of the autopilot smoke left running: {left}")
    actions = doc["actions"]
    rec = dict(wall_s=wall, schedule=AUTOPILOT_SCHEDULE, overall=doc["overall"],
               floors=[s["version_floor"] for s in doc["stages"]],
               stages=[{k: s.get(k) for k in ("offered_rps", "achieved_rps", "p50_ms", "p99_ms",
                                                "hedges", "failovers", "reprobes")}
                       | {"slo_ok": (s.get("slo") or {}).get("ok")} for s in doc["stages"]],
               actions=[(a["action"], a["from"], a["to"]) for a in actions],
               autopilot=doc["autopilot"], b3_by_replica=b3, max_replicas_on_card=st["max_holders"],
               processes_started=len(st["seen"]))
    print(f"(A1) autopilot smoke, schedule {AUTOPILOT_SCHEDULE}: {wall:.1f} s; overall "
          f"{doc['overall']}; floors {rec['floors']}; actions {rec['actions']}; final replicas "
          f"{doc['autopilot'].get('replicas')}; stages {rec['stages']}; B3 by replica process "
          f"(launches = warm-ups + flushes) {b3}; at most {st['max_holders']} replicas on the "
          f"card at once, none in the controller; {len(st['seen'])} processes started, none "
          f"left [{card}]", flush=True)
    return rec


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs one CUDA card")
    try:
        import tpu_rl_torch
    except ImportError as e:
        fail(f"the tpu_rl_torch package is not beside this script: {e}")
    if Path(tpu_rl_torch.__file__).resolve().parent.parent != ROOT:
        fail(f"tpu_rl_torch was imported from {tpu_rl_torch.__file__}, not from {ROOT}")
    if any(m.split(".")[0] in ("jax", "flax", "tpu_rl") for m in sys.modules):
        fail("JAX or the JAX package was imported")
    adopt_orphans()
    t_start = time.perf_counter()

    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(
        f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}",
        flush=True,
    )

    from tpu_rl_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.3f} s", flush=True)
    for line in build.resource_usage():
        print(f"ptxas: {line}", flush=True)

    laps = [time.perf_counter()]
    beside: dict | None = None

    def lap(name: str) -> None:
        """Seconds since the previous phase ended (where the limit goes)."""
        laps.append(time.perf_counter())
        print(f"phase {name}: {laps[-1] - laps[-2]:.1f} s (at {laps[-1] - t_start:.1f} s)",
              flush=True)
        if beside is not None:
            beside_failed(beside)

    # The kernels' own rows first, while nothing else runs on the card:
    # their times go into the kernels line.
    shapes = kernel_phase()
    lap("shapes")
    lstm_rows = lstm_phase()
    lap("lstm_rows")
    attn_rows = attention_phase()
    lap("attn_rows")
    blockwise_rows = blockwise_phase(card)
    lap("blockwise_rows")
    mixed_dot_rows = mixed_dot_check(card)
    lap("mixed_dot_rows")
    # From here on every phase whose processes hold the card runs on a
    # thread, one after the other (beside_start); this process runs its own
    # phases beside them, and they launch their kernels here only (the time
    # limit, PERF.md §4).
    beside = beside_start(card, t_start)
    serving = serve_phase()
    lap("serving")
    serving_checks(serving, "serving", card)
    profiled = serve_phase(profile=True)
    lap("profiled")
    serving_checks(profiled, "serving (profiled)", card)
    serving_b3_time(shapes, profiled, card)
    quant_policy = quant_policy_check(card)
    lap("quant_policy")
    quant_serving = {}
    for mode in SERVE_DTYPES:
        quant_serving[mode] = serve_phase(dtype=mode, mixes=SERVE_MIXES[:1])
        serving_checks(quant_serving[mode], f"serving {mode}", card)
    lap("quant_serving")

    training = train_phase(card)
    lap("training")
    learning = learn_phase(card)
    lap("learning")
    wide_training = wide_lstm_train_phase(card)
    lap("wide_training")
    wide_impala = wide_lstm_train_phase(card, "IMPALA")
    lap("wide_impala")
    bf16_ref = bf16_ref_phase(card)
    lap("bf16_ref")
    wide_bf16 = wide_lstm_train_phase(card, "IMPALA", "bfloat16")
    lap("wide_bf16")
    print(
        "IMPALA@wide-lstm f32 vs bf16 (this run): "
        + " ".join(
            f"{k} {wide_impala[k] if wide_impala[k] is None else round(wide_impala[k], 6)} / "
            f"{wide_bf16[k] if wide_bf16[k] is None else round(wide_bf16[k], 6)}"
            for k in ("ms_per_update", "enqueue_ms", "device_ms_per_update", "transitions_per_s",
                      "gemm_device_share", "b1_b2_device_share", "vtrace_device_share")
        )
        + f" [{card}]",
        flush=True,
    )
    bf16_colocated = bf16_colocated_phase(card)
    lap("bf16_colocated")
    checkpointing = checkpoint_phase(card)
    lap("checkpointing")
    ref_rows = {name: ref_row_phase(name, card) for name in REF_ROWS}
    lap("ref_rows")
    colocated_algos = colocated_algos_phase(card)
    lap("colocated_algos")
    impala_learning = impala_learn_phase(card)
    lap("impala_learning")
    tf_training = tf_train_phase(card)
    lap("tf_training")
    tf_algos = tf_algos_phase(card)
    lap("tf_algos")
    tf_colocated = tf_colocated_phase(card)
    lap("tf_colocated")
    tf_colocated_flash = tf_colocated_phase(card, "flash")
    lap("tf_colocated_flash")
    tf_serving = {m: tf_serve_phase(card, m) for m in ("f32", *SERVE_DTYPES)}
    tf_serving["f32 compute"] = tf_serve_phase(card, "f32", "float32")
    lap("tf_serving")
    telemetry = telemetry_phase(card)
    lap("telemetry")
    inline = inline_sac_phase(card, lstm_rows)
    lap("inline")
    feeds = replay_feed_phase(card)
    lap("feeds")
    reports = report_compare_check(telemetry["colocated"].pop("result_dir"), card)
    lap("reports")
    out = beside_finish(beside)
    beside = None
    lap("the phases beside (the rest of them)")
    cluster, population = out["cluster"], out["population"]
    ops = {k: out[k] for k in ("A1", "X2", "X1")}
    fleet = {"cluster": out["F1"], **out["F2"], "sharded": sharded_phase(card)}
    lap("sharded")
    # the in-process halves of the phases whose ranks ran beside: world
    # size 1 over NCCL, and the checks of the ranks against it
    dp = dp_phase(card, out["dp ranks"], out["P3"])
    lap("dp")
    sp = sp_phase(card, dp, attn_rows, blockwise_rows)
    lap("sp")
    sebulba = sebulba_phase(card)
    lap("sebulba")
    multihost = multihost_phase(card, out["M1 ranks"])
    sebulba_cli = out["S2"]
    lap("multihost")
    # every process the run started has ended by now; any that has not is
    # stopped here and named
    leftovers = stop_leftovers()
    print(f"leftover processes stopped at the end of the run: {len(leftovers)} {leftovers}",
          flush=True)

    main_path = [r for r in shapes if r["shape"]["H"] == 256 and r["shape"]["D"] == 4]
    top = next(r for r in main_path if r["shape"]["rows"] == 256)
    small = next(r for r in main_path if r["shape"]["rows"] == 8)
    kernels = [dict(
        name="fused_act",
        route="cuda",
        source="tpu_rl_torch/csrc/fused_act.cu",
        replaces="tpu_rl/ops/pallas_act.py:52",
        launches=serving["launches"],
        max_abs_err=max(r["max_abs_err"] for r in main_path),
        ms=top["kernel_ms"],
        plain_ms=top["plain_ms"],
        bound_ms=top["bound_ms"],
        bound_by=top["bound_by"],
        library_ms=None,  # no single PyTorch call computes the fused act step
        unfused_ms=top["unfused_ms"],
        act_ms=top["act_ms"],
        at=top["shape"],
        # the 8-row bucket, where mix 1's deadline-bound flushes land
        ms_8rows=small["kernel_ms"],
        plain_ms_8rows=small["plain_ms"],
        bound_ms_8rows=small["bound_ms"],
        bound_by_8rows=small["bound_by"],
        # counted where the wrapper launches; B3's device time over the
        # profiled serving run and its launches (null if the profiler saw
        # no kernel)
        launches_by_bucket=serving["launches_by_rows"],
        # the same path serving bf16 and int8 weights (widened before B3)
        launches_by_inference_dtype={"f32": serving["launches"],
                                     **{m: r["launches"] for m, r in quant_serving.items()}},
        # the same path with the telemetry plane on (mix 1)
        launches_telemetry_serving=telemetry["serving"]["launches"],
        serving_device_ms=profiled["b3_device_ms"],
        serving_device_launches=profiled["launches"],
        # the distributed runtime: every worker's act step served by the
        # learner's InferenceService (cluster run (b); warm-ups + flushes)
        launches_by_path={
            "cluster (b) remote acting": cluster["b"]["fused_act_launches"],
            # the fleet: each replica's own count (warm-ups + flushes), the
            # learner's replica 0 and the inference-<i> children; each
            # loadgen replica; each device of the sharded replica
            **{f"fleet cluster (d) replica {rid}": b["launches"]
               for rid, b in fleet["cluster"]["fleet"]["b3"].items()},
            **{f"loadgen {name} replica {rid}": b["launches"]
               for name in ("kill", "curve")
               for rid, b in fleet[f"loadgen_{name}"]["b3_by_replica"].items()},
            **{f"sharded replica ({n}) device {dev}": v
               for n in ("1_devices", "2_devices") if n in fleet["sharded"]
               for dev, v in fleet["sharded"][n]["b3_by_device"].items()},
            # the operations planes: the chaos cluster's learner service
            # (stalled flushes), each autopilot replica process
            "(X1) chaos cluster remote acting": ops["X1"]["fused_act_launches"],
            **{f"(A1) autopilot replica {rid}": b["launches"]
               for rid, b in ops["A1"]["b3_by_replica"].items()},
        },
        card=card,
        shapes=shapes,
    )]
    lstm_main = lstm_rows[0]  # (128, 5, 64), the training path's shape
    for name, replaces, launches in (
        ("lstm_fwd", "tpu_rl/ops/pallas_lstm.py:99", training["lstm_fwd_launches"]),
        ("lstm_bwd", "tpu_rl/ops/pallas_lstm.py:373", training["lstm_bwd_launches"]),
    ):
        r = lstm_main[name]
        kernels.append(dict(
            name=name,
            route="cuda",
            source=f"tpu_rl_torch/csrc/{name}.cu",
            replaces=replaces,
            launches=launches,
            max_abs_err=max(
                (x["fwd_err"] if name == "lstm_fwd" else max(x["bwd_err"], x["function_err"]))
                for x in lstm_rows
            ),
            ms=r["ms"],
            plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"],
            bound_by=r["bound_by"],
            # No single PyTorch call computes a keep-masked LSTM with
            # per-row, per-step carry resets (cuDNN's LSTM resets nothing
            # and has two biases).
            library_ms=None,
            at=lstm_main["shape"],
            # this kernel's launches on each path of the run, counted the same way
            launches_by_path={
                "training PPO": launches,
                "wide PPO": wide_training[f"{name}_launches"],
                "wide IMPALA": wide_impala[f"{name}_launches"],
                **{f"{k}@ref": v[f"{name}_launches"] for k, v in ref_rows.items()},
                **{f"colocated {k}": v[f"{name}_launches"] for k, v in colocated_algos.items()},
                "learning PPO": learning["lstm_launches"][name],
                "learning IMPALA": impala_learning["lstm_launches"][name],
                "checkpointed colocated PPO": checkpointing[f"{name}_launches"],
                # bf16 compute runs the scan, as in tpu_rl: 0 on these paths
                "IMPALA@ref bf16": bf16_ref[f"{name}_launches"],
                "wide IMPALA bf16": wide_bf16[f"{name}_launches"],
                "colocated PPO bf16": bf16_colocated[f"{name}_launches"],
                # the colocated loop with the telemetry plane on
                "telemetry colocated PPO": telemetry["colocated"][f"{name}_launches"],
                "telemetry wide IMPALA": telemetry["wide"][f"{name}_launches"],
                # the inline trainer: the whole learning run, and
                # SAC on CartPole
                **{f"inline {r['stats']['algo']} ({r['stats']['env']}, {r['stats']['updates']} "
                   f"updates)": r[f"{name}_launches"] for r in inline["runs"].values()},
                # the learner feed onto the card, each run
                **{f"feed {tag} {kind}": r[kind][f"{name}_launches"]
                   for tag, r in feeds.items() for kind in ("sync", "prefetch")},
                # the distributed runtime's learner child, each run
                **{f"cluster ({tag}) {'remote' if r['config']['act_mode'] == 'remote' else 'local'}"
                   f" acting PPO": r[f"{name}_launches"] for tag, r in cluster.items()},
                "fleet cluster (d) PPO": fleet["cluster"][f"{name}_launches"],
                # the data-parallel paths: world size 1 over NCCL, and each
                # of DP_RANKS ranks sharing the card (counted in that rank)
                "DP IMPALA@wide-lstm world 1": dp["p1_world1"]["dp"][f"{name}_launches"],
                "DP colocated PPO world 1": dp["p2_world1"]["dp"][f"{name}_launches"],
                **{f"DP IMPALA@wide-lstm rank {d['rank']}/{DP_RANKS}": d["p1"][f"{name}_launches"]
                   for d in dp["two_ranks"]["ranks"]},
                **{f"DP colocated PPO rank {d['rank']}/{DP_RANKS}": d["p2"][f"{name}_launches"]
                   for d in dp["two_ranks"]["ranks"]},
                **{f"cluster (c) DP learner rank {r}/{DP_RANKS}": int(x[0 if name == "lstm_fwd" else 1])
                   for r, x in enumerate(dp["cluster"]["launches_by_rank"])},
                # the training topology: the Sebulba learner lane, every rank
                # of the multihost learner, every population member's last
                # incarnation (each counted in its own process)
                "sebulba learner lane PPO": sebulba[f"{name}_launches"],
                **{f"multihost learner rank {d['rank']}/{MH_HOSTS * MH_LOCAL} (host {d['host']})":
                   d[f"{name}_launches"] for d in multihost["ranks"]},
                **{f"population member {k} ({m['updates_run']} updates run over "
                   f"{len(m['incarnations'])} processes)": m[f"{name}_launches"]
                   for k, m in population["members"].items()},
                # the operations planes: the chaos cluster's learner, and the
                # heal plane's (every update run, guarded ones included: B2
                # on non-finite cotangents)
                "(X1) chaos cluster PPO": ops["X1"][f"{name}_launches"],
                f"(X2) heal plane under data chaos ({ops['X2']['updates_run']} updates run, "
                f"{ops['X2']['nonfinite_updates']:.0f} guarded)": ops["X2"][f"{name}_launches"],
            },
            # the inline trainer's shape (32,5,64), lstm_phase's row
            inline_ms=inline["kernel_ms"][name],
            inline_bound_ms=inline["bound_ms"][name],
            card=card,
            shapes=[dict(shape=x["shape"], **x[name]) for x in lstm_rows],
        ))
    # B4's two pairs of kernels, each at its main path's row (16, 2048, 8, 64):
    # bf16 (PPO-transformer@longctx-flash) and f32 (the same row at tpu_rl's
    # default f32 compute)
    f32_ref = tf_training["reference"]["float32 flash D=64"]
    for dtype, prefix, train in (("bfloat16", "flash_attn_tc", tf_training),
                                 ("float32", "flash_attn_f32", tf_training["flash_f32"])):
        rows = [x for x in attn_rows if x["shape"]["dtype"] == dtype]
        attn_main = next(x for x in rows if (x["shape"]["B"], x["shape"]["T"]) == (16, 2048))
        for name, errs in (("flash_attn_fwd", ("o", "lse")), ("flash_attn_bwd", ("dq", "dk", "dv"))):
            r = attn_main[name]
            count = name.replace("flash_attn", "flash") + "_launches"
            if dtype == "bfloat16":
                # this kernel's launches on each transformer path of the run,
                # counted the same way (blockwise attention runs none)
                by_path = {
                    "PPO longctx-flash": train[f"{name}_launches"],
                    "PPO longctx-blockwise": tf_training["blockwise"][f"{name}_launches"],
                    **{f"{a} longctx-flash": x["wide"][f"{name}_launches"]
                       for a, x in tf_algos.items()},
                    "colocated longcontext config (blockwise)": tf_colocated[f"{name}_launches"],
                    "colocated longcontext config (flash)": tf_colocated_flash[f"{name}_launches"],
                    "DP longctx-flash world 1": dp["p4_dp_flash_world1"][count],
                    # ring and Ulysses attention are plain PyTorch, as tpu_rl's:
                    # each rank's count over its calls
                    **{f"SP {impl} rank {d['rank']}/{DP_RANKS}": d["p4"][impl][count]
                       for d in dp["two_ranks"]["ranks"] for impl in ("ring", "ulysses")},
                }
            else:
                by_path = {
                    "PPO longctx-flash float32": train[f"{name}_launches"],
                    "PPO f32 flash step 8 x 256, D 64 (card vs CPU)": f32_ref[f"{name}_launches"],
                }
            kernels.append(dict(
                name=name if dtype == "bfloat16" else name.replace("flash_attn", prefix),
                route="cuda",
                source=f"tpu_rl_torch/csrc/{name.replace('flash_attn', prefix)}.cu",
                replaces="tpu_rl/parallel/sequence.py:608",
                launches=train[f"{name}_launches"],
                max_abs_err=max(x["errs"][e] for x in rows for e in errs),
                ms=r["ms"],
                plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"],
                bound_by=r["bound_by"],
                # scaled_dot_product_attention with the causal-and-segment mask
                # as a boolean attn_mask (forward; or the backward of its graph)
                library_ms=r["library_ms"],
                dtype=dtype,
                at=attn_main["shape"],
                tiles_visited=attn_main["tiles_visited"],
                tiles_causal=attn_main["tiles_causal"],
                plan_ms=attn_main["plan_ms"],
                launches_by_path=by_path,
                card=card,
                shapes=[dict(shape=x["shape"], checks=x["checks"], tiles_visited=x["tiles_visited"],
                             tiles_causal=x["tiles_causal"], **x[name])
                        for x in rows],
            ))
    print(json.dumps({"training": training, "wide_lstm_training": wide_training, "learning": {
        k: v for k, v in learning.items() if k != "scalars"
    }, "wide_impala_training": wide_impala, "wide_impala_bf16_training": wide_bf16,
        "mixed_dot": mixed_dot_rows, "impala_ref_bf16": bf16_ref,
        "colocated_ppo_bf16": bf16_colocated, "checkpoint": checkpointing,
        "serving_precision": quant_policy,
        "quantized_serving": {m: dict(mix1=r["mixes"][0], launches=r["launches"],
                                      flushes=r["flushes"], warmups=r["warmups"],
                                      param_bytes=r["param_bytes"])
                              for m, r in quant_serving.items()},
        "ref_rows": ref_rows,
        "colocated_algos": colocated_algos, "impala_learning": impala_learning,
        "transformer_training": tf_training, "transformer_colocated": tf_colocated,
        "transformer_colocated_flash": tf_colocated_flash,
        "blockwise_attention": blockwise_rows, "transformer_algos": tf_algos,
        "transformer_serving": tf_serving,
        "telemetry": telemetry, "inline": inline, "feeds": feeds,
        "report_compare": reports, "cluster": cluster, "fleet": fleet, "data_parallel": dp,
        "sequence_parallel": sp, "sebulba": sebulba, "sebulba_cli": sebulba_cli,
        "multihost": multihost, "population": population, "operations_planes": ops,
        "leftover_processes": leftovers}, default=str), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    if "--rank" in sys.argv:
        rank_main(sys.argv[1:])
    elif "--mh-rank" in sys.argv:
        mh_rank_main(sys.argv[1:])
    elif "--population" in sys.argv:
        population_main(sys.argv[1:])
    else:
        try:
            main()
        except BaseException:
            if ADOPTING:
                stop_leftovers()
            raise
