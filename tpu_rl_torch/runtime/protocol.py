"""Message kinds — the port's own copy of ``tpu_rl.runtime.protocol.Protocol``
(the enum only; the wire codec comes with the distributed slice)."""

from __future__ import annotations

import enum


class Protocol(enum.IntEnum):
    Model = 0  # learner -> workers: parameter broadcast
    Rollout = 1  # worker -> manager -> storage: one env step
    Stat = 2  # worker -> manager -> storage: episode reward
    RolloutBatch = 3  # one worker tick, all envs stacked
    # Centralized inference: worker -> server, one frame per worker tick
    # {"wid", "seq", "obs" (n, obs_dim), "first" (n,)}; the recurrent carry
    # stays on the server.
    ObsRequest = 4
    # The reply: {"seq", "act", "logits", "log_prob", "ver"} (+ "hx"/"cx"
    # pre-step carry rows for store_carry families).
    Act = 5
    Telemetry = 6  # periodic metrics snapshot
