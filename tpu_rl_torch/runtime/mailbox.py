"""Stat-mailbox slot layout: the one shm contract between storage and learner.

The port's own copy of ``tpu_rl.runtime.mailbox``, unchanged in behaviour.

The mailbox is a lock-free ``mp.Array("f", STAT_SLOTS)`` created by the
runner (reference ``main.py:324-326``): storage writes fleet aggregates,
the learner reads them at its loss-log tick. The slot indices used to be
magic numbers duplicated at both ends (``storage._relay_stat`` and
``learner_service._log_fleet_stat``) — they live here now so the two sides
cannot drift.

Write protocol: storage fills the data slots FIRST and flips
``SLOT_ACTIVATE`` last; the learner checks the flag, reads, and clears it.
The float array has no torn reads per-slot, and the activate ordering keeps
the learner from logging a half-updated window.

The first 7 slots are the REFERENCE-PARITY path (the first three slots are
the reference's 3-float mailbox). The telemetry plane (``tpu_rl_torch.obs``)
supersedes it in expressiveness but rides beside it, never replaces it.

Two durability slots (PR 9) ride outside the windowed-write protocol, each
with a single steady-state writer:

- ``SLOT_JOIN_REQ``: storage sets 1.0 when a NEW worker joins the
  membership table; the learner polls it, publishes current weights+ver
  immediately, and clears it. (Both sides write the one flag in opposite
  directions; the benign race — storage setting while the learner clears —
  loses one join nudge, which ``rebroadcast_idle_s`` covers anyway.)
- ``SLOT_RUN_EPOCH``: the learner writes ``epoch + 1.0`` once at startup
  (0.0 = unknown, so a zeroed fresh array reads as "no epoch yet"); storage
  ratchets its stale-frame fence from it. The mp.Array outlives child
  respawns, so a restarted storage re-learns the current epoch instantly —
  before any new-epoch frame could reach it — which is what makes
  stale-epoch rejection deterministic rather than a broadcast race.
"""

from __future__ import annotations

SLOT_GAME_COUNT = 0  # fleet global episode count
SLOT_MEAN_REW = 1  # windowed (STAT_WINDOW-episode) mean reward
SLOT_ACTIVATE = 2  # storage sets 1.0 after a write; learner clears
SLOT_REJECTED = 3  # corrupt-frame drops across every transport hop
SLOT_MODEL_LOADS = 4  # fleet total worker model reloads
SLOT_RELAY_DROPPED = 5  # manager drop-oldest evictions
SLOT_FORWARD_BYTES = 6  # manager -> storage forwarded wire bytes
SLOT_JOIN_REQ = 7  # storage: new member joined -> learner: push weights now
SLOT_RUN_EPOCH = 8  # learner's run epoch + 1 (0 = unknown); storage reads

STAT_SLOTS = 9
