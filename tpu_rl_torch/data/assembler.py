"""Reassemble interleaved per-step worker messages into fixed-length
training windows — the port of ``tpu_rl.data.assembler``, host code only.

- steps are keyed by episode id and buffered until ``seq_len`` accumulate,
  then emitted as a dict of ``(seq, width)`` float32 arrays;
- in-flight trajectories idle longer than ``lag_sec`` (since their last
  push) are dropped, and so are parked remnants;
- an episode that ends short of ``seq_len`` is parked; the next *new*
  episode splices onto the **shortest** parked remnant, re-marking
  ``is_fir = 1.0`` at the seam so losses mask the fake time adjacency.

Trajectories accumulate into preallocated ``(seq_len, width)`` buffers, one
row write per field per step; the filled buffer is the window.
:meth:`RolloutAssembler.push_tick` takes a whole worker tick (one clock read
and one stale scan); :func:`split_rollout_batch` + per-step
:meth:`RolloutAssembler.push` is the reference path it must equal bit for
bit.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from tpu_rl_torch.data.layout import BatchLayout
from tpu_rl_torch.types import BATCH_FIELDS


class Trajectory:
    """Per-episode columnar accumulator:
    preallocated ``(seq_len, width)`` float32 buffers filled row-by-row, with
    a last-activity timestamp instead of a creation timestamp. When the last
    row fills, ``cols`` is emitted as the window itself — no stacking pass."""

    __slots__ = ("cols", "n", "last_push", "traces", "ver")

    def __init__(self, cols: dict[str, np.ndarray], last_push: float = 0.0):
        self.cols = cols
        self.n = 0
        self.last_push = last_push
        # Rollout-lineage trace ids of sampled ticks that contributed rows
        # (tpu_rl_torch.obs): None until the first sampled tick touches this
        # trajectory, so untraced runs never allocate the list.
        self.traces = None
        # Policy version of the OLDEST contributing tick (-1 = unknown):
        # the staleness sidecar the learning-dynamics plane bins on
        # (tpu_rl_torch.obs.learn). Min, not last — a spliced window's staleness
        # is its worst row's, the conservative bound.
        self.ver = -1

    def __len__(self) -> int:
        return self.n


def stack_window(steps: list[dict]) -> dict[str, np.ndarray]:
    """steps (list of per-step field dicts) -> dict of (seq, width) arrays.
    Reference implementation only — the assembler writes rows straight into each
    trajectory's preallocated buffers instead of stacking at emit."""
    return {
        k: np.stack([np.asarray(s[k], np.float32) for s in steps])
        for k in BATCH_FIELDS
    }


def split_rollout_batch(payload: dict) -> list[dict]:
    """One worker tick's stacked transitions -> per-step dicts for
    :meth:`RolloutAssembler.push`.

    Inverse of a worker's per-tick stacking (``Protocol.RolloutBatch``): every batch field is an ``(n_envs, width)``
    array, ``id`` is a list of per-env episode ids, ``done`` an ``(n_envs,)``
    array. Row views (no copies). Reference implementation for the ingest
    path — the hot path is :meth:`RolloutAssembler.push_tick`, which skips
    these intermediate dicts entirely."""
    ids = payload["id"]
    done = np.asarray(payload["done"])
    ver = payload.get("ver")
    return [
        {
            **{f: payload[f][i] for f in BATCH_FIELDS},
            "id": ids[i],
            "done": bool(done[i]),
            **({"ver": ver} if isinstance(ver, int) else {}),
        }
        for i in range(len(ids))
    ]


class RolloutAssembler:
    def __init__(
        self,
        layout: BatchLayout,
        lag_sec: float = 0.5,
        clock=time.monotonic,
        validate: bool = False,
    ):
        self.layout = layout
        self.seq_len = layout.seq_len
        self.lag_sec = lag_sec
        self.clock = clock
        self.validate = validate
        self.active: dict[str, Trajectory] = {}
        self.parked: dict[str, Trajectory] = {}  # done-episodes short of seq_len
        self._oldest_push = float("-inf")  # lower bound on min(last_push)
        self.ready: deque[dict] = deque()
        # Per-window lineage (trace-id lists), kept aligned with `ready`.
        # None until the FIRST traced tick arrives (then backfilled with
        # Nones), so the tracing-off path is byte-identical to before.
        self.ready_traces: deque | None = None
        # Per-window policy-version sidecar (int, -1 = unknown), always
        # aligned with `ready` — one int per window, so it stays on
        # unconditionally (no lazy activation like the trace deque).
        self.ready_vers: deque = deque()
        # observability counters
        self.n_steps = 0
        self.n_windows = 0
        self.n_dropped_stale = 0
        self.n_spliced = 0

    def _new_traj(self, now: float) -> Trajectory:
        return Trajectory(
            {
                f: np.empty((self.seq_len, self.layout.width(f)), np.float32)
                for f in BATCH_FIELDS
            },
            last_push=now,
        )

    # ------------------------------------------------------------------ push
    def push(self, step: dict) -> int:
        """Feed one env step ``{**BATCH_FIELDS, "id": str, "done": bool}``.
        Returns the number of windows newly ready."""
        eid = step["id"]
        done = bool(step["done"])
        now = self.clock()
        if self.validate:
            self.layout.validate_step(step)

        self._drop_stale(now)
        tj, seam = self._traj_for(eid, now)
        r = tj.n
        for f in BATCH_FIELDS:
            tj.cols[f][r] = step[f]  # row write: casts to f32 in place
        if seam:
            # The seam is a fake time adjacency: force the episode-first flag
            # so GAE/V-trace/value bootstraps are masked across it.
            tj.cols["is_fir"][r] = 1.0
        ver = step.get("ver")
        if isinstance(ver, int) and ver >= 0:
            tj.ver = ver if tj.ver < 0 else min(tj.ver, ver)
        tj.n += 1
        tj.last_push = now
        self.n_steps += 1
        # Maintain the lower bound on min(last_push) used by _drop_stale.
        if now < self._oldest_push:
            self._oldest_push = now
        return self._close_row(eid, tj, done)

    def push_tick(self, payload: dict, trace_id: int | None = None) -> int:
        """Feed one whole worker tick (``Protocol.RolloutBatch`` payload:
        each batch field ``(n_envs, width)``, ``id`` a list of episode ids,
        ``done`` ``(n_envs,)``) columnar-wise: one clock read and one stale
        scan for the tick, then one row write per field per env directly
        into each episode's preallocated window buffer — no per-step dict
        objects (the ``split_rollout_batch`` + per-step :meth:`push` pair is
        the reference path this replaces on the storage hot loop). Returns
        the number of windows newly ready.

        ``trace_id`` (a sampled tick's rollout-lineage id) is
        appended to every trajectory the tick touches, so the windows it
        lands in can be traced through to the learner. None — the sampling-
        off state and all unsampled ticks — adds one ``is None`` check."""
        ids = payload["id"]
        done = np.asarray(payload["done"])
        now = self.clock()
        ver = payload.get("ver")
        if not (isinstance(ver, int) and ver >= 0):
            ver = None
        if self.validate:
            self.layout.validate_tick(payload, len(ids))
        if trace_id is not None:
            self._track_traces()
        self._drop_stale(now)
        emitted = 0
        for i, eid in enumerate(ids):
            tj, seam = self._traj_for(eid, now)
            r = tj.n
            for f in BATCH_FIELDS:
                tj.cols[f][r] = payload[f][i]  # row view -> buffer row
            if seam:
                tj.cols["is_fir"][r] = 1.0
            if trace_id is not None:
                if tj.traces is None:
                    tj.traces = []
                tj.traces.append(trace_id)
            if ver is not None:
                tj.ver = ver if tj.ver < 0 else min(tj.ver, ver)
            tj.n += 1
            tj.last_push = now
            emitted += self._close_row(eid, tj, bool(done[i]))
        self.n_steps += len(ids)
        if now < self._oldest_push:
            self._oldest_push = now
        return emitted

    def _track_traces(self) -> None:
        """Activate window-lineage tracking on the first traced tick:
        backfill alignment for windows already emitted untraced."""
        if self.ready_traces is None:
            self.ready_traces = deque(None for _ in self.ready)

    def _traj_for(self, eid: str, now: float) -> tuple[Trajectory, bool]:
        """Active trajectory for ``eid``; a new episode splices onto the
        shortest parked remnant (returning seam=True for the is_fir mark)
        or starts fresh buffers."""
        tj = self.active.get(eid)
        if tj is not None:
            return tj, False
        if self.parked:
            # Splice onto the shortest parked remnant so remnants drain
            # fastest.
            k = min(self.parked, key=lambda x: len(self.parked[x]))
            tj = self.parked.pop(k)
            self.n_spliced += 1
            self.active[eid] = tj
            return tj, True
        tj = self._new_traj(now)
        self.active[eid] = tj
        return tj, False

    def _close_row(self, eid: str, tj: Trajectory, done: bool) -> int:
        if tj.n >= self.seq_len:
            # The filled buffer IS the window — ownership transfers out.
            out = self.active.pop(eid)
            self.ready.append(out.cols)
            if self.ready_traces is not None:
                self.ready_traces.append(out.traces)
            self.ready_vers.append(out.ver)
            self.n_windows += 1
            return 1
        if done:
            # Episode over, window short: park the remnant for splicing.
            self.parked[eid] = self.active.pop(eid)
        return 0

    def _drop_stale(self, now: float) -> None:
        # Skip the O(episodes) scan until the oldest trajectory could possibly
        # be stale — keeps the per-push cost O(1) amortized on the hot ingest
        # path (all workers funnel through this method).
        if now < self._oldest_push + self.lag_sec:
            return
        oldest = float("inf")
        for table in (self.active, self.parked):
            stale = []
            for eid, tj in table.items():
                if now - tj.last_push >= self.lag_sec:
                    stale.append(eid)
                else:
                    oldest = min(oldest, tj.last_push)
            for eid in stale:
                del table[eid]
            self.n_dropped_stale += len(stale)
        self._oldest_push = oldest

    # ------------------------------------------------------------------- pop
    def pop(self) -> dict | None:
        """Next ready window as a dict of (seq, width) arrays, or None."""
        if not self.ready:
            return None
        if self.ready_traces is not None:
            self.ready_traces.popleft()  # keep lineage aligned; caller
            # wants only the window — lineage consumers use pop_many_traced
        if self.ready_vers:  # may run short on direct ready appends
            self.ready_vers.popleft()
        return self.ready.popleft()

    def pop_many(self, max_windows: int | None = None) -> list[dict]:
        """Drain up to ``max_windows`` ready windows (all, when None) — the
        multi-window companion of :meth:`pop` feeding the stores'
        ``put_many`` burst writes."""
        windows, _, _ = self.pop_many_full(max_windows)
        return windows

    def pop_many_traced(
        self, max_windows: int | None = None
    ) -> tuple[list[dict], list | None]:
        """:meth:`pop_many` plus each window's lineage (list of trace ids or
        None per window); the traces list itself is None until lineage
        tracking has activated — the untraced path allocates nothing extra."""
        windows, traces, _ = self.pop_many_full(max_windows)
        return windows, traces

    def pop_many_full(
        self, max_windows: int | None = None
    ) -> tuple[list[dict], list | None, list[int]]:
        """:meth:`pop_many_traced` plus each window's policy-version sidecar
        (int, -1 = unknown) — the storage flush path feeds these straight
        into the stores' per-slot staleness arrays."""
        n = len(self.ready) if max_windows is None else min(
            max_windows, len(self.ready)
        )
        windows = [self.ready.popleft() for _ in range(n)]
        # The sidecar can run short when a producer appended to ``ready``
        # directly instead of through push_tick/requeue (tests, external
        # feeds): degrade those windows to version-unknown, never crash.
        vers = [
            self.ready_vers.popleft() if self.ready_vers else -1
            for _ in range(n)
        ]
        if self.ready_traces is None:
            return windows, None, vers
        return windows, [self.ready_traces.popleft() for _ in range(n)], vers

    def requeue(
        self,
        windows: list[dict],
        traces: list | None = None,
        vers: list[int] | None = None,
    ) -> None:
        """Put rejected windows back at the FRONT in their original order
        (store-full back-pressure) — replaces direct ``ready`` manipulation
        so the lineage and version deques stay aligned."""
        self.ready.extendleft(reversed(windows))
        if self.ready_traces is not None:
            ts = traces if traces is not None else [None] * len(windows)
            self.ready_traces.extendleft(reversed(ts))
        vs = vers if vers is not None else [-1] * len(windows)
        self.ready_vers.extendleft(reversed(vs))

    def __len__(self) -> int:
        return len(self.ready)

    @property
    def stats(self) -> dict[str, int]:
        return dict(
            steps=self.n_steps,
            windows=self.n_windows,
            dropped_stale=self.n_dropped_stale,
            spliced=self.n_spliced,
            active=len(self.active),
            parked=len(self.parked),
        )
