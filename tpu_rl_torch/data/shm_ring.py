"""Shared-memory trajectory stores shared by a writer (storage) process and
the learner — the port of ``tpu_rl.data.shm_ring``, numpy only.

- **OnPolicyStore** (capacity = ``batch_size``): single-writer fill,
  consume-all-and-reset reader. The writer checks a generation counter
  after its slot write and re-writes into the new generation if a consume
  intervened, so a consumed batch never holds a torn or misplaced window.
- **ReplayStore** (capacity = ``buffer_size``): ring overwrite + uniform
  sampling. Each slot carries a seqlock version (even = stable, odd = write
  in progress) and the sampler re-draws torn reads.

Data lives in one ``mp.Array("f")`` per field, viewed as
``(capacity, seq_len, width)`` numpy arrays. The primitives come from the
**spawn** context: a forked child of a process that has initialised CUDA
cannot use CUDA, and the stores touch nothing but numpy.
"""

from __future__ import annotations

import multiprocessing as mp
from dataclasses import dataclass

import numpy as np

from tpu_rl_torch.data.layout import BatchLayout
from tpu_rl_torch.types import BATCH_FIELDS


@dataclass
class ShmHandles:
    """Raw multiprocessing primitives; picklable into child processes via
    ``mp.Process`` args."""

    arrays: dict  # field -> mp.Array("f", capacity * seq * width)
    versions: mp.Array  # per-slot seqlock counters ("L", capacity)
    count: mp.Value  # OnPolicy: filled slots this generation; Replay: total puts
    gen: mp.Value  # OnPolicy consume generation
    lock: mp.Lock
    capacity: int
    # Per-slot policy version of the window's OLDEST contributing tick
    # (-1 = unknown), the staleness sidecar of the learning-dynamics plane
    # (tpu_rl_torch.obs.learn). Optional (default None), as in tpu_rl.
    vers: mp.Array | None = None


def alloc_handles(
    layout: BatchLayout, capacity: int, ctx=None
) -> ShmHandles:
    """Allocate from an explicit mp context — default spawn (fork-context
    primitives cannot be passed into spawn children, and a forked child of
    a CUDA process cannot use CUDA)."""
    ctx = ctx or mp.get_context("spawn")
    arrays = {
        f: ctx.Array("f", capacity * layout.seq_len * layout.width(f), lock=False)
        for f in BATCH_FIELDS
    }
    vers = ctx.Array("q", capacity, lock=False)
    np.frombuffer(vers, dtype=np.int64)[:] = -1  # -1 = version unknown
    return ShmHandles(
        arrays=arrays,
        versions=ctx.Array("L", capacity, lock=False),
        count=ctx.Value("q", 0, lock=False),
        gen=ctx.Value("q", 0, lock=False),
        lock=ctx.Lock(),
        capacity=capacity,
        vers=vers,
    )


class _StoreBase:
    """Numpy views over the handles; construct one per process (views bind to
    the inherited shared buffers)."""

    def __init__(self, handles: ShmHandles, layout: BatchLayout):
        self.h = handles
        self.layout = layout
        self.capacity = handles.capacity
        self.views = {
            f: np.frombuffer(handles.arrays[f], dtype=np.float32).reshape(
                handles.capacity, layout.seq_len, layout.width(f)
            )
            for f in BATCH_FIELDS
        }
        self.versions = np.frombuffer(handles.versions, dtype=np.uint64)
        self.slot_vers = (
            np.frombuffer(handles.vers, dtype=np.int64)
            if getattr(handles, "vers", None) is not None
            else None
        )

    def _write_slot(self, slot: int, window: dict) -> None:
        for f in BATCH_FIELDS:
            self.views[f][slot] = window[f]

    def _read_slots(self, idx: np.ndarray | slice) -> dict[str, np.ndarray]:
        return {f: self.views[f][idx].copy() for f in BATCH_FIELDS}

    def _write_vers(self, slots, vers: list | None, off: int, k: int) -> None:
        """Stamp the staleness sidecar for ``k`` slots (``vers[off:off+k]``,
        or -1 when the caller carries none)."""
        if self.slot_vers is None:
            return
        self.slot_vers[slots] = (
            vers[off : off + k] if vers is not None else -1
        )


class OnPolicyStore(_StoreBase):
    """Fill-then-consume batch store (single writer, single reader)."""

    # ---------------------------------------------------------------- writer
    # put() retry bound: a consume can reset the store mid-write, forcing a
    # re-write into the new generation; each retry needs a fresh consume to
    # intervene (which itself needs a full store), so in practice one retry
    # suffices. The cap makes the no-livelock contract explicit.
    MAX_PUT_RETRIES = 8

    def put(self, window: dict, ver: int = -1) -> bool:
        """Write one (seq, width)-per-field trajectory window. Returns False
        when the current generation is full (caller drops or retries later)
        or — bounded-retry contract — when
        consumes keep invalidating the write ``MAX_PUT_RETRIES`` times.
        ``ver`` is the window's policy-version sidecar (-1 = unknown)."""
        h = self.h
        for _ in range(self.MAX_PUT_RETRIES):
            with h.lock:
                gen, slot = h.gen.value, h.count.value
                if slot >= self.capacity:
                    return False
            self._write_slot(slot, window)
            self._write_vers(slice(slot, slot + 1), [ver], 0, 1)
            with h.lock:
                if h.gen.value == gen:
                    # No consume intervened: publish the slot.
                    h.count.value = slot + 1
                    return True
            # A consume reset the store mid-write; re-write into the new
            # generation.
        return False

    def put_many(self, windows: list[dict], vers: list | None = None) -> int:
        """Write a burst of trajectory windows with one contiguous slice
        write per field per generation (vs one slot write per window via
        :meth:`put`). Returns how many were accepted — the tail past a full
        generation is rejected, preserving window order, so callers requeue
        ``windows[accepted:]`` exactly as they would a single rejected put.
        ``vers`` (aligned with ``windows``) stamps each slot's
        policy-version sidecar."""
        if not windows:
            return 0
        h = self.h
        written = 0
        while written < len(windows):
            for _ in range(self.MAX_PUT_RETRIES):
                with h.lock:
                    gen, slot = h.gen.value, h.count.value
                    if slot >= self.capacity:
                        return written
                k = min(len(windows) - written, self.capacity - slot)
                chunk = windows[written : written + k]
                for f in BATCH_FIELDS:
                    # One slice write per field: numpy stacks the k windows'
                    # (seq, width) arrays straight into the shm view.
                    self.views[f][slot : slot + k] = [w[f] for w in chunk]
                self._write_vers(slice(slot, slot + k), vers, written, k)
                with h.lock:
                    if h.gen.value == gen:
                        h.count.value = slot + k
                        written += k
                        break
                # Consume intervened mid-burst: re-write into the new
                # generation (same retry contract as put()).
            else:
                return written
        return written

    # ---------------------------------------------------------------- reader
    @property
    def size(self) -> int:
        with self.h.lock:
            return self.h.count.value

    def consume(self, need: int | None = None) -> dict[str, np.ndarray] | None:
        """If at least ``need`` (default: capacity) trajectories are ready,
        copy them out, reset the store, and return ``field -> (n, seq, width)``
        arrays; else None."""
        need = self.capacity if need is None else need
        h = self.h
        with h.lock:
            n = h.count.value
            if n < need:
                return None
            out = self._read_slots(slice(0, n))
            if self.slot_vers is not None:
                # Staleness sidecar: per-row policy version, a NON-batch key
                # (Batch.from_mapping keys off BATCH_FIELDS and drops it).
                out["ver"] = self.slot_vers[:n].copy()
            h.gen.value += 1
            h.count.value = 0
        return out


class ReplayStore(_StoreBase):
    """Overwriting ring + uniform sampler (SAC replay). Single writer, any
    number of sampling readers."""

    # ---------------------------------------------------------------- writer
    def put(self, window: dict, ver: int = -1) -> bool:
        h = self.h
        with h.lock:
            total = h.count.value
        slot = total % self.capacity
        self.versions[slot] += 1  # odd: write in progress
        self._write_slot(slot, window)
        self._write_vers(slice(slot, slot + 1), [ver], 0, 1)
        self.versions[slot] += 1  # even: stable
        with h.lock:
            h.count.value = total + 1
        return True

    def put_many(self, windows: list[dict], vers: list | None = None) -> int:
        """Ring-write a burst of windows with one fancy-indexed write per
        field per chunk. Chunked to ``capacity`` so the slot set within a
        write stays duplicate-free; across chunks the ring overwrite order
        matches sequential :meth:`put` calls. Always accepts everything
        (the ring never rejects), returning ``len(windows)``."""
        h = self.h
        done = 0
        while done < len(windows):
            chunk = windows[done : done + self.capacity]
            k = len(chunk)
            with h.lock:
                total = h.count.value
            slots = (total + np.arange(k)) % self.capacity
            self.versions[slots] += 1  # odd: writes in progress
            for f in BATCH_FIELDS:
                self.views[f][slots] = [w[f] for w in chunk]
            self._write_vers(slots, vers, done, k)
            self.versions[slots] += 1  # even: stable
            with h.lock:
                h.count.value = total + k
            done += k
        return len(windows)

    # ---------------------------------------------------------------- reader
    @property
    def size(self) -> int:
        with self.h.lock:
            return min(self.h.count.value, self.capacity)

    @property
    def total_puts(self) -> int:
        """Trajectory windows EVER written (monotonic; the ring overwrites
        but ``count`` never resets) — the data-arrival odometer behind the
        off-policy update:data ratio gate."""
        with self.h.lock:
            return self.h.count.value

    def transitions_received(self) -> int:
        """Environment transitions ever received = windows x seq_len."""
        return self.total_puts * self.layout.seq_len

    def sample(
        self, batch: int, rng: np.random.Generator, max_retries: int = 8
    ) -> dict[str, np.ndarray] | None:
        """Uniform sample of ``batch`` trajectories; None until the ring holds
        at least ``batch``. Torn slots (overwritten mid-read) are re-drawn via
        the seqlock; if a consistent sample cannot be assembled within the
        retry budget, returns None (callers treat it as "not ready") — a
        torn trajectory is never returned.

        Vectorized: each retry round is one fancy-index copy per field over
        the still-pending rows plus two vector version reads. The ``ver``
        key is the staleness sidecar, not a batch field:
        ``Batch.from_mapping`` and ``prefetch.device_batch`` ignore it."""
        n = self.size
        if n < batch:
            return None
        idx = rng.integers(0, n, size=batch)
        out = {
            f: np.empty(
                (batch, self.layout.seq_len, self.layout.width(f)), np.float32
            )
            for f in BATCH_FIELDS
        }
        if self.slot_vers is not None:
            out["ver"] = np.full(batch, -1, np.int64)
        pending = np.arange(batch)
        for _ in range(max_retries):
            sel = idx[pending]
            v1 = self.versions[sel].copy()
            chunk = {f: self.views[f][sel] for f in BATCH_FIELDS}  # copies
            # The sidecar rides inside the same seqlock bracket as the
            # field reads, so a sampled row's version is never torn either.
            sv = (
                self.slot_vers[sel].copy()
                if self.slot_vers is not None
                else None
            )
            v2 = self.versions[sel].copy()
            ok = (v1 % 2 == 0) & (v2 == v1)
            done = pending[ok]
            for f in BATCH_FIELDS:
                out[f][done] = chunk[f][ok]
            if sv is not None:
                out["ver"][done] = sv[ok]
            pending = pending[~ok]
            if pending.size == 0:
                return out
            idx[pending] = rng.integers(0, n, size=pending.size)  # re-draw
        return None  # retry budget exhausted; sample again later


def make_store(cfg, layout: BatchLayout, handles: ShmHandles | None = None):
    """Store factory keyed on the algo's on/off-policy nature. Pass
    ``handles`` in child processes."""
    from tpu_rl_torch.config import is_off_policy

    off_policy = is_off_policy(cfg.algo)
    capacity = cfg.buffer_size if off_policy else cfg.batch_size
    if handles is None:
        handles = alloc_handles(layout, capacity)
    cls = ReplayStore if off_policy else OnPolicyStore
    return cls(handles, layout)
