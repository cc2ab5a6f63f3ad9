"""Pipelined learner feed: overlap the host data plane with the card's
compute — the port of ``tpu_rl.data.prefetch``.

:class:`PrefetchPipeline` runs a background feeder thread that pulls raw
batches from a store and assembles them into batches on the card, so the
NEXT dispatch's shared-memory copy and host-to-device transfer run while
the CURRENT ``train_step`` computes. The learner pops batches from a
bounded queue (depth ~2: enough to hide the feed, small enough to bound
device memory and on-policy staleness).

Contract (``tpu_rl``'s, held by ``tests/test_torch_prefetch.py``):

- **Ordering / no batch loss**: one feeder thread + a FIFO queue — batches
  reach the learner exactly in store-consumption order.
- **Deterministic shutdown**: ``close()`` (or the shared stop event) drains
  the feeder even when it is blocked on a full queue; ``close()`` joins.
- **Error propagation**: a feeder-thread exception re-raises out of the
  learner's next ``get()`` — never a silent hang.
- **RNG stream stability**: the replay sampler's ``np.random.Generator`` is
  only ever touched by the (single) feeder thread, so the draw sequence is
  identical to the synchronous feed's given the same fetch order.

:class:`SynchronousFeed` is the same interface with no pipelining.

Placement on the card is :func:`device_batch` (what ``assemble`` calls):
on CUDA it goes through a :class:`DeviceStager` — pinned host staging
buffers, a side CUDA stream for the non-blocking copies, and an event per
batch that the consumer's stream waits on (:func:`wait_ready`) before the
train step reads the batch.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable

import numpy as np
import torch

from tpu_rl_torch import resolve_device
from tpu_rl_torch.types import BATCH_FIELDS, Batch


class UpdateRatioGate:
    """Off-policy update:data ratio cap.

    The replay sampler never waits for fresh data — ``ReplayStore.sample``
    answers as long as the ring holds ``batch_size`` rows — so a learner
    that outruns its actors free-runs at extreme update:data ratios and
    re-fits early random experience. The gate blocks the NEXT update while

        (updates_planned + 1) / transitions_received > max_ratio

    i.e. ``max_ratio`` is the allowed updates per received transition
    (transitions = trajectory windows put x seq_len). ``updates_planned``
    counts batches *fetched* for training rather than updates completed, so
    a prefetching feed cannot overdraw the budget by its queue depth.

    Single-threaded by design: only the feed (feeder thread or the inline
    synchronous feed) calls it.
    """

    def __init__(self, max_ratio: float):
        if not max_ratio > 0:
            raise ValueError(f"max_update_data_ratio must be > 0, got {max_ratio}")
        self.max_ratio = float(max_ratio)
        self.updates_planned = 0

    def ready(self, transitions_received: int) -> bool:
        """May one more update's batch be fetched yet?"""
        if transitions_received <= 0:
            return False
        return (self.updates_planned + 1) <= self.max_ratio * transitions_received

    def note_fetched(self) -> None:
        """Record that one update's batch was actually fetched."""
        self.updates_planned += 1


class SynchronousFeed:
    """The unpipelined feed: fetch + assemble inline in ``get()``.

    Same interface as :class:`PrefetchPipeline`, so a learner loop is shaped
    identically either way. ``get`` accumulates toward a full
    chained dispatch across calls (returning None whenever the store has no
    window ready, so the caller can heartbeat), exactly like the pre-pipeline
    learner loop did.
    """

    poll_sleep = 0.002  # caller sleeps this on a None get (store starving)

    def __init__(self, fetch: Callable, assemble: Callable, chain: int = 1):
        self._fetch = fetch
        self._assemble = assemble
        self._chain = max(1, chain)
        self._pending: list = []
        self._secs = 0.0  # fetch+assemble seconds toward the next dispatch

    def get(self, timeout: float = 0.0):
        """One device-ready batch as ``(batch, feed_secs)``, or None when the
        store cannot yet fill the dispatch. ``timeout`` is accepted for
        interface parity and ignored (fetch never blocks)."""
        while len(self._pending) < self._chain:
            t0 = time.perf_counter()
            raw = self._fetch()
            if raw is None:
                return None
            self._secs += time.perf_counter() - t0
            self._pending.append(raw)
        t0 = time.perf_counter()
        batch = self._assemble(self._pending)
        self._pending = []
        secs, self._secs = self._secs + (time.perf_counter() - t0), 0.0
        return batch, secs

    def qsize(self) -> int:
        return 0

    def close(self) -> None:  # interface parity; nothing to drain
        pass


class PrefetchPipeline:
    """Bounded-depth background feed of device-resident batches.

    ``fetch() -> raw | None`` pulls one update's raw batch from the store
    (None = not ready); ``assemble(list[raw]) -> batch`` turns ``chain``
    raws into ONE dispatch batch on the device (:func:`device_batch`). Both run on the feeder
    thread, off the learner's critical path.
    """

    poll_sleep = 0.0  # get() already blocks on the queue

    def __init__(
        self,
        fetch: Callable,
        assemble: Callable,
        chain: int = 1,
        depth: int = 2,
        stop_event=None,
        idle_sleep: float = 0.002,
        name: str = "learner-prefetch",
    ):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._fetch = fetch
        self._assemble = assemble
        self._chain = max(1, chain)
        self._stop_event = stop_event
        self._idle_sleep = idle_sleep
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._error: BaseException | None = None
        self._closed = threading.Event()
        self._dispatched = 0  # dispatch batches handed to the learner
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- feeder
    def _stopped(self) -> bool:
        return self._closed.is_set() or (
            self._stop_event is not None and self._stop_event.is_set()
        )

    def _run(self) -> None:
        pending: list = []
        feed_secs = 0.0
        try:
            while not self._stopped():
                t0 = time.perf_counter()
                raw = self._fetch()
                if raw is None:
                    # store starving (or the update-ratio gate holding):
                    # idle spans never count toward the dispatch's feed time
                    time.sleep(self._idle_sleep)
                    continue
                feed_secs += time.perf_counter() - t0
                pending.append(raw)
                if len(pending) < self._chain:
                    continue
                t0 = time.perf_counter()
                batch = self._assemble(pending)
                pending = []
                feed_secs += time.perf_counter() - t0
                item = (batch, feed_secs)
                feed_secs = 0.0
                # stop-aware put: a full queue must never deadlock shutdown
                while not self._stopped():
                    try:
                        self._q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — re-raised in the learner
            self._error = e

    # ------------------------------------------------------------ consumer
    def get(self, timeout: float = 0.05):
        """Pop the next ``(batch, feed_secs)``; None after ``timeout`` with
        nothing ready. Re-raises any feeder-thread exception."""
        if self._error is not None:
            raise self._error
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            if self._error is not None:
                raise self._error
            return None
        self._dispatched += 1
        return item

    def qsize(self) -> int:
        """Prefetched dispatches currently queued (the queue-depth gauge:
        ~depth means the feed is ahead of the card, ~0 means behind)."""
        return self._q.qsize()

    @property
    def dispatched(self) -> int:
        return self._dispatched

    def close(self, timeout: float = 10.0) -> None:
        """Deterministic shutdown: stop the feeder and join it. Batches still
        queued are dropped (bounded by ``depth``); pending feeder errors are
        NOT raised here — shutdown must always complete."""
        self._closed.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():  # pragma: no cover — contract violation
            raise RuntimeError("prefetch feeder thread failed to stop")


class DeviceStager:
    """Host-to-device placement of raw batches through pinned staging
    buffers on a side CUDA stream.

    Per batch: wait until the slot's previous copy has completed (its
    event), copy each field into the slot's pinned buffer, enqueue the
    non-blocking copies to the card on the side stream, record an event
    after them, and mark each device tensor as used by the consumer's
    stream (``record_stream``), so the caching allocator never hands its
    memory to the side stream while the consumer may still read it. The
    consumer waits on the event (:func:`wait_ready`) before reading.

    ``slots`` should be the feed's depth + 1; the event wait keeps a slot
    from being overwritten mid-copy whatever the count. The consumer is
    the stream current on the constructing thread (the train step's)."""

    def __init__(self, device, slots: int = 3):
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            raise ValueError(f"DeviceStager stages onto a CUDA device, not {self.device}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.stream = torch.cuda.Stream(self.device)
        self.consumer = torch.cuda.current_stream(self.device)
        self._buffers: list[dict[str, torch.Tensor] | None] = [None] * slots
        self._events: list[torch.cuda.Event | None] = [None] * slots
        self._next = 0
        self.h2d_bytes = 0  # bytes copied to the card so far

    def _slot_buffers(self, slot: int, raw: dict) -> dict[str, torch.Tensor]:
        bufs = self._buffers[slot]
        if bufs is None or any(bufs[f].shape != np.shape(raw[f]) for f in BATCH_FIELDS):
            bufs = {
                f: torch.empty(np.shape(raw[f]), dtype=torch.float32, pin_memory=True)
                for f in BATCH_FIELDS
            }
            self._buffers[slot] = bufs
        return bufs

    def __call__(self, raw: dict) -> Batch:
        slot = self._next
        self._next = (slot + 1) % len(self._buffers)
        ev = self._events[slot]
        if ev is not None:
            ev.synchronize()  # the slot's last copy has left its buffers
        bufs = self._slot_buffers(slot, raw)
        for f in BATCH_FIELDS:
            np.copyto(bufs[f].numpy(), raw[f], casting="same_kind")
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = {f: bufs[f].to(self.device, non_blocking=True) for f in BATCH_FIELDS}
            ev = torch.cuda.Event()
            ev.record(self.stream)
        for t in out.values():
            t.record_stream(self.consumer)
        self._events[slot] = ev
        self.h2d_bytes += sum(t.numel() * 4 for t in out.values())
        batch = Batch(**out)
        batch.ready_event = ev
        return batch


def device_batch(raws: list, device, stager: DeviceStager | None = None) -> Batch:
    """One dispatch batch on ``device`` from ``raws`` (one raw batch: a
    mapping of ``(B, S, w)`` numpy arrays; a ``ver`` sidecar or any other
    key is ignored; zero its carry first with ``types.maybe_zero_carry``
    where the config asks). On the CPU a plain ``Batch.from_mapping``; on
    CUDA through ``stager`` (required there), whose event the consumer
    waits on with :func:`wait_ready`."""
    if len(raws) != 1:
        raise ValueError(
            f"device_batch assembles one raw batch per dispatch, got {len(raws)}: "
            "chained dispatch comes with the distributed runtime of the port"
        )
    raw = raws[0]
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Batch.from_mapping(raw, device="cpu")
    if stager is None:
        raise ValueError("device_batch on CUDA needs a DeviceStager")
    return stager(raw)


def wait_ready(batch: Batch) -> Batch:
    """Make the current stream wait for ``batch``'s host-to-device copy; a
    batch built without a stager passes through."""
    ev = getattr(batch, "ready_event", None)
    if ev is not None:
        torch.cuda.current_stream(batch.obs.device).wait_event(ev)
    return batch
