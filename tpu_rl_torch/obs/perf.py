"""Live performance plane: FLOPs, MFU, recompiles, device memory, profiler —
the port of ``tpu_rl.obs.perf``.

- :class:`PerfTracker` wraps one entry point (the colocated loop's
  program, one serving bucket's act step). :meth:`PerfTracker.call`
  dispatches it and returns its result; on the FIRST call of a callable it
  counts that very call's FLOPs under
  ``torch.utils.flop_counter.FlopCounterMode`` (there is no ahead-of-time
  compile to analyse, and an extra call would step the envs and the
  params). The hand-written kernels are ``torch.library.custom_op``
  operators with registered FLOP formulas (``ops.lstm``, ``ops.fused_act``,
  ``ops.attention``), so the counter charges each kernel call its formula
  and does not descend into it: the count is the same on the card as on
  the CPU, where the plain versions run beneath. Achieved FLOP/s and MFU
  come from a rolling window of dispatch intervals (:meth:`note`).
  Recompiles: eager PyTorch keeps no trace cache, so the watch counts what
  ``tpu_rl``'s jit cache size measures: the distinct argument signatures
  (tensor shapes, dtypes, devices) after the first.
- :func:`device_peak_flops` / :data:`PEAK_FLOPS`: bf16 dense peak by the
  card's name (``torch.cuda.get_device_name``). MFU is reported against
  the bf16 peak whatever the compute dtype, as in ``tpu_rl``.
  ``TPU_RL_PEAK_FLOPS`` (FLOP/s per device) overrides the table; it is what
  gives a CPU run a denominator.
- :func:`device_memory_bytes`: in-use and peak bytes of the CUDA caching
  allocator (``torch.cuda.memory_stats``) for a CUDA device; process RSS,
  with a tracked high-water mark, only for an explicit CPU device.
- :func:`process_self_stats`: RSS and open fds from ``/proc/self``.
- :class:`ProfilerCapture`: the one gate every profiler path goes through
  (a ``/prof?ms=N`` request, a caller's window): captures are
  serialized, refused while one is in flight, bounded, written as a Chrome
  trace under ``out_dir``, and stopped by the flight recorder's crash hook.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque

import torch
from torch.utils.flop_counter import FlopCounterMode

from tpu_rl_torch.obs import flightrec

# bf16 dense peak FLOP/s per card by device name (NVIDIA's data sheets,
# without sparsity). MFU is reported against bf16 peak whatever the
# compute dtype; an unknown card (or the CPU) -> None -> MFU omitted.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,  # H100 SXM5
    "NVIDIA H100 PCIe": 756e12,
}


def device_peak_flops(device: str | torch.device) -> float | None:
    """Peak bf16 FLOP/s of ``device``, or None when unknown. The
    ``TPU_RL_PEAK_FLOPS`` env var (float, per device) wins over the table."""
    env = os.environ.get("TPU_RL_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for k, v in PEAK_FLOPS.items():
        if name.startswith(k) or k in name:
            return v
    return None


# ------------------------------------------------------------ process stats
_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096
_rss_peak = 0.0  # high-water mark of the CPU device's RSS reading


def process_self_stats() -> tuple[float, int]:
    """(RSS bytes, open fd count) from ``/proc/self`` — no psutil. Returns
    (0.0, 0) where /proc is absent; callers still set the gauges so the
    series exists."""
    rss = 0.0
    try:
        with open("/proc/self/statm") as f:
            rss = float(int(f.read().split()[1])) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        pass
    try:
        n_fds = len(os.listdir("/proc/self/fd"))
    except OSError:
        n_fds = 0
    return rss, n_fds


def device_memory_bytes(device: str | torch.device) -> tuple[float, float]:
    """(bytes in use, peak bytes) of ``device``: the CUDA caching
    allocator's ``allocated_bytes.all.current`` / ``.peak`` (the peak is
    ``torch.cuda.max_memory_allocated``) for a CUDA device; process RSS and
    its high-water mark for the CPU. Any other device raises."""
    global _rss_peak
    device = torch.device(device)
    if device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        return (
            float(stats.get("allocated_bytes.all.current", 0)),
            float(stats.get("allocated_bytes.all.peak", 0)),
        )
    if device.type != "cpu":
        raise ValueError(f"device_memory_bytes: unsupported device {device}")
    rss, _ = process_self_stats()
    _rss_peak = max(_rss_peak, rss)
    return rss, _rss_peak


# ------------------------------------------------------------- perf tracker
def signature(tree) -> tuple:
    """The shapes, dtypes and devices of every tensor in ``tree`` (dicts,
    lists, tuples and dataclasses walked in order; any other leaf by its
    type): what a jit cache would key a trace on."""
    if isinstance(tree, torch.Tensor):
        return (tree.shape, tree.dtype, tree.device)
    if isinstance(tree, dict):
        return tuple((k, signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(signature(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return tuple(signature(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    return (type(tree),)


class _SignatureWatch:
    """Recompile counter for one callable: the distinct argument signatures
    it was called with, less the first (the warm-up's)."""

    def __init__(self, fn):
        self.fn = fn
        self._seen: set[tuple] = set()
        self._offset = 0  # recompiles frozen from earlier bindings

    def see(self, sig: tuple) -> None:
        self._seen.add(sig)

    def _current(self) -> int:
        return max(0, len(self._seen) - 1)

    def rebind(self, fn) -> None:
        """Point at a rebuilt callable (an expected rebuild): freeze the old
        binding's drift count, restart the baseline."""
        if fn == self.fn:
            return
        self._offset += self._current()
        self.fn = fn
        self._seen = set()

    @property
    def recompiles(self) -> int:
        return self._offset + self._current()


# Dispatch intervals the achieved rate is averaged over.
WINDOW = 100


class PerfTracker:
    """Live FLOPs/MFU/recompile accounting for ONE entry point on ONE
    ``device`` (MFU is against that card's peak).

    Loop protocol (the tracker is simply ``None`` when the plane is off):

    - ``out = tracker.call(fn, *args)`` in place of ``out = fn(*args)``: the
      first call of a (new) callable is counted under ``FlopCounterMode``
      and rebinds the recompile watch; every call adds its argument
      signature to the watch;
    - ``note(dt)`` with the wall-clock interval of a dispatch, measured
      against a blocking read;
    - read ``flops_per_call`` / ``achieved_flops_per_s()`` / ``mfu()`` /
      ``recompiles`` at emit cadence.

    Under data parallelism (``world`` ranks, one card each, all running the
    same step on equal shards) the counts are the world's: this rank's
    FLOPs times ``world``, against ``world`` cards' peak.
    """

    def __init__(self, device: str | torch.device, world: int = 1):
        self.device = torch.device(device)
        self.world = int(world)
        peak = device_peak_flops(self.device)
        self.peak = peak * self.world if peak else peak
        self.flops_per_call = 0.0
        self._dts: deque[float] = deque(maxlen=WINDOW)
        self._watch: _SignatureWatch | None = None

    def call(self, fn, *args, sig: tuple | None = None):
        """``fn(*args)``; on a new binding, that call's FLOPs become
        ``flops_per_call``. ``sig`` is the call's argument signature where
        the caller knows it without a walk of ``args`` (a serving bucket's
        fixed staging views); by default :func:`signature` of ``args``."""
        sig = signature(args) if sig is None else sig
        if self._watch is not None and fn == self._watch.fn:
            self._watch.see(sig)
            return fn(*args)
        if self._watch is None:
            self._watch = _SignatureWatch(fn)
        else:
            self._watch.rebind(fn)
        self._watch.see(sig)
        with FlopCounterMode(display=False) as counter:
            out = fn(*args)
        self.flops_per_call = float(counter.get_total_flops()) * self.world
        return out

    def note(self, dt_s: float) -> None:
        if dt_s > 0:
            self._dts.append(float(dt_s))

    @property
    def recompiles(self) -> int:
        return self._watch.recompiles if self._watch is not None else 0

    def achieved_flops_per_s(self) -> float | None:
        if not self._dts or self.flops_per_call <= 0:
            return None
        total = sum(self._dts)
        if total <= 0:
            return None
        return self.flops_per_call * len(self._dts) / total

    def mfu(self) -> float | None:
        achieved = self.achieved_flops_per_s()
        if achieved is None or not self.peak:
            return None
        return achieved / self.peak


# --------------------------------------------------------- profiler capture
class ProfilerCapture:
    """Serialized ``torch.profiler`` capture into ``out_dir``: CUDA activity
    on a CUDA ``device``, CPU activity on the CPU.

    One instance per process gates every capture path — a caller's window
    (``start()``/``stop()``, from one thread) and HTTP ``/prof?ms=N``
    (:meth:`capture_async`) — so traces never interleave. A request
    while one is in flight is refused (the HTTP layer maps that to 409). A
    crash hook registered with the flight recorder ends and writes the
    capture on a fatal exception. Each capture is a directory
    ``prof-<tag>-<time>/`` holding ``trace.json`` (Chrome trace format).

    ``torch.profiler`` must be stopped on the thread that started it (it
    crashes the process otherwise), so a bounded capture runs start, wait
    and stop on a thread of its own; on the card its CUDA activity still
    records every kernel of the process. With CPU activity it records that
    thread's operators only.
    """

    def __init__(self, out_dir: str, device: str | torch.device, default_ms: int = 500):
        self.out_dir = out_dir
        self.default_ms = int(default_ms)
        cuda = torch.device(device).type == "cuda"
        self.activities = [
            torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU
        ]
        self._lock = threading.Lock()
        self._active: str | None = None  # trace dir while capturing
        self._prof = None  # the caller's window (start/stop)
        self._thread: threading.Thread | None = None  # a bounded capture
        self._wake = threading.Event()  # ends a bounded capture early
        self.n_captures = 0
        flightrec.add_crash_hook(self._crash_stop)

    @property
    def active(self) -> bool:
        return self._active is not None

    def _claim(self, tag: str) -> str | None:
        """Reserve the capture slot and make its directory; None if busy."""
        with self._lock:
            if self._active is not None:
                return None
            path = os.path.join(self.out_dir, f"prof-{tag}-{time.strftime('%Y%m%d-%H%M%S')}")
            os.makedirs(path, exist_ok=True)
            self._active = path
            return path

    def _release(self) -> None:
        with self._lock:
            self._active = None

    def _open(self):
        """A running profiler on this thread, or None if another profiler
        already runs in this process."""
        prof = torch.profiler.profile(activities=self.activities)
        try:
            prof.start()
        except RuntimeError:
            return None
        return prof

    def _finish(self, prof, path: str) -> str | None:
        """Stop ``prof`` (on the thread that started it), write its trace,
        free the slot. Never raises — this runs on crash paths."""
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(path, "trace.json"))
        except Exception:  # noqa: BLE001 — a crash path must not raise
            path = None
        with self._lock:
            if path is not None:
                self.n_captures += 1
            # Cleared last: ``active`` readers never see False while the
            # trace is still being written.
            self._active = None
        return path

    def start(self, tag: str = "window") -> str | None:
        """Begin an unbounded capture on this thread (stop it from the same
        thread); None if busy."""
        path = self._claim(tag)
        if path is None:
            return None
        prof = self._open()
        if prof is None:
            self._release()
            return None
        self._prof = prof
        return path

    def stop(self) -> str | None:
        """End the in-flight capture and write its trace: the caller's
        window, or a bounded capture, which is woken and awaited. None when
        idle (or when the trace could not be written)."""
        prof, path, thread = self._prof, self._active, self._thread
        if prof is not None:
            self._prof = None
            return self._finish(prof, path)
        if thread is not None and thread.is_alive():
            self._wake.set()
            thread.join(timeout=30.0)
            return path if os.path.exists(os.path.join(path, "trace.json")) else None
        return None

    def capture_async(self, ms: int | None = None) -> tuple[bool, str]:
        """Bounded capture on a thread of its own: (True, trace dir) when
        started, (False, reason) when one is already in flight. Powers
        ``/prof``."""
        ms = self.default_ms if ms is None else max(1, int(ms))
        path = self._claim(f"{ms}ms")
        if path is None:
            return False, "capture in progress"
        self._wake = wake = threading.Event()

        def _run():
            prof = self._open()
            if prof is None:
                self._release()
                return
            wake.wait(ms / 1000.0)
            self._finish(prof, path)

        self._thread = threading.Thread(target=_run, name="prof-capture", daemon=True)
        self._thread.start()
        return True, path

    def _crash_stop(self) -> None:
        self.stop()

    def close(self) -> None:
        """Stop any in-flight capture and unhook from the crash path."""
        self.stop()
        flightrec.remove_crash_hook(self._crash_stop)
