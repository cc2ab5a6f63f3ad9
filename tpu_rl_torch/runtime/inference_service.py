"""SEED-style batched acting server — the port of
``tpu_rl.runtime.inference_service.InferenceService``.

Workers send one ``ObsRequest`` per tick (the tick's observations and
episode-first flags; the recurrent carry never rides the request). Requests
accumulate until ``Config.inference_batch`` rows are pending or the oldest is
``Config.inference_flush_us`` old; then each chunk of whole clients is padded
to the smallest covering bucket of the power-of-two ladder
(``Config.inference_buckets``) and runs ONE act step on the device. The
service keeps each client's acting carry (the LSTM's (h, c), or the
transformer's K/V caches and step counter), zeroed where the request flags
an episode first, and answers every request with one ``Act`` reply
``{"seq", "act", "logits", "log_prob", "ver"}``, plus ``"hx", "cx"`` (the
pre-step carry rows the learner trains from) for a family that stores its
carry (``family.store_carry``; not the transformer's).

Every client's carry rows live on the service's device, in one table
(:class:`_CarryTable`): a client owns ``n`` consecutive rows from its first
contact on, and gives them back when it changes its row count. A flush
stages obs, first and each row's table index into one pinned host buffer at
the bucket's padded shape and makes one host-to-device copy; on the card it
gathers the carry rows by index, runs the act step (``Config.act_kernel``:
the fused CUDA kernel, or the unfused module forward), scatters the
post-step carry back into the table, and brings act, logits and log-prob
(and, where stored, the pre-step carry) back in one device-to-host copy. No
carry crosses the bus on its way into a flush, which matters for the
transformer: at ``act_ctx`` 512, hidden 256 and 4 layers its K/V caches are
4 MiB a row.

The served params are kept at ``Config.inference_dtype``
(:func:`~tpu_rl_torch.models.quant.quantize_tree`: f32, bf16 or int8),
quantized when the service takes them, and widened to f32 inside each act
step before the act computation runs; ``param_bytes`` is their size.

With the telemetry plane on (``cfg.telemetry_enabled``), the serve thread
keeps a goodput ledger (compute, idle, queue-wait and wire time around the
batching loop) and one :class:`~tpu_rl_torch.obs.PerfTracker` per bucket,
which counts the FLOPs of that bucket's warm-up call (the fused kernel is
charged its formula) and watches its argument signatures: ``recompiles``
sums them, and stays 0 while every flush runs at a warmed bucket's shape.
:meth:`InferenceService.publish_serving_metrics` replays the counters into
a metrics registry. With a chaos plan naming the service,
``stall:inference`` sleeps before each flush and ``refuse:inference``
swallows replies (the client times out and falls back); ``chaos`` holds
the injector and its counts.

The router is passed in: anything with ``recv(timeout_ms)``, ``drain()`` and
``send(identity, proto, payload)`` — the in-process
:class:`~tpu_rl_torch.runtime.local_router.LocalRouter`, or the learner's
:class:`~tpu_rl_torch.runtime.transport.Router` on ``inference_port``, which
workers reach through :class:`InferenceClient` (a DEALER). The service runs
on ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from contextlib import nullcontext

import numpy as np
import torch

from tpu_rl_torch import resolve_device
from tpu_rl_torch.config import Config
from tpu_rl_torch.models.families import to_device_params
from tpu_rl_torch.models.quant import dequantize_tree, make_act_fn, quantize_tree, tree_bytes
from tpu_rl_torch.obs.goodput import COMPUTE, IDLE, QUEUE_WAIT, WIRE, GoodputLedger
from tpu_rl_torch.obs.perf import PerfTracker, signature
from tpu_rl_torch.runtime.protocol import Protocol
from tpu_rl_torch.utils.timer import ExecutionTimer


class _CarryTable:
    """The carry rows of every client on the service's device: ``h`` (rows,
    hw) and ``c`` (rows, cw). Row 0 belongs to padding: a padding row is
    always reset before use and never written back, so its contents are
    never read. A client holds one range of rows; a range given back goes
    on the free list (merged with its free neighbours, or returned to the
    unused tail) and is handed out again before the table grows. The table
    grows by doubling, so a growth briefly holds the old table beside the
    new one. Rows are zeroed when they are handed out."""

    def __init__(self, hw: int, cw: int, device: torch.device):
        self.h = torch.zeros((1, hw), device=device)
        self.c = torch.zeros((1, cw), device=device)
        self.rows = 1  # the end of the rows in use or on the free list
        self.free: list[tuple[int, int]] = []  # (first row, count), ascending, never adjacent

    def alloc(self, n: int) -> int:
        """The first of ``n`` zeroed rows: the first free range that holds
        them, else the unused tail."""
        for i, (base, m) in enumerate(self.free):
            if m >= n:
                if m == n:
                    del self.free[i]
                else:
                    self.free[i] = (base + n, m - n)
                break
        else:
            base, need = self.rows, self.rows + n
            if need > self.h.shape[0]:
                cap = max(need, 2 * self.h.shape[0])
                self.h, self.c = (
                    torch.cat([t, t.new_zeros((cap - t.shape[0], t.shape[1]))])
                    for t in (self.h, self.c)
                )
            self.rows = need
        self.h[base:base + n] = 0.0
        self.c[base:base + n] = 0.0
        return base

    def release(self, base: int, n: int) -> None:
        """Give rows ``base .. base + n`` back."""
        free = sorted([*self.free, (base, n)])
        merged: list[tuple[int, int]] = []
        for b, m in free:
            if merged and merged[-1][0] + merged[-1][1] == b:
                merged[-1] = (merged[-1][0], merged[-1][1] + m)
            else:
                merged.append((b, m))
        if merged and merged[-1][0] + merged[-1][1] == self.rows:
            self.rows = merged.pop()[0]
        self.free = merged

    @property
    def nbytes(self) -> int:
        return self.h.nbytes + self.c.nbytes


class _ClientState:
    """Per-identity acting state: the row count the client established on
    first contact and its first row in the carry table. ``h``/``c`` read
    (host copies) and write the client's carry rows."""

    __slots__ = ("n", "base", "table")

    def __init__(self, n: int, base: int, table: _CarryTable):
        self.n = n
        self.base = base
        self.table = table

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.base:self.base + self.n]

    @property
    def h(self) -> np.ndarray:
        return self._rows(self.table.h).cpu().numpy()

    @h.setter
    def h(self, value) -> None:
        with torch.inference_mode():  # the serve thread made the table there
            self._rows(self.table.h).copy_(torch.as_tensor(np.asarray(value, np.float32)))

    @property
    def c(self) -> np.ndarray:
        return self._rows(self.table.c).cpu().numpy()

    @c.setter
    def c(self, value) -> None:
        with torch.inference_mode():  # the serve thread made the table there
            self._rows(self.table.c).copy_(torch.as_tensor(np.asarray(value, np.float32)))


class _Pending:
    __slots__ = ("identity", "seq", "obs", "first", "arrived")

    def __init__(self, identity: bytes, seq: int, obs, first, arrived: float):
        self.identity = identity
        self.seq = seq
        self.obs = obs
        self.first = first
        self.arrived = arrived


class _Staging:
    """Host buffers of one bucket: the inputs ``[obs | first | slot]`` (slot:
    each row's carry-table index, as a float, exact below 2**24 rows) and the
    outputs ``[act | logits | log_prob]``, plus ``[h_pre | c_pre]`` where
    the family stores its carry; each one flat (pinned, on CUDA) buffer so a
    flush makes one copy each way."""

    def __init__(
        self, rows: int, obs_dim: int, carry: tuple[int, int] | None, n_actions: int, wide: int,
        pin: bool,
    ):
        self.rows = rows
        self.in_shapes = [(rows, obs_dim), (rows,), (rows,)]
        # act and log_prob: 1 wide for a categorical policy, A for a Gaussian
        self.out_shapes = [(rows, wide), (rows, n_actions), (rows, wide)]
        if carry is not None:
            self.out_shapes += [(rows, carry[0]), (rows, carry[1])]
        self.in_host = torch.zeros(_numel(self.in_shapes), pin_memory=pin)
        self.out_host = torch.zeros(_numel(self.out_shapes), pin_memory=pin)
        self.obs, self.first, self.slot = _views(self.in_host.numpy(), self.in_shapes)

    def reset(self) -> None:
        """All rows to padding: zero obs, ``first=1``, the padding row."""
        self.in_host.zero_()
        self.first[:] = 1.0


def _numel(shapes) -> int:
    return sum(int(np.prod(s)) for s in shapes)


def _views(flat, shapes) -> list:
    out, off = [], 0
    for s in shapes:
        n = int(np.prod(s))
        out.append(flat[off:off + n].reshape(s))
        off += n
    return out


class InferenceService:
    """Batched acting server. ``start()`` spawns the serve thread;
    ``set_params`` swaps the policy in-process; ``close()`` stops the
    thread. The router belongs to the caller and is not closed here.

    ``timer`` receives the ``inference-batch-size`` gauge and the
    ``inference-step-time`` span of every flush."""

    def __init__(
        self,
        cfg: Config,
        family,
        params,
        router,
        timer: ExecutionTimer | None = None,
        seed: int = 0,
        version: int = -1,
        device: str | torch.device | None = "cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.family = family
        self.router = router
        self.timer = timer or ExecutionTimer()
        self.seed = seed
        self._params = self._quantize(params)
        # The served params' shapes, dtypes and devices, taken once per swap:
        # the part of an act step's argument signature a flush cannot change.
        self._params_sig = signature(self._params)
        # Bytes of the served params (tpu_rl's inference-param-bytes gauge).
        self.param_bytes = tree_bytes(self._params)
        # Policy version of the params served, echoed in every reply ("ver").
        self._version = version
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._ready = threading.Event()  # set once every bucket ran
        self._lock = threading.Lock()  # guards the params slot
        self.clients: dict[bytes, _ClientState] = {}
        self._table = _CarryTable(*family.carry_widths, self.device)
        # Bytes copied host to device by flushes and warm-ups: obs, first and
        # the slot indices, never a carry.
        self.h2d_bytes = 0
        self.n_requests = 0
        self.n_replies = 0
        self.n_batches = 0
        self.n_flush_full = 0
        self.n_flush_deadline = 0
        self.n_rejected_payload = 0
        # Per-bucket flush counts {bucket_rows: n}.
        self.n_flush_bucket: dict[int, int] = {}
        self.buckets: list[int] = []
        self.error: BaseException | None = None
        # Telemetry (built by the serve thread iff cfg.telemetry_enabled):
        # one tracker per bucket, the serve thread's goodput ledger, and the
        # per-bucket flush counts already replayed into a registry's
        # histogram.
        self.perf_buckets: dict[int, PerfTracker] = {}
        self.ledger: GoodputLedger | None = None
        self._hist_emitted: dict[int, int] = {}
        # Service-level fault injection (tpu_rl_torch.chaos): None unless
        # cfg.chaos_spec names this service.
        self.chaos = None
        if getattr(cfg, "chaos_spec", None):
            from tpu_rl_torch.chaos import maybe_service_chaos

            self.chaos = maybe_service_chaos(cfg)

    # --------------------------------------------------------------- control
    def start(self) -> "InferenceService":
        self._thread = threading.Thread(target=self._serve, name="inference-service", daemon=True)
        self._thread.start()
        return self

    def wait_ready(self, timeout: float = 60.0) -> bool:
        """Block until every bucket has run once (so the first request pays
        no kernel build or first-launch cost)."""
        return self._ready.wait(timeout)

    def _quantize(self, params):
        """Device copies of ``params`` at the serving precision
        (``Config.inference_dtype``; idempotent, so a tree that is already
        quantized is not scaled twice)."""
        return quantize_tree(to_device_params(params, self.device), self.cfg.inference_dtype)

    def set_params(self, params, version: int = -1) -> None:
        """Swap the served policy. The new device tensors are built,
        quantized and finished OUTSIDE the lock; under it only one reference
        is assigned, so a flush reading the old tensors is never written
        into. The next flush acts with the new weights and replies echo
        ``version``."""
        new = self._prepare(params)
        with self._lock:
            self._install(new, version)

    def _prepare(self, params):
        """The served copy of ``params``, quantized, its copies finished."""
        new = self._quantize(params)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return new

    def _install(self, new, version: int) -> None:
        """Serve ``new`` from the next flush on (the caller holds the lock)."""
        self._params = new
        self._params_sig = signature(new)
        self._version = version
        self.param_bytes = tree_bytes(new)

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    # ----------------------------------------------------------------- serve
    def _serve(self) -> None:
        try:
            on_card = (
                torch.cuda.device(self.device) if self.device.type == "cuda" else nullcontext()
            )
            with torch.inference_mode(), on_card:
                act = make_act_fn(self.cfg, self.family)
                self.buckets = self._bucket_ladder()
                fam = self.family
                staging = {
                    rows: _Staging(
                        rows, int(self.cfg.obs_shape[0]),
                        fam.carry_widths if fam.store_carry else None, fam.n_actions,
                        fam.n_actions if fam.continuous else 1, pin=self.device.type == "cuda",
                    )
                    for rows in self.buckets
                }
                self._warm(act, staging)
                generator = torch.Generator(self.device).manual_seed(self.seed * 7919 + 17)
                self._ready.set()
                self._loop(act, staging, generator)
        except BaseException as e:  # surfaced via .error, then re-raised
            self.error = e
            self._ready.set()  # never leave wait_ready() hanging
            raise

    def _step(self, act, params, obs, h, c, first, generator):
        """The padded act step. Widen the served params to f32; zero the
        carry rows whose env just reset — with ``where``, never a multiply,
        so a NaN carry cannot survive a reset — and return the zeroed
        pre-step carry beside the post-step one."""
        params = dequantize_tree(params)
        keep = (first < 0.5)[:, None]
        h = torch.where(keep, h, 0.0)
        c = torch.where(keep, c, 0.0)
        a, logits, log_prob, h2, c2 = act(params, obs, h, c, generator)
        return a, logits, log_prob, h, c, h2, c2

    def _run(
        self, act, st: _Staging, rows: int, params, params_sig, generator,
        write: np.ndarray | None = None,
    ) -> list[np.ndarray]:
        """One host-to-device copy; on the device the carry rows gathered
        from the table, one act step, the first ``rows`` rows' post-step
        carry scattered back (only rows ``write`` when given: see
        ``_flush``); one device-to-host copy. Returns host copies of the
        outputs, in ``_Staging.out_shapes``. With telemetry on, the bucket's
        tracker watches the step's argument signature: ``params_sig`` (taken
        when the params were swapped in) and the step's tensors' own, not a
        walk of the params tree."""
        dev_in = st.in_host.to(self.device, non_blocking=True)
        self.h2d_bytes += st.in_host.nbytes
        obs, first, slot = _views(dev_in, st.in_shapes)
        slot = slot.long()
        table = self._table
        h, c = table.h[slot], table.c[slot]
        tracker = self.perf_buckets.get(st.rows)
        if tracker is not None:
            sig = (params_sig, signature((obs, h, c, first)))
            outs = tracker.call(self._step, act, params, obs, h, c, first, generator, sig=sig)
        else:
            outs = self._step(act, params, obs, h, c, first, generator)
        a, logits, log_prob, h_pre, c_pre, h2, c2 = outs
        if write is None:
            table.h[slot[:rows]] = h2[:rows]
            table.c[slot[:rows]] = c2[:rows]
        else:
            w = torch.from_numpy(write).to(self.device, non_blocking=True)
            self.h2d_bytes += write.nbytes
            table.h[slot[w]] = h2[w]
            table.c[slot[w]] = c2[w]
        outs = (a, logits, log_prob, h_pre, c_pre)[:len(st.out_shapes)]
        st.out_host.copy_(torch.cat([t.reshape(-1) for t in outs]), non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return _views(st.out_host.numpy().copy(), st.out_shapes)

    def _bucket_ladder(self) -> list[int]:
        """Padded-batch shapes, ascending. ``inference_buckets = 0`` is the
        single fixed shape ``max(inference_batch, worker_num_envs)``; > 0 is
        the power-of-two ladder from that floor up to pad_rows."""
        cfg = self.cfg
        pad_rows = max(cfg.inference_batch, cfg.worker_num_envs)
        floor = int(cfg.inference_buckets)
        if floor <= 0 or floor >= pad_rows:
            return [pad_rows]
        b = 1
        while b < floor:
            b *= 2
        ladder = []
        while b < pad_rows:
            ladder.append(b)
            b *= 2
        ladder.append(pad_rows)
        return ladder

    def _warm(self, act, staging: dict[int, _Staging]) -> None:
        """Run EVERY bucket once before ``_ready`` is set: the kernel builds
        and the first launch of each shape happens here, not inside a
        client's timeout. A generator of its own keeps the serving stream's
        draws independent of the ladder."""
        with self._lock:
            params, params_sig = self._params, self._params_sig
        if self.cfg.telemetry_enabled:
            self.ledger = GoodputLedger("inference")
            # Each bucket's warm-up is its tracker's first call: its FLOPs
            # are counted there, at the only shape that bucket dispatches.
            self.perf_buckets = {rows: PerfTracker(self.device) for rows in staging}
        generator = torch.Generator(self.device).manual_seed(self.seed)
        for st in staging.values():
            st.reset()
            self._run(act, st, 0, params, params_sig, generator)

    @property
    def carry_bytes(self) -> int:
        """Bytes of the carry table on the service's device (every client's
        rows, the padding row and the room grown for more)."""
        return self._table.nbytes

    @property
    def recompiles(self) -> int:
        """Act-step argument signatures after each bucket's warm-up, summed
        over the buckets (``inference-xla-recompiles``); 0 when telemetry
        is off (no watches)."""
        return sum(t.recompiles for t in self.perf_buckets.values())

    def publish_serving_metrics(self, registry) -> None:
        """Replay the serving counters into a MetricsRegistry (called by
        whoever owns it). Cumulative counters use set_total; the bucket
        histogram replays per-bucket flush-count deltas, so repeated calls
        never observe a flush twice."""
        registry.counter("inference-xla-recompiles").set_total(self.recompiles)
        registry.gauge("inference-param-bytes").set(self.param_bytes)
        hist = registry.histogram("inference-bucket-rows")
        for rows, n in list(self.n_flush_bucket.items()):
            registry.counter("inference-bucket-flushes", labels={"rows": str(rows)}).set_total(n)
            prev = self._hist_emitted.get(rows, 0)
            if n > prev:
                hist.observe_n(rows, n - prev)
                self._hist_emitted[rows] = n

    def _loop(self, act, staging: dict[int, _Staging], generator) -> None:
        """Max-batch-or-deadline dynamic batching into the smallest covering
        bucket, whole clients per chunk."""
        cfg = self.cfg
        router = self.router
        buckets = self.buckets
        pad_rows = buckets[-1]  # chunk capacity = the largest bucket
        pending: list[_Pending] = []
        pending_rows = 0
        flush_s = cfg.inference_flush_us / 1e6
        ledger = self.ledger
        while not self._stop.is_set():
            # Bounded wait: until the flush deadline when requests are
            # pending (fractional ms: a sub-ms deadline is not truncated to
            # a busy poll), a housekeeping tick otherwise.
            if pending:
                budget = flush_s - (time.perf_counter() - pending[0].arrived)
                timeout_ms = max(0.0, budget * 1e3)
            else:
                timeout_ms = 20.0
            t_recv = time.perf_counter()
            got = router.recv(timeout_ms=timeout_ms)
            if ledger is not None:
                # Holding a partial batch for the deadline is queue-wait; a
                # bare poll that delivered a request is wire; a bare
                # timeout is idle.
                recv_bucket = QUEUE_WAIT if pending else (WIRE if got is not None else IDLE)
                ledger.add(recv_bucket, time.perf_counter() - t_recv)
            if got is not None:
                for parts in (got, *router.drain()):
                    req = self._ingest(*parts)
                    if req is not None:
                        pending.append(req)
                        pending_rows += req.obs.shape[0]
            if not pending:
                continue
            full = pending_rows >= cfg.inference_batch
            expired = time.perf_counter() - pending[0].arrived >= flush_s
            if not (full or expired):
                continue
            self.n_flush_full += 1 if full else 0
            self.n_flush_deadline += 0 if full else 1
            # Whole-client chunks of at most pad_rows rows; a burst larger
            # than one bucket drains over back-to-back flushes.
            while pending:
                chunk, rows = [], 0
                while pending and rows + pending[0].obs.shape[0] <= pad_rows:
                    req = pending.pop(0)
                    chunk.append(req)
                    rows += req.obs.shape[0]
                pending_rows -= rows
                bucket = buckets[bisect_left(buckets, rows)]
                t_fl = time.perf_counter()
                self._flush(act, staging[bucket], chunk, rows, generator)
                if ledger is not None:
                    ledger.add(COMPUTE, time.perf_counter() - t_fl)
                if rows < cfg.inference_batch:
                    break  # partial tail came from the deadline, done

    # ---------------------------------------------------------------- ingest
    def _ingest(self, identity: bytes, proto: Protocol, payload) -> _Pending | None:
        """Validate one request and establish the client's carry slots on
        first contact. A bad payload is dropped and counted, never raised:
        one bad client must not kill the acting path."""
        if proto != Protocol.ObsRequest or not isinstance(payload, dict):
            self.n_rejected_payload += 1
            return None
        try:
            obs = np.asarray(payload["obs"], np.float32)
            first = np.asarray(payload["first"], np.float32).reshape(-1)
            seq = int(payload["seq"])
        except (KeyError, TypeError, ValueError):
            self.n_rejected_payload += 1
            return None
        if (
            obs.ndim != 2
            or obs.shape[0] != first.shape[0]
            or obs.shape[1] != int(self.cfg.obs_shape[0])
            or not 1 <= obs.shape[0] <= self.buckets[-1]
        ):
            self.n_rejected_payload += 1
            return None
        self.n_requests += 1
        client = self.clients.get(identity)
        if client is None or client.n != obs.shape[0]:
            # fresh zero rows: a client that changes its row count starts
            # over, as in tpu_rl, and gives its old rows back first
            if client is not None:
                self._table.release(client.base, client.n)
            n = obs.shape[0]
            client = _ClientState(n, self._table.alloc(n), self._table)
            self.clients[identity] = client
        return _Pending(identity, seq, obs, first, time.perf_counter())

    # ----------------------------------------------------------------- flush
    def _flush(self, act, st: _Staging, chunk: list[_Pending], rows: int, generator) -> None:
        if self.chaos is not None:
            self.chaos.maybe_stall()
        t0 = time.perf_counter()
        st.reset()
        off = 0
        offsets = []
        last: dict[bytes, int] = {}  # each client's last request in the chunk
        for i, req in enumerate(chunk):
            n = req.obs.shape[0]
            base = self.clients[req.identity].base
            st.obs[off:off + n] = req.obs
            st.first[off:off + n] = req.first
            st.slot[off:off + n] = np.arange(base, base + n)
            offsets.append(off)
            last[req.identity] = i
            off += n
        # A client with two requests in one chunk (a retry, or one DEALER
        # carrying many synthetic clients): each acts from the same pre-step
        # carry and the later one's post-step carry is kept, as in tpu_rl.
        write = None
        if len(last) < len(chunk):
            write = np.concatenate([
                np.arange(o, o + r.obs.shape[0])
                for i, (r, o) in enumerate(zip(chunk, offsets)) if last[r.identity] == i
            ])
        with self._lock:
            params, params_sig, version = self._params, self._params_sig, self._version
        a, logits, log_prob, *carry = self._run(
            act, st, rows, params, params_sig, generator, write)
        # Counted before the replies go out, so a client that holds its reply
        # also sees the flush counted.
        self.n_batches += 1
        self.n_flush_bucket[st.rows] = self.n_flush_bucket.get(st.rows, 0) + 1
        for req, off in zip(chunk, offsets, strict=True):
            n = req.obs.shape[0]
            reply = {
                "seq": req.seq,
                "act": a[off:off + n],
                "logits": logits[off:off + n],
                "log_prob": log_prob[off:off + n],
                "ver": version,
            }
            if carry:
                reply["hx"] = carry[0][off:off + n]
                reply["cx"] = carry[1][off:off + n]
            if self.chaos is not None and self.chaos.refuse():
                # Swallowed reply: the client burns a timeout and retries or
                # falls back; n_replies counts replies sent. The carry already
                # advanced, as it does for a reply lost on the wire.
                continue
            self.router.send(req.identity, Protocol.Act, reply)
            self.n_replies += 1
        self.timer.record_gauge("inference-batch-size", rows)
        flush_secs = time.perf_counter() - t0
        self.timer.record("inference-step-time", flush_secs)
        tracker = self.perf_buckets.get(st.rows)
        if tracker is not None:
            tracker.note(flush_secs)


class InferenceClient:
    """Worker-side remote-acting client — the port of ``tpu_rl``'s: one
    in-flight request per tick (send, then a timed receive) over a
    :class:`~tpu_rl_torch.runtime.transport.Dealer`, correlated by a
    monotonically increasing ``seq`` echo; stale replies (a retry's ghost)
    are skipped by seq.

    ``act`` returns the reply payload dict, or None once
    ``Config.inference_retries`` retries have all timed out
    (``Config.inference_timeout_ms`` each): the caller's cue to fall back
    to local acting. Retries resend the same seq: if the server did serve
    the lost reply, its carry advanced once more than the episode."""

    def __init__(
        self,
        cfg: Config,
        ip: str,
        port: int,
        wid: int = 0,
        identity: bytes | None = None,
        timer: ExecutionTimer | None = None,
    ):
        import uuid

        from tpu_rl_torch.runtime.transport import Dealer

        self.cfg = cfg
        self.wid = wid
        self.timer = timer
        self.seq = 0
        self.n_timeouts = 0
        # Unique per socket across worker restarts: a restarted worker
        # reusing a dead identity would inherit the old carry rows.
        self.dealer = Dealer(
            ip, port,
            identity=identity or f"w{wid}-{uuid.uuid4().hex[:8]}".encode(),
        )

    @property
    def n_rejected(self) -> int:
        """Corrupt/foreign replies dropped by the DEALER."""
        return self.dealer.n_rejected

    def act(
        self,
        obs: np.ndarray,
        first: np.ndarray,
        retries: int | None = None,
    ) -> dict | None:
        """``retries`` overrides ``Config.inference_retries`` for this call
        (the worker's re-probe uses 0)."""
        cfg = self.cfg
        attempts = (cfg.inference_retries if retries is None else int(retries)) + 1
        req = {"wid": self.wid, "seq": self.seq, "obs": obs, "first": first}
        t0 = time.perf_counter()
        try:
            for _attempt in range(attempts):
                self.dealer.send(Protocol.ObsRequest, req)
                deadline = time.perf_counter() + cfg.inference_timeout_ms / 1e3
                while True:
                    left_ms = int((deadline - time.perf_counter()) * 1e3)
                    if left_ms <= 0:
                        break
                    got = self.dealer.recv(timeout_ms=left_ms)
                    if got is None:
                        continue  # a rejected frame burned some budget; keep waiting
                    proto, payload = got
                    if proto != Protocol.Act or not isinstance(payload, dict):
                        continue
                    if payload.get("seq") != self.seq:
                        continue  # stale ghost of an earlier retry
                    if self.timer is not None:
                        self.timer.record("inference-rtt", time.perf_counter() - t0)
                    return payload
                self.n_timeouts += 1
            return None
        finally:
            self.seq += 1

    def close(self) -> None:
        self.dealer.close()
