"""SEED-style batched acting server — the port of
``tpu_rl.runtime.inference_service.InferenceService``.

Workers send one ``ObsRequest`` per tick (the tick's observations and
episode-first flags; the recurrent carry never rides the request). Requests
accumulate until ``Config.inference_batch`` rows are pending or the oldest is
``Config.inference_flush_us`` old; then each chunk of whole clients is padded
to the smallest covering bucket of the power-of-two ladder
(``Config.inference_buckets``) and runs ONE act step on the device. The
service keeps each client's LSTM carry, zeroed where the request flags an
episode first, and answers every request with one ``Act`` reply
``{"seq", "act", "logits", "log_prob", "ver", "hx", "cx"}`` (``hx``/``cx``
are the pre-step carry rows the learner trains from).

A flush stages obs, first and the gathered carries into one pinned host
buffer at the bucket's padded shape, makes one host-to-device copy, runs the
act step (``Config.act_kernel``: the fused CUDA kernel, or the unfused module
forward) and brings every output back in one device-to-host copy.

The router is passed in: anything with ``recv(timeout_ms)``, ``drain()`` and
``send(identity, proto, payload)`` — :class:`~tpu_rl_torch.runtime.local_router.LocalRouter`
in this slice. The service runs on ``device="cuda"`` unless the caller passes
``device="cpu"``.
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
from tpu_rl_torch.models.quant import make_act_fn
from tpu_rl_torch.runtime.protocol import Protocol
from tpu_rl_torch.utils.timer import ExecutionTimer


class _ClientState:
    """Per-identity acting state: the env-slot carries (host rows) and the
    row count the client established on first contact."""

    __slots__ = ("n", "h", "c")

    def __init__(self, n: int, h: np.ndarray, c: np.ndarray):
        self.n = n
        self.h = h
        self.c = c


class _Pending:
    __slots__ = ("identity", "seq", "obs", "first", "arrived")

    def __init__(self, identity: bytes, seq: int, obs, first, arrived: float):
        self.identity = identity
        self.seq = seq
        self.obs = obs
        self.first = first
        self.arrived = arrived


class _Staging:
    """Host buffers of one bucket: the inputs ``[obs | first | h | c]`` and
    the outputs ``[act | logits | log_prob | h_pre | c_pre | h2 | c2]``, each
    one flat (pinned, on CUDA) buffer so a flush makes one copy each way."""

    def __init__(self, rows: int, obs_dim: int, hw: int, cw: int, n_actions: int, pin: bool):
        self.rows = rows
        self.in_shapes = [(rows, obs_dim), (rows,), (rows, hw), (rows, cw)]
        self.out_shapes = [
            (rows, 1), (rows, n_actions), (rows, 1), (rows, hw), (rows, cw), (rows, hw), (rows, cw)
        ]
        self.in_host = torch.zeros(_numel(self.in_shapes), pin_memory=pin)
        self.out_host = torch.zeros(_numel(self.out_shapes), pin_memory=pin)
        self.obs, self.first, self.h, self.c = _views(self.in_host.numpy(), self.in_shapes)

    def reset(self) -> None:
        """All rows to padding: zero obs and carry, ``first=1``."""
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
        if cfg.model != "lstm":
            raise NotImplementedError(
                f"model={cfg.model!r}: serving the transformer comes with the "
                "transformer-serving slice of the port"
            )
        self.cfg = cfg
        self.family = family
        self.router = router
        self.timer = timer or ExecutionTimer()
        self.seed = seed
        self._params = to_device_params(params, self.device)
        # Policy version of the params served, echoed in every reply ("ver").
        self._version = version
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._ready = threading.Event()  # set once every bucket ran
        self._lock = threading.Lock()  # guards the params slot
        self.clients: dict[bytes, _ClientState] = {}
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

    # --------------------------------------------------------------- control
    def start(self) -> "InferenceService":
        self._thread = threading.Thread(target=self._serve, name="inference-service", daemon=True)
        self._thread.start()
        return self

    def wait_ready(self, timeout: float = 60.0) -> bool:
        """Block until every bucket has run once (so the first request pays
        no kernel build or first-launch cost)."""
        return self._ready.wait(timeout)

    def set_params(self, params, version: int = -1) -> None:
        """Swap the served policy. The new device tensors are built and
        finished OUTSIDE the lock; under it only one reference is assigned,
        so a flush reading the old tensors is never written into. The next
        flush acts with the new weights and replies echo ``version``."""
        new = to_device_params(params, self.device)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        with self._lock:
            self._params = new
            self._version = version

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
                hw, cw = self.family.carry_widths
                staging = {
                    rows: _Staging(
                        rows, int(self.cfg.obs_shape[0]), hw, cw, self.family.n_actions,
                        pin=self.device.type == "cuda",
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
        """The padded act step. Zero the carry rows whose env just reset —
        with ``where``, never a multiply, so a NaN carry cannot survive a
        reset — and return the zeroed pre-step carry beside the post-step
        one."""
        keep = (first < 0.5)[:, None]
        h = torch.where(keep, h, 0.0)
        c = torch.where(keep, c, 0.0)
        a, logits, log_prob, h2, c2 = act(params, obs, h, c, generator)
        return a, logits, log_prob, h, c, h2, c2

    def _run(self, act, st: _Staging, params, generator) -> list[np.ndarray]:
        """One host-to-device copy, one act step, one device-to-host copy.
        Returns host copies of the outputs, in ``_Staging.out_shapes``."""
        dev_in = st.in_host.to(self.device, non_blocking=True)
        obs, first, h, c = _views(dev_in, st.in_shapes)
        outs = self._step(act, params, obs, h, c, first, generator)
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
            params = self._params
        generator = torch.Generator(self.device).manual_seed(self.seed)
        for st in staging.values():
            st.reset()
            self._run(act, st, params, generator)

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
        while not self._stop.is_set():
            # Bounded wait: until the flush deadline when requests are
            # pending (fractional ms: a sub-ms deadline is not truncated to
            # a busy poll), a housekeeping tick otherwise.
            if pending:
                budget = flush_s - (time.perf_counter() - pending[0].arrived)
                timeout_ms = max(0.0, budget * 1e3)
            else:
                timeout_ms = 20.0
            got = router.recv(timeout_ms=timeout_ms)
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
                self._flush(act, staging[bucket], chunk, rows, generator)
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
            hw, cw = self.family.carry_widths
            n = obs.shape[0]
            client = _ClientState(n, np.zeros((n, hw), np.float32), np.zeros((n, cw), np.float32))
            self.clients[identity] = client
        return _Pending(identity, seq, obs, first, time.perf_counter())

    # ----------------------------------------------------------------- flush
    def _flush(self, act, st: _Staging, chunk: list[_Pending], rows: int, generator) -> None:
        t0 = time.perf_counter()
        st.reset()
        off = 0
        offsets = []
        for req in chunk:
            n = req.obs.shape[0]
            client = self.clients[req.identity]
            st.obs[off:off + n] = req.obs
            st.first[off:off + n] = req.first
            st.h[off:off + n] = client.h
            st.c[off:off + n] = client.c
            offsets.append(off)
            off += n
        with self._lock:
            params = self._params
            version = self._version
        a, logits, log_prob, h_pre, c_pre, h2, c2 = self._run(act, st, params, generator)
        # Counted before the replies go out, so a client that holds its reply
        # also sees the flush counted.
        self.n_batches += 1
        self.n_flush_bucket[st.rows] = self.n_flush_bucket.get(st.rows, 0) + 1
        for req, off in zip(chunk, offsets, strict=True):
            n = req.obs.shape[0]
            client = self.clients[req.identity]
            client.h = h2[off:off + n]
            client.c = c2[off:off + n]
            reply = {
                "seq": req.seq,
                "act": a[off:off + n],
                "logits": logits[off:off + n],
                "log_prob": log_prob[off:off + n],
                "ver": version,
            }
            if self.family.store_carry:
                reply["hx"] = h_pre[off:off + n]
                reply["cx"] = c_pre[off:off + n]
            self.router.send(req.identity, Protocol.Act, reply)
            self.n_replies += 1
        self.timer.record_gauge("inference-batch-size", rows)
        self.timer.record("inference-step-time", time.perf_counter() - t0)
