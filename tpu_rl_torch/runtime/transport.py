"""PUB/SUB and ROUTER/DEALER transport wrappers — the port of
``tpu_rl.runtime.transport``.

Every channel is created from one place and always carries
:mod:`~tpu_rl_torch.runtime.protocol` frames. ``tpu_rl`` builds its TCP
channels on pyzmq; the port builds the same classes, with the same methods,
on :mod:`~tpu_rl_torch.runtime.zmtp`, which speaks libzmq's wire (ZMTP 3.0,
NULL mechanism) over stdlib sockets. A port process and a ``tpu_rl``
process therefore talk to each other, and the port runs where pyzmq is not
installed. PUB/SUB is deliberately best-effort and connection-free: the
algorithms absorb drops and workers join and leave freely.

The topology:

- rollout/stat channel: worker PUB -> manager SUB (bind) -> manager PUB ->
  storage SUB (bind). ``Protocol.Telemetry`` snapshots ride it too; the
  learner publishes its own straight onto the storage SUB;
- model channel: learner PUB (bind) -> every worker SUB, on ``model_port =
  learner_port + 1``;
- acting channel (``act_mode="remote"``): worker DEALER -> the learner's
  ROUTER on ``learner_port + 2``.

Same-host data hops can instead go through shared-memory rings
(:class:`ShmPub` / :class:`ShmConsumer` / :class:`FanInSub`, copied from
``tpu_rl``), selected by ``Config.transport``.
"""

from __future__ import annotations

import asyncio
import secrets
import struct
import time
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Iterator

from tpu_rl_torch.runtime import native
from tpu_rl_torch.runtime.protocol import (
    MAX_PROTO,
    TRACE_KINDS_MASK,
    Protocol,
    decode,
    encode,
    peek,
)
from tpu_rl_torch.runtime.zmtp import DEALER, PUB, ROUTER, SUB, ZSocket

# Keep only the newest model broadcast in flight (a worker that lags wants the
# freshest params, not a backlog); rollout channels buffer more.
MODEL_HWM = 4
DATA_HWM = 4096


def _open(kind: str, ip: str, port: int, bind: bool, hwm: int,
          identity: bytes | None = None) -> ZSocket:
    sock = ZSocket(kind, hwm=hwm, identity=identity)
    try:
        if bind:
            sock.bind(ip, port)
        else:
            sock.connect(ip, port)
    except BaseException:
        sock.close()
        raise
    return sock


# -------------------------------------------------------- batch validation
# A drained deque is validated in ONE native call (tpurl_validate_batch in
# the package's native/codec.cpp, GIL released for the whole batch) instead
# of a Python peek()/CRC pass per frame. The per-frame Python path stays as
# the no-toolchain fallback and as the A/B baseline (native_batch=False).
# no-toolchain fallback and as the bench A/B baseline (native_batch=False).


def _validate_raw(
    frames: list[list[bytes]], use_native: bool
) -> tuple[list[tuple[Protocol, list[bytes]]], int]:
    """peek-grade validation of many frames -> (valid, n_rejected)."""
    if use_native and native.available():
        verdicts = native.validate_batch(frames, TRACE_KINDS_MASK, MAX_PROTO)
        out = [
            (Protocol(parts[0][0]), parts)
            for parts, v in zip(frames, verdicts, strict=True)
            if v == 0
        ]
        return out, len(frames) - len(out)
    out, rejected = [], 0
    for parts in frames:
        try:
            out.append((peek(parts), parts))
        except ValueError:
            rejected += 1
    return out, rejected


def _validate_traced(
    frames: list[list[bytes]], use_native: bool
) -> tuple[list[tuple[Protocol, Any, bytes | None]], int]:
    """Full storage-edge validation + decode of many frames. The native path
    CRCs every body in one call, then ``decode(validated=True)`` skips the
    per-frame re-hash; decompress/unpack errors still reject."""
    out: list[tuple[Protocol, Any, bytes | None]] = []
    rejected = 0
    if use_native and native.available():
        verdicts = native.validate_batch(
            frames, TRACE_KINDS_MASK, MAX_PROTO, check_crc=True
        )
        for parts, v in zip(frames, verdicts, strict=True):
            if v != 0:
                rejected += 1
                continue
            try:
                proto, payload = decode(parts, validated=True)
            except ValueError:
                rejected += 1
                continue
            out.append(
                (proto, payload, parts[2] if len(parts) == 3 else None)
            )
        return out, rejected
    for parts in frames:
        try:
            proto, payload = decode(parts)
        except ValueError:
            rejected += 1
            continue
        out.append((proto, payload, parts[2] if len(parts) == 3 else None))
    return out, rejected


class Pub:
    """Synchronous PUB endpoint. ``n_dropped`` counts messages shed at a
    subscriber's full queue (``hwm``)."""

    def __init__(self, ip: str, port: int, bind: bool, hwm: int = DATA_HWM,
                 ctx: Any = None, chaos: Any = None) -> None:
        # ``ctx`` is accepted for tpu_rl's signature; the port has no context.
        self.sock = _open(PUB, ip, port, bind, hwm)
        # Optional fault injector (tpu_rl's chaos shim interface: on_send).
        self._chaos = chaos

    @property
    def n_dropped(self) -> int:
        return self.sock.n_dropped

    def send(
        self, proto: Protocol, payload: Any, trace: bytes | None = None
    ) -> None:
        """``trace`` (a ``protocol.pack_trace`` trailer) rides as the
        optional third wire part on sampled rollout frames; None keeps the
        exact 2-part frame."""
        parts = encode(proto, payload, trace)
        if self._chaos is not None:
            parts = self._chaos.on_send(parts)
            if parts is None:
                return
        self.sock.send_multipart(parts)

    def send_raw(self, parts: list[bytes]) -> None:
        """Forward already-encoded wire parts verbatim (the relay hop)."""
        if self._chaos is not None:
            parts = self._chaos.on_send(parts)
            if parts is None:
                return
        self.sock.send_multipart(parts)

    def close(self) -> None:
        self.sock.close()


class Sub:
    """Synchronous SUB endpoint subscribed to everything.

    Malformed/foreign frames (``decode`` raising ValueError) are dropped and
    counted, never raised — one stray publisher on a best-effort PUB/SUB
    fabric must not crash a role process."""

    def __init__(self, ip: str, port: int, bind: bool, hwm: int = DATA_HWM,
                 ctx: Any = None, chaos: Any = None,
                 native_batch: bool = True) -> None:
        self.sock = _open(SUB, ip, port, bind, hwm)
        self.n_rejected = 0
        # Optional fault injector applied to received parts BEFORE decode,
        # so an injected corruption pairs with its n_rejected bump.
        self._chaos = chaos
        # Validate drained batches through the native codec when it is
        # loaded; False forces the pure-Python path (the A/B baseline).
        self._native_batch = native_batch

    def _recv_parts(self, timeout_ms: int | None) -> list[bytes] | None:
        parts = self.sock.recv_multipart(timeout_ms)
        if parts is not None and self._chaos is not None:
            parts = self._chaos.on_recv(parts)
        return parts

    def _collect(self, max_msgs: int) -> list[list[bytes]]:
        """Drain up to ``max_msgs`` queued frames (chaos applied per frame),
        without validating — batch validation follows in one call."""
        frames: list[list[bytes]] = []
        for _ in range(max_msgs):
            parts = self.sock.recv_multipart(0)
            if parts is None:
                break
            if self._chaos is not None:
                parts = self._chaos.on_recv(parts)
                if parts is None:
                    continue
            frames.append(parts)
        return frames

    def recv(self, timeout_ms: int | None = None) -> tuple[Protocol, Any] | None:
        """Blocking (or timed) receive of one decoded message; None on
        timeout or on a rejected frame."""
        parts = self._recv_parts(timeout_ms)
        if parts is None:
            return None
        try:
            return decode(parts)
        except ValueError:
            self.n_rejected += 1
            return None

    def drain(self, max_msgs: int = 1024) -> Iterator[tuple[Protocol, Any]]:
        """Yield every decodable message currently queued, newest-bounded."""
        for _ in range(max_msgs):
            parts = self.sock.recv_multipart(0)
            if parts is None:
                return
            if self._chaos is not None:
                parts = self._chaos.on_recv(parts)
                if parts is None:
                    continue
            try:
                yield decode(parts)
            except ValueError:
                self.n_rejected += 1

    def recv_traced(
        self, timeout_ms: int | None = None
    ) -> tuple[Protocol, Any, bytes | None] | None:
        """:meth:`recv` plus the raw trace trailer when the frame carried one
        (parse it with ``protocol.unpack_trace``)."""
        parts = self._recv_parts(timeout_ms)
        if parts is None:
            return None
        try:
            proto, payload = decode(parts)
        except ValueError:
            self.n_rejected += 1
            return None
        return proto, payload, parts[2] if len(parts) == 3 else None

    def drain_traced(
        self, max_msgs: int = 1024
    ) -> Iterator[tuple[Protocol, Any, bytes | None]]:
        """Yield every decodable queued message with its trace trailer (or
        None). The batch is structurally validated and CRC'd in one native
        call when the codec is loaded."""
        got, rejected = _validate_traced(
            self._collect(max_msgs), self._native_batch
        )
        self.n_rejected += rejected
        yield from got

    def recv_raw(
        self, timeout_ms: int | None = None
    ) -> tuple[Protocol, list[bytes]] | None:
        """Blocking (or timed) receive of one frame as opaque wire parts,
        validated by :func:`protocol.peek` only. None on timeout or on a
        rejected frame (counted in ``n_rejected``)."""
        parts = self._recv_parts(timeout_ms)
        if parts is None:
            return None
        try:
            return peek(parts), parts
        except ValueError:
            self.n_rejected += 1
            return None

    def drain_raw(
        self, max_msgs: int = 1024
    ) -> Iterator[tuple[Protocol, list[bytes]]]:
        """Yield every queued frame as peek-validated opaque wire parts (the
        raw relay's drain); one native validation call per batch."""
        got, rejected = _validate_raw(
            self._collect(max_msgs), self._native_batch
        )
        self.n_rejected += rejected
        yield from got

    def close(self) -> None:
        self.sock.close()


class Router:
    """ROUTER endpoint of the centralized inference service: every frame a
    DEALER sends arrives prefixed with that peer's identity, and a reply
    sent to the same identity routes back to exactly that peer. Malformed
    frames are dropped and counted (``n_rejected``)."""

    def __init__(self, ip: str, port: int, bind: bool = True,
                 hwm: int = DATA_HWM, ctx: Any = None) -> None:
        self.sock = _open(ROUTER, ip, port, bind, hwm)
        self.n_rejected = 0

    def recv(self, timeout_ms: int | None = None
             ) -> tuple[bytes, Protocol, Any] | None:
        """One ``(identity, proto, payload)`` request; None on timeout or on
        a rejected frame."""
        parts = self.sock.recv_multipart(timeout_ms)
        if parts is None:
            return None
        return self._split(parts)

    def drain(self, max_msgs: int = 1024
              ) -> Iterator[tuple[bytes, Protocol, Any]]:
        """Yield every decodable queued request, newest-bounded."""
        for _ in range(max_msgs):
            parts = self.sock.recv_multipart(0)
            if parts is None:
                return
            got = self._split(parts)
            if got is not None:
                yield got

    def _split(self, parts: list[bytes]
               ) -> tuple[bytes, Protocol, Any] | None:
        # The ROUTER prepends the peer identity to whatever the DEALER sent.
        try:
            if len(parts) < 2:
                raise ValueError(f"short ROUTER frame: {len(parts)} parts")
            proto, payload = decode(parts[1:])
            return parts[0], proto, payload
        except ValueError:
            self.n_rejected += 1
            return None

    def send(self, identity: bytes, proto: Protocol, payload: Any) -> None:
        """Route one reply back to ``identity``; a vanished peer's reply is
        dropped, as libzmq's ROUTER does with ROUTER_MANDATORY unset."""
        self.sock.send_multipart([identity, *encode(proto, payload)])

    def close(self) -> None:
        self.sock.close()


class Dealer:
    """DEALER endpoint: the worker side of the inference channel. One
    in-flight request per tick (send -> timed recv)."""

    def __init__(self, ip: str, port: int, bind: bool = False,
                 hwm: int = DATA_HWM, identity: bytes | None = None,
                 ctx: Any = None) -> None:
        self.sock = _open(DEALER, ip, port, bind, hwm, identity=identity)
        self.n_rejected = 0

    def send(self, proto: Protocol, payload: Any) -> None:
        self.sock.send_multipart(encode(proto, payload))

    def recv(self, timeout_ms: int | None = None) -> tuple[Protocol, Any] | None:
        """Timed receive of one decoded reply; None on timeout or on a
        rejected frame."""
        parts = self.sock.recv_multipart(timeout_ms)
        if parts is None:
            return None
        try:
            return decode(parts)
        except ValueError:
            self.n_rejected += 1
            return None

    def close(self) -> None:
        self.sock.close()


class AsyncSub:
    """asyncio SUB endpoint: ``await recv()`` wakes on the I/O thread's
    arrival callback instead of polling."""

    def __init__(self, ip: str, port: int, bind: bool, hwm: int = DATA_HWM,
                 ctx: Any = None) -> None:
        self.sock = _open(SUB, ip, port, bind, hwm)
        self.n_rejected = 0
        self._event: asyncio.Event | None = None
        self._loop: asyncio.AbstractEventLoop | None = None

    def _arrived(self) -> None:
        loop, event = self._loop, self._event
        if loop is not None and event is not None:
            try:
                loop.call_soon_threadsafe(event.set)
            except RuntimeError:
                pass  # the loop that awaited is closed; the message waits in the queue

    async def recv(self) -> tuple[Protocol, Any]:
        """Receive the next decodable message (rejected frames are dropped)."""
        if self._event is None:
            self._loop = asyncio.get_running_loop()
            self._event = asyncio.Event()
            self.sock.on_message = self._arrived
        while True:
            parts = self.sock.recv_multipart(0)
            if parts is None:
                self._event.clear()
                parts = self.sock.recv_multipart(0)  # landed before clear()
                if parts is None:
                    await self._event.wait()
                    continue
            try:
                return decode(parts)
            except ValueError:
                self.n_rejected += 1

    def close(self) -> None:
        self.sock.close()


class AsyncPub:
    def __init__(self, ip: str, port: int, bind: bool, hwm: int = DATA_HWM,
                 ctx: Any = None) -> None:
        self.sock = _open(PUB, ip, port, bind, hwm)

    async def send(self, proto: Protocol, payload: Any) -> None:
        self.sock.send_multipart(encode(proto, payload))  # never blocks

    def close(self) -> None:
        self.sock.close()


# ===================================================== shared-memory channel
# Same-host data hops (manager -> storage, learner -> storage telemetry) over
# named POSIX shared memory instead of a TCP loopback socket: a send is a
# short memcpy into a lock-free ring, a drain is a batch of memcpys out — no
# syscalls, no kernel socket buffers, no I/O thread. Selected per hop by
# ``Config.transport`` ("shm" forces it; "auto" picks it when the peer
# address is loopback; "tcp" — the default — never builds any of this).
#
# Topology: one SPSC byte-ring PER PRODUCER, fanned in by the single
# consumer. Rendezvous is by segment NAME, keyed on the (unique per channel)
# TCP port number the hop would otherwise use:
#
#   tpurl-{port}-ctl   consumer-owned control block: magic, a fresh session
#                      nonce per consumer lifetime, the ring capacity, and a
#                      claimed-slot bitmap;
#   tpurl-{port}-p{k}  producer k's ring (128-byte header + capacity bytes).
#
# A producer claims slot k by creating its segment with O_EXCL (the atomic
# arbiter — two racers cannot both win a name), initializes the ring header,
# THEN sets bitmap[k], so the consumer never attaches a half-built ring. A
# consumer (re)start unlinks every stale segment and mints a new nonce;
# producers re-check the nonce (time-gated, ~1s) and re-rendezvous onto the
# new session, which is how the channel survives a storage restart under
# supervision. Like PUB/SUB, the channel is best-effort: no consumer bound
# yet, or a full ring, drops the frame (counted).
#
# Ring protocol (seqlock, in the spirit of tpu_rl_torch/data/shm_ring.py): byte
# positions are MONOTONIC u64s (wrap = position % capacity, records may
# split across the physical end). The writer copies the record into
# [wpos, wpos+len), then publishes wpos under its seqlock (odd = mid-
# publish); the reader snapshots a stable wpos, consumes [rpos, wpos), and
# publishes rpos under its own seqlock for the writer's free-space check.
# Each side WRITES only its own counter, so one torn-read-retry loop per
# snapshot is the entire synchronization story. Record framing:
# u8 part-count, u32 length per part, then the part bytes — the same
# multipart shape a TCP socket carries, so chaos shims and validators apply
# unchanged.

SHM_MAX_PRODUCERS = 64
SHM_RING_BYTES = 1 << 26  # 64 MiB per producer ring (~2.6k 25 KB ticks)

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_SHM_CTL_MAGIC = 0x54524C43  # "TRLC"
_RING_MAGIC = 0x54524C52  # "TRLR"
_RING_HDR = 128
# ring header offsets: writer's cache line, then the reader's
_WSEQ, _WPOS, _RMAGIC, _RCAP = 0, 8, 16, 24
_RSEQ, _RPOS = 64, 72
# ctl offsets: magic u32 (written LAST — publishes the block), nonce u64,
# capacity u64, then the claimed-slot bitmap
_CTL_NONCE, _CTL_CAP, _CTL_BITMAP = 8, 16, 24
_SEQLOCK_SPINS = 10_000

# Per-part-count record framing structs ("<B{n}I" preamble, "<{n}I" length
# table), cached so the ring's per-record write/read never rebuilds a format
# string — the hot-path purity checker (tools/analysis) holds these
# functions to zero per-call formatting.
_PREAMBLE_STRUCTS: dict[int, struct.Struct] = {}
_LENS_STRUCTS: dict[int, struct.Struct] = {}


def _preamble_struct(nparts: int) -> struct.Struct:
    s = _PREAMBLE_STRUCTS.get(nparts)
    if s is None:
        s = _PREAMBLE_STRUCTS[nparts] = struct.Struct("<B%dI" % nparts)
    return s


def _lens_struct(nparts: int) -> struct.Struct:
    s = _LENS_STRUCTS.get(nparts)
    if s is None:
        s = _LENS_STRUCTS[nparts] = struct.Struct("<%dI" % nparts)
    return s


def _ctl_name(port: int) -> str:
    return f"tpurl-{port}-ctl"


def _slot_name(port: int, k: int) -> str:
    return f"tpurl-{port}-p{k}"


def _untrack(shm: shared_memory.SharedMemory) -> None:
    """Detach ``shm`` from the resource tracker: it would otherwise unlink
    the segment when ANY attaching process exits (and warn about 'leaks').
    Lifetime is owned explicitly by the consumer (`ShmConsumer.close`)."""
    try:
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass  # tracker internals vary across minor versions; never fatal


def _attach(name: str) -> shared_memory.SharedMemory:
    shm = shared_memory.SharedMemory(name)
    _untrack(shm)
    return shm


def _shm_unlink(name: str) -> None:
    """Unlink by name WITHOUT SharedMemory.unlink(): that method also
    unregisters from the resource tracker, and since _untrack already did,
    the tracker process would log a KeyError for every segment."""
    try:
        import _posixshmem

        _posixshmem.shm_unlink("/" + name)
    except (ImportError, FileNotFoundError):
        pass


def _unlink_stale(port: int) -> None:
    """Remove every segment a previous session on this channel left behind
    (crashed consumer, orphaned producers)."""
    for name in [_ctl_name(port)] + [
        _slot_name(port, k) for k in range(SHM_MAX_PRODUCERS)
    ]:
        _shm_unlink(name)


class _RingWriter:
    """Producer side of one SPSC byte ring."""

    __slots__ = ("_shm", "buf", "cap", "wpos", "_wseq")

    def __init__(self, shm: shared_memory.SharedMemory, capacity: int) -> None:
        self._shm = shm
        self.buf = shm.buf
        self.cap = capacity
        self.wpos = _U64.unpack_from(self.buf, _WPOS)[0]
        self._wseq = _U64.unpack_from(self.buf, _WSEQ)[0]

    def _read_rpos(self) -> int | None:
        buf = self.buf
        for _ in range(_SEQLOCK_SPINS):
            s1 = _U64.unpack_from(buf, _RSEQ)[0]
            if s1 & 1:
                continue
            rpos = _U64.unpack_from(buf, _RPOS)[0]
            if _U64.unpack_from(buf, _RSEQ)[0] == s1:
                return rpos
        # Reader wedged mid-publish (it died between the two seqlock writes).
        # Conservative: report no known free space rather than risk
        # overwriting unread bytes on a bogus rpos.
        return None

    def _put(self, pos: int, data: bytes) -> int:
        off = pos % self.cap
        n = len(data)
        base = _RING_HDR
        if off + n <= self.cap:
            self.buf[base + off : base + off + n] = data
        else:
            k = self.cap - off
            self.buf[base + off : base + self.cap] = data[:k]
            self.buf[base : base + n - k] = data[k:]
        return pos + n

    def write(self, parts: list[bytes]) -> bool:
        """Copy one multipart record in; False = ring full (caller counts
        the drop — same shed-newest behavior as a PUB at HWM)."""
        nparts = len(parts)
        if not nparts or nparts > 255:
            return False
        lens = list(map(len, parts))
        pre = _preamble_struct(nparts).pack(nparts, *lens)
        rec = len(pre) + sum(lens)
        rpos = self._read_rpos()
        if rpos is None or self.wpos + rec - rpos > self.cap:
            return False
        pos = self._put(self.wpos, pre)
        for p in parts:
            pos = self._put(pos, p)
        # Publish: data writes above happen-before the wpos store (CPython
        # executes these sequentially; x86/ARM64 store ordering suffices for
        # the paired acquire loop in _read_wpos).
        buf = self.buf
        _U64.pack_into(buf, _WSEQ, self._wseq + 1)  # odd: mid-publish
        _U64.pack_into(buf, _WPOS, pos)
        self._wseq += 2
        _U64.pack_into(buf, _WSEQ, self._wseq)
        self.wpos = pos
        return True


class _RingReader:
    """Consumer side of one SPSC byte ring."""

    __slots__ = ("_shm", "buf", "cap", "rpos", "_rseq", "n_resync")

    def __init__(self, shm: shared_memory.SharedMemory, capacity: int) -> None:
        self._shm = shm
        self.buf = shm.buf
        self.cap = capacity
        self.rpos = _U64.unpack_from(self.buf, _RPOS)[0]
        self._rseq = _U64.unpack_from(self.buf, _RSEQ)[0]
        self.n_resync = 0

    def _read_wpos(self) -> int:
        buf = self.buf
        for _ in range(_SEQLOCK_SPINS):
            s1 = _U64.unpack_from(buf, _WSEQ)[0]
            if s1 & 1:
                continue
            wpos = _U64.unpack_from(buf, _WPOS)[0]
            if _U64.unpack_from(buf, _WSEQ)[0] == s1:
                return wpos
        return self.rpos  # writer wedged mid-publish: read nothing new

    def _get(self, pos: int, n: int) -> bytes:
        off = pos % self.cap
        base = _RING_HDR
        if off + n <= self.cap:
            return bytes(self.buf[base + off : base + off + n])
        k = self.cap - off
        return bytes(self.buf[base + off : base + self.cap]) + bytes(
            self.buf[base : base + n - k]
        )

    def read(self, max_msgs: int) -> list[list[bytes]]:
        """Copy out up to ``max_msgs`` complete records; empty list = ring
        idle. A structurally impossible record (only reachable through real
        memory corruption — chaos corrupts part BYTES, which keep framing
        intact) resyncs the ring by skipping to the writer's position."""
        wpos = self._read_wpos()
        pos = self.rpos
        out: list[list[bytes]] = []
        while pos < wpos and len(out) < max_msgs:
            nparts = self._get(pos, 1)[0]
            if nparts == 0:
                self.n_resync += 1
                pos = wpos
                break
            lens = _lens_struct(nparts).unpack(self._get(pos + 1, 4 * nparts))
            end = pos + 1 + 4 * nparts + sum(lens)
            if end > wpos or max(lens) > self.cap:
                self.n_resync += 1
                pos = wpos
                break
            p = pos + 1 + 4 * nparts
            parts = []
            for n in lens:
                parts.append(self._get(p, n))
                p += n
            out.append(parts)
            pos = end
        if pos != self.rpos:
            self.rpos = pos
            buf = self.buf
            _U64.pack_into(buf, _RSEQ, self._rseq + 1)
            _U64.pack_into(buf, _RPOS, pos)
            self._rseq += 2
            _U64.pack_into(buf, _RSEQ, self._rseq)
        return out


class ShmPub:
    """Producer endpoint of the shm channel, Pub-compatible (``send`` /
    ``send_raw`` / ``close``, chaos ``on_send`` applied identically).

    Best-effort like PUB: frames sent before the consumer binds, or while
    the ring is full, are dropped and counted. Rendezvous and session-loss
    recovery are time-gated so the hot path pays one ``monotonic()`` call."""

    _RETRY_S = 0.2  # how often to re-attempt rendezvous with no consumer
    _CHECK_S = 1.0  # how often to verify the consumer session nonce

    def __init__(self, port: int, chaos: Any = None) -> None:
        self.port = port
        self._chaos = chaos
        self._writer: _RingWriter | None = None
        self._seg: shared_memory.SharedMemory | None = None
        self._nonce = 0
        self.slot: int | None = None
        self.n_dropped_full = 0
        self.n_dropped_no_peer = 0
        self._next_try = 0.0
        self._next_check = 0.0
        self._rendezvous()

    # ------------------------------------------------------------ session
    def _rendezvous(self) -> None:
        try:
            ctl = _attach(_ctl_name(self.port))
        except (FileNotFoundError, OSError):
            return
        try:
            if _U32.unpack_from(ctl.buf, 0)[0] != _SHM_CTL_MAGIC:
                return  # consumer still initializing; retry later
            nonce = _U64.unpack_from(ctl.buf, _CTL_NONCE)[0]
            cap = _U64.unpack_from(ctl.buf, _CTL_CAP)[0]
            for k in range(SHM_MAX_PRODUCERS):
                if ctl.buf[_CTL_BITMAP + k]:
                    continue
                try:
                    seg = shared_memory.SharedMemory(
                        _slot_name(self.port, k),
                        create=True,  # O_EXCL: the slot-claim arbiter
                        size=_RING_HDR + cap,
                    )
                except FileExistsError:
                    continue  # lost the race for k; try the next slot
                _untrack(seg)
                seg.buf[:_RING_HDR] = bytes(_RING_HDR)
                _U32.pack_into(seg.buf, _RMAGIC, _RING_MAGIC)
                _U64.pack_into(seg.buf, _RCAP, cap)
                # Bitmap set LAST: the consumer only attaches rings whose
                # header is fully initialized.
                ctl.buf[_CTL_BITMAP + k] = 1
                self._seg = seg
                self._writer = _RingWriter(seg, cap)
                self._nonce = nonce
                self.slot = k
                return
        finally:
            ctl.close()

    def _session_alive(self) -> bool:
        """Fresh-attach the ctl block by NAME (a held mapping would keep
        showing the dead session's inode after a consumer restart)."""
        try:
            ctl = _attach(_ctl_name(self.port))
        except (FileNotFoundError, OSError):
            return False
        try:
            return (
                _U32.unpack_from(ctl.buf, 0)[0] == _SHM_CTL_MAGIC
                and _U64.unpack_from(ctl.buf, _CTL_NONCE)[0] == self._nonce
            )
        finally:
            ctl.close()

    def _detach(self) -> None:
        self._writer = None
        self.slot = None
        if self._seg is not None:
            try:
                self._seg.close()
            except BufferError:
                pass
            self._seg = None

    # --------------------------------------------------------------- send
    def send(
        self, proto: Protocol, payload: Any, trace: bytes | None = None
    ) -> None:
        self.send_raw(encode(proto, payload, trace))

    def send_raw(self, parts: list[bytes]) -> None:
        if self._chaos is not None:
            parts = self._chaos.on_send(parts)
            if parts is None:
                return
        now = time.monotonic()
        if self._writer is not None and now >= self._next_check:
            self._next_check = now + self._CHECK_S
            if not self._session_alive():
                self._detach()  # consumer restarted: rejoin its new session
        if self._writer is None:
            if now >= self._next_try:
                self._next_try = now + self._RETRY_S
                self._rendezvous()
            if self._writer is None:
                self.n_dropped_no_peer += 1
                return
        if not self._writer.write(parts):
            self.n_dropped_full += 1

    def close(self) -> None:
        self._detach()


class ShmConsumer:
    """Consumer endpoint: owns the channel's segments (creates the ctl block
    with a fresh session nonce, unlinks everything at close), fans in every
    claimed producer ring. Raw frames only — validation/decode layers on top
    (:class:`FanInSub`)."""

    def __init__(self, port: int, capacity: int = SHM_RING_BYTES) -> None:
        self.port = port
        self.cap = capacity
        _unlink_stale(port)
        size = _CTL_BITMAP + SHM_MAX_PRODUCERS
        self._ctl = shared_memory.SharedMemory(
            _ctl_name(port), create=True, size=size
        )
        _untrack(self._ctl)
        self._ctl.buf[:size] = bytes(size)
        _U64.pack_into(
            self._ctl.buf, _CTL_NONCE, int.from_bytes(secrets.token_bytes(8), "little")
        )
        _U64.pack_into(self._ctl.buf, _CTL_CAP, capacity)
        # Magic last: producers treat a magicless ctl as "still initializing".
        _U32.pack_into(self._ctl.buf, 0, _SHM_CTL_MAGIC)
        self._readers: dict[int, _RingReader] = {}
        self._segs: dict[int, shared_memory.SharedMemory] = {}

    @property
    def n_resync(self) -> int:
        return sum(r.n_resync for r in self._readers.values())

    def _scan(self) -> None:
        """Attach rings of newly-claimed slots (bitmap poll: one 64-byte
        read per drain)."""
        bm = bytes(
            self._ctl.buf[_CTL_BITMAP : _CTL_BITMAP + SHM_MAX_PRODUCERS]
        )
        for k, claimed in enumerate(bm):
            if not claimed or k in self._readers:
                continue
            try:
                seg = _attach(_slot_name(self.port, k))
            except (FileNotFoundError, OSError):
                continue
            if _U32.unpack_from(seg.buf, _RMAGIC)[0] != _RING_MAGIC:
                seg.close()
                continue
            cap = _U64.unpack_from(seg.buf, _RCAP)[0]
            self._readers[k] = _RingReader(seg, cap)
            self._segs[k] = seg

    def drain_frames(self, max_msgs: int = 1024) -> list[list[bytes]]:
        """All complete records currently readable across producers."""
        self._scan()
        out: list[list[bytes]] = []
        for reader in self._readers.values():
            left = max_msgs - len(out)
            if left <= 0:
                break
            out.extend(reader.read(left))
        return out

    def close(self) -> None:
        for seg in self._segs.values():
            try:
                seg.close()
            except BufferError:
                pass
        self._segs.clear()
        self._readers.clear()
        try:
            self._ctl.close()
        except BufferError:
            pass
        # Unlink everything by name — including slots claimed by producers
        # this consumer never attached.
        _unlink_stale(self.port)


class FanInSub:
    """Sub-compatible fan-in over BOTH fabrics: the shm channel for same-host
    producers plus the TCP SUB for remote ones (a mixed fleet has both; the
    TCP socket also keeps slow-joiner semantics for late remote workers).
    Exposes the exact :class:`Sub` surface the manager/storage loops use.
    Chaos ``on_recv`` applies to shm frames identically to TCP ones, so the
    injected == n_rejected accounting invariant holds under shm."""

    _SLICE_MS = 5  # TCP poll slice while also watching the shm side

    def __init__(self, ip: str, port: int, bind: bool = True,
                 hwm: int = DATA_HWM, ctx: Any = None, chaos: Any = None,
                 capacity: int = SHM_RING_BYTES,
                 native_batch: bool = True) -> None:
        self._tcp = Sub(ip, port, bind=bind, hwm=hwm, ctx=ctx, chaos=chaos,
                        native_batch=native_batch)
        self.shm = ShmConsumer(port, capacity=capacity)
        self._chaos = chaos
        self._native_batch = native_batch
        self._shm_rejected = 0

    @property
    def n_rejected(self) -> int:
        return self._tcp.n_rejected + self._shm_rejected

    def _shm_frames(self, max_msgs: int) -> list[list[bytes]]:
        frames = self.shm.drain_frames(max_msgs)
        if self._chaos is not None and frames:
            kept = []
            for parts in frames:
                parts = self._chaos.on_recv(parts)
                if parts is not None:
                    kept.append(parts)
            frames = kept
        return frames

    # ------------------------------------------------------------- drains
    def drain_raw(
        self, max_msgs: int = 1024
    ) -> Iterator[tuple[Protocol, list[bytes]]]:
        got, rejected = _validate_raw(
            self._shm_frames(max_msgs), self._native_batch
        )
        self._shm_rejected += rejected
        yield from got
        yield from self._tcp.drain_raw(max_msgs)

    def drain_traced(
        self, max_msgs: int = 1024
    ) -> Iterator[tuple[Protocol, Any, bytes | None]]:
        got, rejected = _validate_traced(
            self._shm_frames(max_msgs), self._native_batch
        )
        self._shm_rejected += rejected
        yield from got
        yield from self._tcp.drain_traced(max_msgs)

    def drain(self, max_msgs: int = 1024) -> Iterator[tuple[Protocol, Any]]:
        for proto, payload, _trailer in self.drain_traced(max_msgs):
            yield proto, payload

    # ----------------------------------------------------- timed receives
    def recv_traced(
        self, timeout_ms: int | None = None
    ) -> tuple[Protocol, Any, bytes | None] | None:
        """Shm checked first (it has no poll(); a drain is just memory
        reads), then the TCP socket in short slices until the deadline."""
        deadline = (
            None if timeout_ms is None
            else time.monotonic() + timeout_ms / 1e3
        )
        while True:
            frames = self._shm_frames(1)
            if frames:
                got, rejected = _validate_traced(frames, self._native_batch)
                self._shm_rejected += rejected
                return got[0] if got else None
            got = self._tcp.recv_traced(timeout_ms=self._SLICE_MS)
            if got is not None:
                return got
            if deadline is not None and time.monotonic() >= deadline:
                return None

    def recv_raw(
        self, timeout_ms: int | None = None
    ) -> tuple[Protocol, list[bytes]] | None:
        deadline = (
            None if timeout_ms is None
            else time.monotonic() + timeout_ms / 1e3
        )
        while True:
            frames = self._shm_frames(1)
            if frames:
                got, rejected = _validate_raw(frames, self._native_batch)
                self._shm_rejected += rejected
                return got[0] if got else None
            got = self._tcp.recv_raw(timeout_ms=self._SLICE_MS)
            if got is not None:
                return got
            if deadline is not None and time.monotonic() >= deadline:
                return None

    def recv(
        self, timeout_ms: int | None = None
    ) -> tuple[Protocol, Any] | None:
        got = self.recv_traced(timeout_ms)
        return None if got is None else (got[0], got[1])

    def close(self) -> None:
        self._tcp.close()
        self.shm.close()


# ------------------------------------------------------- transport selection
def is_loopback(ip: str) -> bool:
    """Both-endpoints-on-this-host heuristic for ``transport="auto"``: the
    connect-side addresses we'd dial. Bind-side wildcards count too — the
    consumer always ALSO binds its TCP SUB, so an shm consumer on a
    wildcard bind only adds a fabric, never loses remote peers."""
    return ip in ("127.0.0.1", "localhost", "::1", "*", "0.0.0.0")


def use_shm(cfg: Any, ip: str) -> bool:
    transport = getattr(cfg, "transport", "tcp")
    return transport == "shm" or (transport == "auto" and is_loopback(ip))


def make_data_pub(cfg: Any, ip: str, port: int, bind: bool = False,
                  hwm: int = DATA_HWM, ctx: Any = None,
                  chaos: Any = None) -> "Pub | ShmPub":
    """Producer endpoint for a DATA hop (rollout/stat/telemetry fan-in),
    honoring ``Config.transport``. The model broadcast is NOT a data hop —
    it fans OUT to remote workers and always stays TCP."""
    if use_shm(cfg, ip):
        return ShmPub(port, chaos=chaos)
    return Pub(ip, port, bind=bind, hwm=hwm, ctx=ctx, chaos=chaos)


def make_data_sub(cfg: Any, ip: str, port: int, bind: bool = True,
                  hwm: int = DATA_HWM, ctx: Any = None,
                  chaos: Any = None) -> "Sub | FanInSub":
    """Consumer endpoint for a DATA hop: a :class:`FanInSub` (shm + TCP)
    whenever shm producers may exist, else the plain TCP :class:`Sub`."""
    if getattr(cfg, "transport", "tcp") != "tcp":
        return FanInSub(ip, port, bind=bind, hwm=hwm, ctx=ctx, chaos=chaos)
    return Sub(ip, port, bind=bind, hwm=hwm, ctx=ctx, chaos=chaos)
