"""Wire protocol: message kinds and the framed codec — the port's own copy
of ``tpu_rl.runtime.protocol``, byte for byte the same frames.

- the protocol symbol travels as a single byte;
- payload frames carry a header (magic, codec id, raw size, crc32 of the
  compressed body), so a corrupt or foreign frame is rejected early;
- the body is a schema-bound binary serialization (:func:`pack` /
  :func:`unpack`) over a closed type set (numeric numpy arrays, str, bytes,
  int, float, bool, None, list/tuple, str-keyed dict): decoding never
  reconstructs objects, only ``np.frombuffer`` on validated dtypes;
- compression is the native C++ LZ4-block codec (the package's
  ``native/codec.cpp``) with a zlib fallback, chosen per process at import;
  both ends interoperate because the codec id is in the header;
- tiny payloads skip compression (codec=raw).

A torch tensor on the wire goes through ``np.asarray`` (so a CUDA tensor
must be brought to the host first).
"""

from __future__ import annotations

import enum
import struct
import zlib
from typing import Any

import numpy as np

from tpu_rl_torch.runtime import native

# ---------------------------------------------------------------- pack/unpack
# Closed-schema serializer replacing pickle on the wire (the reference
# unpickles network input, ``utils/utils.py:248-249`` — arbitrary code
# execution for anyone who can reach a bound port). Everything the framework
# ships — rollout step dicts, stat floats, param pytrees (nested str-keyed
# dicts of numeric numpy arrays after ``device_get``) — fits this type set.

_LEN = struct.Struct("<I")  # lengths / counts
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")
# numpy dtype kinds that are pure data (no object reconstruction on load)
_ARRAY_KINDS = frozenset("biufc")
_MAX_DEPTH = 32


def _pack_into(obj: Any, out: list[bytes], depth: int = 0) -> None:
    if depth > _MAX_DEPTH:
        raise ValueError("payload nesting too deep")
    if obj is None:
        out.append(b"n")
    elif obj is True:
        out.append(b"t")
    elif obj is False:
        out.append(b"f")
    elif isinstance(obj, int):
        try:
            out.append(b"i" + _I64.pack(obj))
        except struct.error as e:
            raise ValueError(f"int out of int64 wire range: {obj}") from e
    elif isinstance(obj, float):
        out.append(b"d" + _F64.pack(obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(b"s" + _LEN.pack(len(b)) + b)
    elif isinstance(obj, bytes):
        out.append(b"y" + _LEN.pack(len(obj)) + obj)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.ascontiguousarray(obj)
        if arr.dtype.kind not in _ARRAY_KINDS:
            raise ValueError(f"non-numeric array dtype {arr.dtype} on wire")
        dt = arr.dtype.str.encode("ascii")  # e.g. b"<f4"
        body = arr.tobytes()
        out.append(
            b"a"
            + _LEN.pack(len(dt))
            + dt
            + _LEN.pack(arr.ndim)
            + b"".join(_I64.pack(s) for s in arr.shape)
            + _LEN.pack(len(body))
            + body
        )
    elif isinstance(obj, (list, tuple)):
        out.append((b"l" if isinstance(obj, list) else b"u") + _LEN.pack(len(obj)))
        for item in obj:
            _pack_into(item, out, depth + 1)
    elif isinstance(obj, dict):
        out.append(b"m" + _LEN.pack(len(obj)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise ValueError(f"non-str dict key {type(k).__name__} on wire")
            kb = k.encode("utf-8")
            out.append(_LEN.pack(len(kb)) + kb)
            _pack_into(v, out, depth + 1)
    else:
        # CPU tensors land here: anything exposing __array__ with a numeric
        # dtype is accepted once.
        a = np.asarray(obj)
        if a.dtype.kind not in _ARRAY_KINDS:
            raise ValueError(f"unsupported wire type {type(obj).__name__}")
        _pack_into(a, out, depth)


def pack(obj: Any) -> bytes:
    out: list[bytes] = []
    _pack_into(obj, out)
    return b"".join(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes) -> None:
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            raise ValueError("truncated wire payload")
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def u32(self) -> int:
        return _LEN.unpack(self.take(4))[0]


def _unpack_from(r: _Reader, depth: int = 0) -> Any:
    if depth > _MAX_DEPTH:
        raise ValueError("payload nesting too deep")
    tag = r.take(1)
    if tag == b"n":
        return None
    if tag == b"t":
        return True
    if tag == b"f":
        return False
    if tag == b"i":
        return _I64.unpack(r.take(8))[0]
    if tag == b"d":
        return _F64.unpack(r.take(8))[0]
    if tag == b"s":
        return r.take(r.u32()).decode("utf-8")
    if tag == b"y":
        return r.take(r.u32())
    if tag == b"a":
        try:
            dt = np.dtype(r.take(r.u32()).decode("ascii", errors="strict"))
        except (TypeError, UnicodeDecodeError) as e:
            # np.dtype raises TypeError for garbage strings; normalize to the
            # module's ValueError contract so Sub.recv's reject path holds.
            raise ValueError(f"bad wire dtype: {e}") from e
        if dt.kind not in _ARRAY_KINDS:
            raise ValueError(f"non-numeric array dtype {dt} on wire")
        ndim = r.u32()
        if ndim > 32:
            raise ValueError("array rank too large")
        shape = tuple(_I64.unpack(r.take(8))[0] for _ in range(ndim))
        if any(s < 0 for s in shape):
            raise ValueError("negative array dim")
        body = r.take(r.u32())
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if len(body) != n * dt.itemsize:
            raise ValueError("array byte-size mismatch")
        return np.frombuffer(body, dtype=dt).reshape(shape).copy()
    if tag in (b"l", b"u"):
        n = r.u32()
        items = [_unpack_from(r, depth + 1) for _ in range(n)]
        return items if tag == b"l" else tuple(items)
    if tag == b"m":
        n = r.u32()
        d = {}
        for _ in range(n):
            k = r.take(r.u32()).decode("utf-8")
            d[k] = _unpack_from(r, depth + 1)
        return d
    raise ValueError(f"unknown wire tag {tag!r}")


def unpack(buf: bytes) -> Any:
    r = _Reader(buf)
    obj = _unpack_from(r)
    if r.pos != len(buf):
        raise ValueError("trailing bytes in wire payload")
    return obj


def _lz4_decompress_py(src: bytes, raw_size: int) -> bytes:
    """Pure-Python LZ4 block decoder — fallback mirror of
    ``native/codec.cpp:tpurl_decompress`` for hosts without a C++ toolchain."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if i >= n:
                    raise ValueError("truncated LZ4 literal length")
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        if i + lit_len > n:
            raise ValueError("truncated LZ4 literals")
        if len(out) + lit_len > raw_size:
            raise ValueError("LZ4 literals exceed declared raw size")
        out += src[i : i + lit_len]
        i += lit_len
        if i >= n:
            break  # last sequence has no match
        if i + 2 > n:
            raise ValueError("truncated LZ4 offset")
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise ValueError("corrupt LZ4 offset")
        match_len = token & 15
        if match_len == 15:
            while True:
                if i >= n:
                    raise ValueError("truncated LZ4 match length")
                b = src[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        match_len += 4
        if len(out) + match_len > raw_size:
            # A single declared match run must not blow past the target size
            # (a 16 MB body can otherwise declare a multi-GB expansion).
            raise ValueError("LZ4 match exceeds declared raw size")
        # Overlapping copy must be byte-serial when offset < match_len.
        pos = len(out) - offset
        for _ in range(match_len):
            out.append(out[pos])
            pos += 1
    if len(out) != raw_size:
        raise ValueError(f"LZ4 size mismatch: {len(out)} != {raw_size}")
    return bytes(out)


class Protocol(enum.IntEnum):
    """Message kinds (reference ``utils/utils.py:229-232``)."""

    Model = 0  # learner -> workers: parameter broadcast
    Rollout = 1  # worker -> manager -> storage: one env step
    Stat = 2  # worker -> manager -> storage: episode reward
    # One worker TICK: all worker_num_envs transitions stacked on a leading
    # env axis, one frame. The reference publishes one dict per env step
    # (``agents/worker.py:110-125``); at 32 envs that is 32 encode+send
    # calls per tick, and framing overhead was measured to cap the wire at
    # ~3.2k env-steps/s — batched, one encode covers the whole tick (and
    # the stacked arrays compress far better). Split back into per-step
    # dicts by ``tpu_rl_torch.data.assembler.split_rollout_batch``.
    RolloutBatch = 3
    # SEED-style centralized inference (runtime/inference_service.py):
    # worker DEALER -> learner ROUTER, one frame per worker tick carrying
    # the tick's observations {"wid", "seq", "obs" (n, obs_dim),
    # "first" (n,)} — the recurrent carry stays server-side, it never
    # rides this request.
    ObsRequest = 4
    # The reply: {"seq", "act", "logits", "log_prob"} (+ "hx"/"cx" pre-step
    # carry rows for store_carry families — the learner trains from them,
    # so they must reach the RolloutBatch the worker publishes).
    Act = 5
    # Periodic MetricsRegistry snapshot (tpu_rl_torch.obs): every role ships its
    # counters/gauges/histograms as one tiny labeled frame on the stat
    # channel. The manager FORWARDS these like rollout frames (verbatim
    # parts in raw relay mode — peek routes on the proto byte); the storage
    # edge decodes and feeds the TelemetryAggregator.
    Telemetry = 6


class Codec(enum.IntEnum):
    RAW = 0
    LZ4 = 1  # native/codec.cpp
    ZLIB = 2


_MAGIC = 0x5452  # "TR"
_HEADER = struct.Struct("<HBBII")  # magic, version, codec, raw_size, crc32
# Declared wire size of the frame header. The assert makes a format edit
# fail at import instead of silently skewing every peek/encode offset; the
# static twin lives in tools/analysis (protocol checker, PC001).
HEADER_BYTES = 12
assert _HEADER.size == HEADER_BYTES, (
    f"frame header format {_HEADER.format!r} packs {_HEADER.size} bytes, "
    f"declared HEADER_BYTES is {HEADER_BYTES} — update both together "
    "(and bump _VERSION: this is a wire-format change)"
)
_VERSION = 1
_MIN_COMPRESS = 128  # bytes; below this, framing overhead beats compression
# Hard ceiling on a frame's declared decompressed size: a hostile header may
# claim up to 4 GB (u32) — reject before any allocation. 1 GiB comfortably
# covers the largest legitimate payload (a full model broadcast).
_MAX_RAW = 1 << 30

# Standard IEEE CRC-32 (zlib's C implementation; interoperates with the
# native tpurl_crc32, which implements the same polynomial).
_crc = zlib.crc32

# ------------------------------------------------------------- trace trailer
# Rollout-lineage trace context (tpu_rl_torch.obs): a sampled frame carries its
# origin as an OPTIONAL THIRD wire part, so the raw relay forwards it
# verbatim (send_multipart ships whatever parts arrived) and every other
# frame stays the exact 2-part message it always was. Fixed-size struct, own
# magic — a relay can validate it in O(1) without touching the payload.
_TRAILER_MAGIC = 0x5443  # "TC"
_TRAILER_VERSION = 1
# magic u16, version u8, pad, wid i32, frame seq u32, trace id u64,
# sender's time.time_ns() at send i64
_TRAILER = struct.Struct("<HBxiIQq")
# Declared wire size of the trace trailer — the 28-byte third part every
# relay validates in O(1). Same contract as HEADER_BYTES above: a format
# edit must fail here, not skew unpack_trace/_check_trailer offsets.
TRAILER_BYTES = 28
assert _TRAILER.size == TRAILER_BYTES, (
    f"trace trailer format {_TRAILER.format!r} packs {_TRAILER.size} bytes, "
    f"declared TRAILER_BYTES is {TRAILER_BYTES} — update both together "
    "(and bump _TRAILER_VERSION: this is a wire-format change)"
)
# The only kinds that may carry a trailer: the rollout data plane. A trailer
# on anything else (Model, Stat, control frames) is a hostile/corrupt frame
# and is rejected into the receiver's ``n_rejected`` path.
TRACE_KINDS = frozenset({Protocol.Rollout, Protocol.RolloutBatch})

# Derived forms handed to the native batch validator (native/codec.cpp) so
# the enum above stays the single source of truth: a bitmask over protocol
# bytes allowed to carry a trailer, and the highest known protocol byte.
TRACE_KINDS_MASK = 0
for _k in TRACE_KINDS:
    TRACE_KINDS_MASK |= 1 << int(_k)
MAX_PROTO = max(int(_p) for _p in Protocol)


def make_trace_id(wid: int, seq: int) -> int:
    """Deterministic fleet-unique trace id for a sampled tick: the origin
    worker in the high bits, its tick sequence below. Stays under 2**54 so
    the id survives JSON consumers that parse ints as doubles."""
    return ((wid & 0x3FFFFF) << 32) | (seq & 0xFFFFFFFF)


def pack_trace(wid: int, seq: int, trace_id: int, send_ts_ns: int) -> bytes:
    """Encode one trace-context trailer (the optional third wire part)."""
    return _TRAILER.pack(
        _TRAILER_MAGIC, _TRAILER_VERSION, wid, seq & 0xFFFFFFFF,
        trace_id & 0xFFFFFFFFFFFFFFFF, send_ts_ns,
    )


def unpack_trace(trailer: bytes) -> tuple[int, int, int, int]:
    """-> ``(wid, seq, trace_id, send_ts_ns)``; ValueError on garbage."""
    if len(trailer) != _TRAILER.size:
        raise ValueError(f"bad trace trailer size {len(trailer)}")
    magic, version, wid, seq, trace_id, ts = _TRAILER.unpack(trailer)
    if magic != _TRAILER_MAGIC or version != _TRAILER_VERSION:
        raise ValueError(f"bad trace trailer magic/version {magic:#x}/{version}")
    return wid, seq, trace_id, ts


def _check_trailer(proto: Protocol, parts: list[bytes]) -> None:
    """Relay-grade trailer validation (size cap = the exact struct size, kind
    allowlist, magic/version) — no payload decode, same cost class as
    :func:`peek`'s header checks."""
    if proto not in TRACE_KINDS:
        raise ValueError(f"trace trailer not allowed on {proto!r}")
    trailer = parts[2]
    if len(trailer) != _TRAILER.size:
        raise ValueError(f"bad trace trailer size {len(trailer)}")
    magic, version = _TRAILER.unpack_from(trailer)[:2]
    if magic != _TRAILER_MAGIC or version != _TRAILER_VERSION:
        raise ValueError(f"bad trace trailer magic/version {magic:#x}/{version}")


def encode(
    proto: Protocol, payload: Any, trace: bytes | None = None
) -> list[bytes]:
    """-> multipart message ``[proto_byte, frame]`` (reference ``encode``,
    ``utils/utils.py:244-245``), plus the optional trace-context trailer as a
    third part (see :func:`pack_trace`)."""
    raw = pack(payload)
    if len(raw) < _MIN_COMPRESS:
        codec, body = Codec.RAW, raw
    elif native.available():
        codec, body = Codec.LZ4, native.compress(raw)
    else:
        codec, body = Codec.ZLIB, zlib.compress(raw, level=1)
    if codec != Codec.RAW and len(body) >= len(raw):
        codec, body = Codec.RAW, raw  # incompressible: ship raw
    header = _HEADER.pack(_MAGIC, _VERSION, codec, len(raw), _crc(body) & 0xFFFFFFFF)
    if trace is None:
        return [bytes([proto]), header + body]
    return [bytes([proto]), header + body, trace]


def peek(parts: list[bytes]) -> Protocol:
    """Cheap relay-hop validation of a multipart frame: proto byte, header
    magic/version, known codec, declared-size cap — WITHOUT the CRC pass,
    decompression, or unpack that :func:`decode` performs. O(1) in the
    payload size, so a relay can route millions of frames/s on the proto
    byte alone. The full CRC + decode runs once, at the storage edge — the
    only hop that consumes rollout payloads. Raises ValueError on frames a
    relay must not forward (foreign publishers, truncated frames, hostile
    size declarations); a corrupt *body* under a valid header passes peek
    and is rejected downstream by decode's CRC. A third part, when present,
    must be a valid trace trailer on a kind that allows one
    (:func:`_check_trailer`) — anything else is rejected here so relays never
    amplify garbage trailers."""
    if len(parts) not in (2, 3) or len(parts[0]) != 1:
        raise ValueError(f"malformed multipart message: {len(parts)} parts")
    proto = Protocol(parts[0][0])  # ValueError on an unknown proto byte
    frame = parts[1]
    if len(frame) < _HEADER.size:
        raise ValueError("short frame")
    magic, version, codec, raw_size, _crc32 = _HEADER.unpack_from(frame)
    if magic != _MAGIC or version != _VERSION:
        raise ValueError(f"bad frame magic/version {magic:#x}/{version}")
    if raw_size > _MAX_RAW:
        raise ValueError(f"declared raw size {raw_size} exceeds cap {_MAX_RAW}")
    if codec == Codec.RAW:
        # Uncompressed body: the size invariant is free to check here.
        if len(frame) - _HEADER.size != raw_size:
            raise ValueError("raw body size mismatch")
    elif codec not in (Codec.LZ4, Codec.ZLIB):
        raise ValueError(f"unknown codec {codec}")
    if len(parts) == 3:
        _check_trailer(proto, parts)
    return proto


def decode(parts: list[bytes], validated: bool = False) -> tuple[Protocol, Any]:
    """Inverse of :func:`encode` (reference ``decode``,
    ``utils/utils.py:248-249``). Raises ValueError on malformed frames —
    including a trace trailer on a kind that doesn't allow one (the trailer
    itself is otherwise ignored here; lineage consumers read it via
    ``Sub.recv_traced``).

    ``validated=True`` skips the structural checks AND the body CRC pass:
    the caller already ran them, e.g. via the native batch validator's
    crc variant (``native.validate_batch(check_crc=True)``) over a whole
    drained deque — re-hashing every body here would pay the batch's
    dominant cost a second time. Decompress + schema unpack still run."""
    if len(parts) not in (2, 3) or len(parts[0]) != 1:
        raise ValueError(f"malformed multipart message: {len(parts)} parts")
    proto = Protocol(parts[0][0])
    if not validated and len(parts) == 3:
        _check_trailer(proto, parts)
    frame = parts[1]
    if len(frame) < _HEADER.size:
        raise ValueError("short frame")
    magic, version, codec, raw_size, crc = _HEADER.unpack_from(frame)
    if not validated:
        if magic != _MAGIC or version != _VERSION:
            raise ValueError(f"bad frame magic/version {magic:#x}/{version}")
        if raw_size > _MAX_RAW:
            raise ValueError(
                f"declared raw size {raw_size} exceeds cap {_MAX_RAW}"
            )
    body = frame[_HEADER.size :]
    if not validated and _crc(body) & 0xFFFFFFFF != crc:
        raise ValueError("frame crc mismatch")
    if codec == Codec.RAW:
        raw = body
    elif codec == Codec.LZ4:
        try:
            if native.available():
                raw = native.decompress(body, raw_size)
            else:
                # Peer has the native codec, this host does not (no
                # toolchain): decode in Python so interop is bidirectional.
                # Slow, but only ever hit on degraded hosts.
                raw = _lz4_decompress_py(body, raw_size)
        except (RuntimeError, MemoryError) as e:
            # native codec error / allocation failure -> reject, not crash
            raise ValueError(f"corrupt LZ4 body: {e}") from e
    elif codec == Codec.ZLIB:
        try:
            # Bounded decompress: a zlib bomb must not expand past the
            # declared raw_size before the size check below runs.
            d = zlib.decompressobj()
            raw = d.decompress(body, raw_size + 1)
        except zlib.error as e:
            raise ValueError(f"corrupt zlib body: {e}") from e
    else:
        raise ValueError(f"unknown codec {codec}")
    if len(raw) != raw_size:
        raise ValueError(f"size mismatch: {len(raw)} != {raw_size}")
    return proto, unpack(raw)
