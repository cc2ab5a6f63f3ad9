"""The port's wire codec (``tpu_rl_torch.runtime.protocol`` and ``.native``)
against ``tpu_rl``'s: the same payloads give byte-equal frames under the RAW
and ZLIB codecs, with and without a trace trailer, for every message kind;
LZ4 frames decode both ways (native and pure-Python); ``peek`` and
``decode`` reject the same corrupt frames with the same exception type; the
two native libraries give the same batch-validation verdicts."""

import numpy as np
import pytest

from tpu_rl.runtime import native as jax_native
from tpu_rl.runtime import protocol as J
from tpu_rl_torch.runtime import native as port_native
from tpu_rl_torch.runtime import protocol as P

KINDS = list(J.Protocol)
assert [int(k) for k in KINDS] == [int(k) for k in P.Protocol]


def payload(kind: int, big: bool, seed: int):
    """A seeded payload of the shape ``kind`` carries on the wire. ``big``:
    64 rows of few distinct values, well over the 128-byte floor (it
    compresses); else a few keys and random values under the floor (the
    frame ships RAW)."""
    rng = np.random.default_rng(seed * 31 + kind)
    if not big:
        x = rng.standard_normal((1, 2)).astype(np.float32)
        return {
            J.Protocol.Model: {"ver": int(rng.integers(99)), "epoch": 0},
            J.Protocol.Rollout: {"obs": x[0], "id": "e0"},
            J.Protocol.Stat: float(x[0, 0]),
            J.Protocol.RolloutBatch: {"obs": x, "wid": 0},
            J.Protocol.ObsRequest: {"seq": 7, "obs": x},
            J.Protocol.Act: {"seq": 7, "act": x[:, :1]},
            J.Protocol.Telemetry: {"role": "worker", "seq": int(rng.integers(99))},
        }[kind]
    n = 64
    arr = rng.integers(-2, 3, (n, 4)).astype(np.float32) * 0.5
    if kind == J.Protocol.Model:
        return {"actor": {"params": {"body": {"kernel": arr.T.copy(),
                                               "bias": np.zeros(n, np.float32)}}},
                "ver": 3, "epoch": 0, "t_tx": 1234567890123}
    if kind == J.Protocol.Rollout:
        return {"obs": arr.reshape(-1), "act": np.float32([1.0]), "id": "ab" * 8}
    if kind == J.Protocol.Stat:
        return {"rew": float(rng.random()), "wid": 1, "n_model_loads": 0,
                "n_rejected": 0, "note": "x" * 100}
    if kind == J.Protocol.RolloutBatch:
        return {"obs": arr, "rew": arr[:, :1], "id": [f"e{i}" for i in range(n)],
                "done": (rng.random(n) < 0.2).astype(np.uint8), "wid": 0, "ver": -1,
                "epoch": 0}
    if kind == J.Protocol.ObsRequest:
        return {"wid": 1, "seq": 7, "obs": arr, "first": np.ones(n, np.float32)}
    if kind == J.Protocol.Act:
        return {"seq": 7, "act": arr[:, :1], "logits": arr[:, :2], "log_prob": arr[:, :1],
                "ver": 4, "hx": arr, "cx": arr}
    return {"role": "worker", "seq": 3, "counters": [["x", {"wid": "0"}, 1.0]] * (n // 2),
            "gauges": [], "hists": [], "wid": 0, "epoch": 0, "clk": {"t2": 99}}


def trailer():
    return J.pack_trace(3, 41, J.make_trace_id(3, 41), 123_456_789)


@pytest.fixture(params=["zlib", "raw"])
def codec(request, monkeypatch):
    """"zlib": both packages without their native library, so every
    (compressible) payload ships ZLIB; "raw": payloads that ship RAW."""
    if request.param == "zlib":
        monkeypatch.setattr(J.native, "available", lambda: False)
        monkeypatch.setattr(P.native, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("kind", KINDS, ids=[k.name for k in KINDS])
@pytest.mark.parametrize("traced", [False, True], ids=["2-part", "trailer"])
def test_frames_byte_equal(kind, traced, codec):
    big = codec == "zlib"
    obj = payload(int(kind), big, seed=5)
    trace = trailer() if traced else None
    want = J.encode(kind, obj, trace)
    got = P.encode(P.Protocol(int(kind)), obj, trace)
    assert got == want
    header = J._HEADER.unpack_from(want[1])
    raw = J.pack(obj)
    assert header[2] == (J.Codec.ZLIB if big else J.Codec.RAW)
    assert P.pack(obj) == raw
    # and each package decodes the other's frame to the same payload
    if not traced or kind in J.TRACE_KINDS:
        assert J.pack(P.decode(want)[1]) == J.pack(obj)
        assert J.pack(J.decode(got)[1]) == J.pack(obj)


needs_native = pytest.mark.skipif(
    not (jax_native.available() and port_native.available()), reason="native codec not built"
)


@needs_native
@pytest.mark.parametrize("kind", [J.Protocol.Model, J.Protocol.RolloutBatch, J.Protocol.Act])
def test_lz4_frames_decode_both_ways(kind, monkeypatch):
    """LZ4 frames (the native codec on both sides) decode in the other
    package natively and through the pure-Python decoder; both libraries
    compress the same bytes alike (one source)."""
    obj = payload(int(kind), True, seed=9)
    jf = J.encode(kind, obj)
    pf = P.encode(P.Protocol(int(kind)), obj)
    assert J._HEADER.unpack_from(jf[1])[2] == J.Codec.LZ4
    assert pf == jf
    assert J.pack(P.decode(jf)[1]) == J.pack(obj)
    assert J.pack(J.decode(pf)[1]) == J.pack(obj)
    monkeypatch.setattr(P.native, "available", lambda: False)
    monkeypatch.setattr(J.native, "available", lambda: False)
    assert J.pack(P.decode(jf)[1]) == J.pack(obj)
    assert J.pack(J.decode(pf)[1]) == J.pack(obj)


def test_lz4_python_decoder_matches_native():
    if not port_native.available():
        pytest.skip("native codec not built")
    raw = np.random.default_rng(3).integers(0, 4, 20000).astype(np.uint8).tobytes() * 3
    comp = port_native.compress(raw)
    assert P._lz4_decompress_py(comp, len(raw)) == raw == J._lz4_decompress_py(comp, len(raw))
    assert port_native.crc32(raw) == jax_native.crc32(raw)


def _corrupt_frames(mod):
    """One frame per rejection class (tpu_rl's native-validation matrix),
    built with ``mod``'s own encoder."""
    big = {"obs": np.arange(256, dtype=np.float32)}
    good = mod.encode(mod.Protocol.RolloutBatch, big)
    bad_magic = bytearray(good[1])
    bad_magic[0] ^= 0xFF
    oversized = mod._HEADER.pack(mod._MAGIC, mod._VERSION, mod.Codec.ZLIB, (1 << 30) + 1, 0)
    raw_frame = mod.encode(mod.Protocol.Stat, 2.5)
    hdr = mod._HEADER.unpack_from(raw_frame[1])
    mismatch = mod._HEADER.pack(mod._MAGIC, mod._VERSION, mod.Codec.RAW, hdr[3] + 7, hdr[4])
    bad_codec = mod._HEADER.pack(mod._MAGIC, mod._VERSION, 9, hdr[3], hdr[4])
    body = raw_frame[1][mod._HEADER.size:]
    traced = mod.encode(mod.Protocol.Rollout, big, trace=trailer())
    bad_trailer = bytearray(trailer())
    bad_trailer[0] ^= 0xFF
    flipped = bytearray(good[1])
    flipped[12] ^= 0xFF
    zbody = b"\xde\xad\xbe\xef" * 8
    zlib_bad = mod._HEADER.pack(mod._MAGIC, mod._VERSION, mod.Codec.ZLIB, 64,
                                mod._crc(zbody) & 0xFFFFFFFF) + zbody
    return [
        good, traced, raw_frame, [],
        [bytes([99]), good[1]], [bytes([1]), b"tiny"], [bytes([3]), bytes(bad_magic)],
        [bytes([3]), oversized + b"x"], [bytes([0]), mismatch + body],
        [bytes([0]), bad_codec + body], [good[0], bytes(flipped)],
        [raw_frame[0], raw_frame[1], trailer()], [traced[0], traced[1], trailer()[:20]],
        [traced[0], traced[1], bytes(bad_trailer)], [bytes([1]), zlib_bad],
        [bytes([1]), good[1], trailer(), b"x"],
    ]


def _outcome(fn, parts):
    try:
        fn(parts)
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        return type(e).__name__
    return "ok"


@pytest.mark.parametrize("i", range(16))
@pytest.mark.parametrize("fn", ["peek", "decode"])
def test_same_rejections(i, fn):
    jf, pf = _corrupt_frames(J)[i], _corrupt_frames(P)[i]
    assert jf == pf
    assert _outcome(getattr(P, fn), pf) == _outcome(getattr(J, fn), jf)


@needs_native
@pytest.mark.parametrize("check_crc", [False, True], ids=["peek-grade", "crc-grade"])
def test_native_verdicts_equal(check_crc):
    frames = _corrupt_frames(J)
    want = jax_native.validate_batch(frames, J.TRACE_KINDS_MASK, J.MAX_PROTO, check_crc=check_crc)
    got = port_native.validate_batch(frames, P.TRACE_KINDS_MASK, P.MAX_PROTO, check_crc=check_crc)
    assert got == want
    # and they agree with the Python path of either package
    py = [_outcome(P.decode if check_crc else P.peek, f) == "ok" for f in frames]
    assert [v == 0 for v in got][:14] == py[:14]


def test_port_native_builds_into_its_own_directory():
    if not port_native.available():
        pytest.skip("no C++ toolchain")
    assert "tpu_rl_torch" in port_native.LIB._name and "_build" in port_native.LIB._name
    assert P.TRACE_KINDS_MASK == J.TRACE_KINDS_MASK and P.MAX_PROTO == J.MAX_PROTO
    assert P.HEADER_BYTES == J.HEADER_BYTES and P.TRAILER_BYTES == J.TRAILER_BYTES
