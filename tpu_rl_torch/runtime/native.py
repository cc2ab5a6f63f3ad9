"""Loader for the native C++ codec (the package's ``native/codec.cpp``) —
the port's copy of ``tpu_rl.runtime.native``.

Builds the shared library on first use with ``g++ -O3`` into the package's
git-ignored ``_build/`` directory (named by the source's hash), binds it
through ctypes — which releases the GIL for the duration of each call, so
compression overlaps the Python loop — and exposes ``compress`` /
``decompress`` / ``crc32`` / ``validate_batch``. When no toolchain is
available the module still imports, ``LIB`` is None and the protocol layer
falls back to zlib, with a one-time warning naming the build command.
``TPU_RL_NATIVE=0`` disables the library (the A/B switch).

This is a host codec, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "codec.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()

_DISABLED = os.environ.get("TPU_RL_NATIVE", "1") == "0"

# The exact command _build() runs; surfaced in the one-time fallback warning
# so an operator can reproduce the failure by hand.
BUILD_CMD = "g++ -O3 -shared -fPIC -std=c++17 -o <out.so> " + SRC

_warned_fallback = False


def _warn_fallback(reason: str) -> None:
    """Warn ONCE that the native codec is unavailable, naming the exact
    compile command, so a missing toolchain is never silent."""
    global _warned_fallback
    if _warned_fallback or _DISABLED:
        return
    _warned_fallback = True
    print(
        f"tpu_rl_torch.native: falling back to pure-Python codec ({reason}); "
        f"to build the native library run: {BUILD_CMD}",
        file=sys.stderr,
    )


def _build() -> str | None:
    """Build from source, cached by the source's sha256: a binary built from
    an older source can never shadow the current one."""
    if not os.path.exists(SRC):
        _warn_fallback(f"source missing: {SRC}")
        return None
    with open(SRC, "rb") as f:
        src_hash = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_BUILD_DIR, f"libtpurl_codec_{src_hash}.so")
    if os.path.exists(so):
        return so
    try:
        for name in os.listdir(_BUILD_DIR):
            if name.startswith("libtpurl_codec_") and name.endswith(".so"):
                os.unlink(os.path.join(_BUILD_DIR, name))
    except OSError:
        pass
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # Atomic build: compile to a temp name, rename into place (concurrent
    # role processes may race to build at first launch).
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, SRC],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, so)
        return so
    except subprocess.CalledProcessError as e:
        stderr = (e.stderr or b"").decode(errors="replace").strip()
        _warn_fallback(f"compile failed: {stderr.splitlines()[-1] if stderr else e}")
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    except (subprocess.SubprocessError, OSError) as e:
        _warn_fallback(f"build failed: {type(e).__name__}: {e}")
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def _load() -> ctypes.CDLL | None:
    if _DISABLED:
        return None
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        _warn_fallback(f"dlopen failed: {e}")
        return None
    i64, u32, buf = ctypes.c_int64, ctypes.c_uint32, ctypes.c_char_p
    lib.tpurl_compress_bound.restype = i64
    lib.tpurl_compress_bound.argtypes = [i64]
    lib.tpurl_compress.restype = i64
    lib.tpurl_compress.argtypes = [buf, i64, ctypes.c_void_p, i64]
    lib.tpurl_decompress.restype = i64
    lib.tpurl_decompress.argtypes = [buf, i64, ctypes.c_void_p, i64]
    lib.tpurl_crc32.restype = u32
    lib.tpurl_crc32.argtypes = [buf, i64, u32]
    pp = ctypes.POINTER(ctypes.c_char_p)
    batch_args = [
        pp,                               # parts (flattened pointers)
        ctypes.POINTER(i64),              # lens
        ctypes.POINTER(ctypes.c_int32),   # nparts
        i64,                              # n_frames
        u32,                              # trace_kinds bitmask
        ctypes.c_uint8,                   # max_proto
        ctypes.POINTER(ctypes.c_uint8),   # out verdicts
    ]
    lib.tpurl_validate_batch.restype = i64
    lib.tpurl_validate_batch.argtypes = batch_args
    lib.tpurl_validate_batch_crc.restype = i64
    lib.tpurl_validate_batch_crc.argtypes = batch_args
    return lib


with _lock:
    LIB = _load()


def available() -> bool:
    return LIB is not None


def compress(data: bytes) -> bytes:
    assert LIB is not None
    bound = LIB.tpurl_compress_bound(len(data))
    out = ctypes.create_string_buffer(bound)
    n = LIB.tpurl_compress(data, len(data), out, bound)
    if n < 0:
        raise RuntimeError(f"native compress failed: {n}")
    return out.raw[:n]


def decompress(data: bytes, raw_size: int) -> bytes:
    assert LIB is not None
    out = ctypes.create_string_buffer(raw_size) if raw_size else b""
    if raw_size == 0:
        return b""
    n = LIB.tpurl_decompress(data, len(data), out, raw_size)
    if n != raw_size:
        raise RuntimeError(f"native decompress failed: {n} != {raw_size}")
    return out.raw[:n]


def crc32(data: bytes, seed: int = 0) -> int:
    assert LIB is not None
    return int(LIB.tpurl_crc32(data, len(data), seed))


def validate_batch(
    frames: list[list[bytes]],
    trace_kinds_mask: int,
    max_proto: int,
    check_crc: bool = False,
) -> list[int]:
    """Validate N multipart frames in ONE native call (GIL released for the
    whole batch); one verdict per frame, 0 = valid. Frames whose part count
    exceeds the native cap (16) are rejected without entering the library.
    With ``check_crc`` the body crc32 is verified too (the storage edge);
    without it this is relay-grade ``peek``."""
    assert LIB is not None
    n = len(frames)
    if n == 0:
        return []
    flat: list[bytes] = []
    nparts = (ctypes.c_int32 * n)()
    for i, parts in enumerate(frames):
        nparts[i] = len(parts)
        if 0 < len(parts) <= 16:
            flat.extend(parts)
    total = len(flat)
    # c_char_p arrays alias the bytes objects' buffers directly (no copy);
    # `flat` keeps them alive across the call.
    ptrs = (ctypes.c_char_p * total)(*flat) if total else (ctypes.c_char_p * 1)()
    lens = (ctypes.c_int64 * max(total, 1))(*[len(p) for p in flat])
    out = (ctypes.c_uint8 * n)()
    fn = LIB.tpurl_validate_batch_crc if check_crc else LIB.tpurl_validate_batch
    rc = fn(
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_char_p)),
        lens,
        nparts,
        n,
        trace_kinds_mask & 0xFFFFFFFF,
        max_proto & 0xFF,
        out,
    )
    if rc < 0:
        raise RuntimeError(f"native validate_batch failed: {rc}")
    return list(out)
