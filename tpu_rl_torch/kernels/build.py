"""Build the port's CUDA sources (``tpu_rl_torch/csrc/*.cu``) with ``nvcc`` on
first use and bind them with ``ctypes``.

Each source becomes its own shared library with a plain C interface, built
for Hopper only (``sm_90a``) into ``tpu_rl_torch/_build/`` (git-ignored). The
library's file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edit
rebuilds and an unchanged tree reuses what is there. :func:`build_all` starts
one ``nvcc`` per source at once and waits for all of them. ``ptxas -v``
reports every kernel's registers and spills; the compiler's output is kept
beside the library and :func:`resource_usage` reads it back.

Nothing here runs at import time: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def sources() -> list[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    # every shared header too: an edit to one rebuilds the sources that may include it
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every missing library at once (one ``nvcc`` per source) and
    return ``{name: path}``. Raises with the compiler's output if any fails."""
    names = sources() if names is None else names
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu (exit {proc.returncode}):\n{out}")
        else:
            todo[name].with_suffix(".log").write_text(out)
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


def resource_usage(names: list[str] | None = None) -> list[str]:
    """``<source>.cu <kernel>: N registers, S bytes spill stores`` for every
    kernel instance, from the ``ptxas -v`` output kept by the build."""
    lines = []
    for name, target in build_all(names).items():
        log = target.with_suffix(".log")
        kernel, spills = None, "?"
        for line in (log.read_text() if log.exists() else "").splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                kernel = m.group(1)
            elif m := re.search(r"(\d+) bytes spill stores", line):
                spills = m.group(1)
            elif (m := re.search(r"Used (\d+) registers", line)) and kernel:
                lines.append(f"{name}.cu {kernel}: {m.group(1)} registers, {spills} bytes spill stores")
    return lines


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build_all([name])[name]))
        return _libs[name]


def bind(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry ``<name>_launch`` of ``csrc/<name>.cu``, built on first
    use, with ``argtypes`` set and an int return (the CUDA error, 0 =
    launched). Pointers and the stream must be ``ctypes.c_void_p``: as an
    int, ctypes would cut them to 32 bits."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(load(name), f"{name}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn
