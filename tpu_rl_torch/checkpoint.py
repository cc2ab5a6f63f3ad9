"""Crash-atomic, asynchronous checkpoint and resume — the port of
``tpu_rl.checkpoint``, with ``torch.save`` in place of orbax.

**Atomicity.** A save is a two-phase commit. The state is written into its
final directory ``{model_dir}/{algo}_{idx}/`` (``state.pt``, fsynced), and
only then is a ``COMMITTED`` marker placed inside it (tmp file, fsync,
``os.replace``). Every read path (:func:`restore_actor_params`,
:meth:`Checkpointer.restore_run`, the GC) filters on the marker, so a save
torn by a crash is invisible: readers fall back to the previous committed
index, and the next :class:`Checkpointer` removes it. The marker holds the
run meta as JSON (update index, run epoch, config fingerprint, and for the
colocated loop the state of its random generator), and a resume refuses a
checkpoint whose fingerprint is not the config's unless forced.

**Asynchrony.** With ``async_save`` the caller's ``save`` takes a
device-side snapshot (a ``clone()`` of every tensor, so a later in-place
update cannot reach it) and returns; a writer thread copies the snapshot to
the host on a stream of its own, writes it, commits it and runs the GC.
Saves are latest-wins: a newer snapshot replaces a queued one that has not
started (counted in ``n_skipped``). A writer's error is raised by the next
``save`` or ``flush``. :meth:`Checkpointer.drain_save_secs` gives the wall
time of each committed save.

A state is any tree of dataclasses (the port's ``TrainState`` and
``SACState``), dicts, lists and tensors. It is stored as plain dicts and
tensors, so ``torch.load(weights_only=True)`` reads it back, and it is
restored into the structure, dtypes and devices of a template.
Directory names keep ``tpu_rl``'s ``{algo}_{idx}``: the newest index wins.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Any

import torch

from tpu_rl_torch.config import FINGERPRINT_FIELDS

# Marker filename inside a committed checkpoint directory. Its presence is
# the commit point; its content is the run-meta JSON.
COMMIT_MARKER = "COMMITTED"
# The state's file inside a checkpoint directory.
STATE_FILE = "state.pt"


def resume_fingerprint(cfg) -> str:
    """Stable hash of the structure-defining config subset, equal to
    ``tpu_rl.checkpoint.resume_fingerprint`` for the same params file.
    Stored in every commit marker; checked on resume (``Config.resume_force``
    overrides)."""
    sub = {k: getattr(cfg, k) for k in FINGERPRINT_FIELDS}
    blob = json.dumps(sub, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def is_committed(path: str) -> bool:
    return os.path.exists(os.path.join(path, COMMIT_MARKER))


def read_meta(path: str) -> dict:
    """Run meta of a committed checkpoint directory; {} when it is absent or
    not a JSON object (the state itself is complete by write order, so a
    reader may still use it with default meta)."""
    try:
        with open(os.path.join(path, COMMIT_MARKER)) as f:
            meta = json.load(f)
        return meta if isinstance(meta, dict) else {}
    except (OSError, ValueError):
        return {}


def _ckpt_dirs(model_dir: str, algo: str, committed_only: bool = True) -> list[tuple[int, str]]:
    """[(idx, path)] of the checkpoints, sorted by idx. By default only the
    committed ones: a torn or in-flight save does not exist for readers."""
    if not os.path.isdir(model_dir):
        return []
    out = []
    pat = re.compile(re.escape(algo) + r"_(\d+)$")
    for name in os.listdir(model_dir):
        m = pat.match(name)
        if not m:
            continue
        path = os.path.join(model_dir, name)
        if committed_only and not is_committed(path):
            continue
        out.append((int(m.group(1)), path))
    return sorted(out)


def latest_committed(model_dir: str, algo: str) -> tuple[int, str] | None:
    """(idx, path) of the newest committed checkpoint, or None."""
    found = _ckpt_dirs(os.path.abspath(model_dir), algo)
    return found[-1] if found else None


def _write_marker(path: str, meta: dict) -> None:
    """The commit point: the meta JSON placed by tmp + fsync + replace."""
    tmp = os.path.join(path, f".{COMMIT_MARKER}.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, COMMIT_MARKER))


def copy_committed(
    src_path: str,
    dst_model_dir: str,
    algo: str,
    dst_idx: int,
    meta_overrides: dict | None = None,
) -> str:
    """Copy a committed checkpoint to ``{dst_model_dir}/{algo}_{dst_idx}``
    with the two-phase commit: the state files first, WITHOUT the marker,
    then the marker (the source's meta with ``meta_overrides`` and the new
    ``idx``) placed last. A crash at any point leaves an uncommitted
    directory that no reader sees and the next Checkpointer removes."""
    if not is_committed(src_path):
        raise ValueError(f"source checkpoint {src_path} is not committed")
    dst_path = os.path.join(os.path.abspath(dst_model_dir), f"{algo}_{dst_idx}")
    shutil.rmtree(dst_path, ignore_errors=True)  # stale torn debris only
    os.makedirs(os.path.dirname(dst_path), exist_ok=True)
    shutil.copytree(
        src_path, dst_path,
        ignore=shutil.ignore_patterns(COMMIT_MARKER, f".{COMMIT_MARKER}.tmp"),
    )
    _write_marker(dst_path, {**read_meta(src_path), **(meta_overrides or {}), "idx": dst_idx})
    return dst_path


# ------------------------------------------------------------ state trees
def _tree_map(fn, tree: Any) -> Any:
    """``fn`` over the tensors of a tree of dataclasses, dicts, lists and
    tuples; other leaves pass through. Dataclasses keep their type."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def _to_plain(tree: Any) -> Any:
    """A state as plain dicts, lists and tensors (what
    ``torch.load(weights_only=True)`` reads back)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _to_plain(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _to_plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_plain(v) for v in tree]
    return tree


def _into(template: Any, plain: Any, where: str = "state") -> Any:
    """``plain`` restored into the structure of ``template``: its
    dataclasses, keys, and each tensor's dtype and device (shapes must
    agree)."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        names = [f.name for f in dataclasses.fields(template)]
        _same_keys(names, plain, where)
        return type(template)(**{n: _into(getattr(template, n), plain[n], f"{where}.{n}")
                                 for n in names})
    if isinstance(template, dict):
        _same_keys(list(template), plain, where)
        return {k: _into(v, plain[k], f"{where}.{k}") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(plain, (list, tuple)) or len(plain) != len(template):
            raise ValueError(f"checkpoint {where}: not a sequence of {len(template)}")
        return type(template)(_into(t, p, f"{where}[{i}]")
                              for i, (t, p) in enumerate(zip(template, plain)))
    if torch.is_tensor(template):
        if not torch.is_tensor(plain) or plain.shape != template.shape:
            got = tuple(plain.shape) if torch.is_tensor(plain) else type(plain).__name__
            raise ValueError(f"checkpoint {where}: {got}, the template has {tuple(template.shape)}")
        return plain.to(device=template.device, dtype=template.dtype)
    return plain


def _same_keys(names: list, plain: Any, where: str) -> None:
    if not isinstance(plain, dict) or set(plain) != set(names):
        got = sorted(plain) if isinstance(plain, dict) else type(plain).__name__
        raise ValueError(f"checkpoint {where}: keys {got}, the template has {sorted(names)}")


def _load(path: str) -> Any:
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def restore_actor_params(model_dir: str, algo: str):
    """The actor parameters of the NEWEST committed checkpoint as
    ``{"actor": state_dict}`` of CPU tensors (the acting contract), or None
    when there is none. Template-free. Falls back newest -> oldest when a
    checkpoint cannot be read (a spawning reader can lose a race with the
    writer's GC)."""
    for _idx, path in reversed(_ckpt_dirs(os.path.abspath(model_dir), algo)):
        try:
            raw = _load(path)
        except Exception:  # lost a race with the GC, or a damaged file
            continue
        # TrainState keeps params["actor"]; SACState keeps actor_params.
        params = raw.get("params") if isinstance(raw, dict) else None
        actor = params.get("actor") if isinstance(params, dict) else None
        if actor is None and isinstance(raw, dict):
            actor = raw.get("actor_params")
        if actor is not None:
            return {"actor": actor}
    return None


def _snapshot(state: Any) -> tuple[Any, dict]:
    """A device-side copy of every tensor, so that the writer owns buffers
    no later update writes into, and per card an event recorded after the
    copies."""
    cards = set()

    def clone(t):
        if t.device.type == "cuda":
            cards.add(t.device)
        return t.detach().clone()

    snap = _tree_map(clone, state)
    ready = {}
    for dev in cards:
        ready[dev] = torch.cuda.Event()
        ready[dev].record(torch.cuda.current_stream(dev))
    return snap, ready


def _to_host(state: Any, ready: dict | None = None) -> Any:
    """CPU copies of every tensor. With ``ready`` (a snapshot's events), the
    copies of CUDA tensors run on a side stream that waits for the event,
    so that they do not queue behind the updates enqueued since."""
    streams = {}
    for dev, event in (ready or {}).items():
        streams[dev] = torch.cuda.Stream(device=dev)
        streams[dev].wait_event(event)

    def copy(t):
        side = streams.get(t.device)
        with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
            return t.detach().to("cpu", copy=True)

    return _tree_map(copy, state)


class Checkpointer:
    """Single-writer checkpoint manager. ``async_save=False`` makes
    ``save()`` blocking but atomic; ``Config.ckpt_async`` moves the copy to
    the host and the write onto the writer thread.

    Under data parallelism rank 0 is the writer and the other ranks open
    the directory with ``writer=False``: they only restore (committed
    checkpoints, by the same fingerprint rule), never clean, save or
    collect."""

    def __init__(
        self, model_dir: str, algo: str, keep: int = 5, async_save: bool = False,
        writer: bool = True,
    ):
        self.model_dir = os.path.abspath(model_dir)
        self.algo = algo
        self.keep = max(1, int(keep))
        self.async_save = bool(async_save) and writer
        self.writer = bool(writer)
        os.makedirs(self.model_dir, exist_ok=True)
        if self.writer:
            self._clean_torn()
        # the writer thread's state (idle unless async_save)
        self._cond = threading.Condition()
        self._queued: tuple[Any, dict, int, dict] | None = None
        self._inflight = False
        self._stop = False
        self._error: Exception | None = None
        self._durations: list[float] = []
        self._thread: threading.Thread | None = None
        self.n_saves = 0  # committed saves
        self.n_skipped = 0  # latest-wins drops of queued, unstarted saves
        self.last_save_secs = 0.0

    # ------------------------------------------------------------- lifecycle
    def _clean_torn(self) -> None:
        """Remove directories torn by a crash mid-save. Safe: this process
        is the only writer, and no reader sees an uncommitted directory."""
        for _idx, path in _ckpt_dirs(self.model_dir, self.algo, committed_only=False):
            if not is_committed(path):
                shutil.rmtree(path, ignore_errors=True)

    def _ensure_thread(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="ckpt-writer", daemon=True)
            self._thread.start()

    def _raise_pending_error(self) -> None:
        with self._cond:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("async checkpoint save failed") from err

    # ------------------------------------------------------------------ save
    def save(self, state: Any, idx: int, meta: dict | None = None) -> str:
        """Save ``state`` as ``{model_dir}/{algo}_{idx}`` with the run meta
        ``meta`` committed beside it. Blocking without ``async_save``;
        otherwise a device-side snapshot is queued and the call returns (an
        error of an earlier background save is raised here)."""
        if not self.writer:
            raise RuntimeError("this Checkpointer reads only (writer=False): rank 0 saves")
        self._raise_pending_error()
        path = os.path.join(self.model_dir, f"{self.algo}_{idx}")
        meta = dict(meta or {})
        if not self.async_save:
            t0 = time.perf_counter()
            self._write(_to_host(state), idx, meta)
            self._record(time.perf_counter() - t0)
            return path
        snap, ready = _snapshot(state)
        self._ensure_thread()
        with self._cond:
            if self._queued is not None:
                self.n_skipped += 1  # latest wins: the newer snapshot replaces it
            self._queued = (snap, ready, idx, meta)
            self._cond.notify_all()
        return path

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._queued is None and not self._stop:
                    self._cond.wait()
                if self._queued is None:  # stopped with nothing pending
                    return
                snap, ready, idx, meta = self._queued
                self._queued = None
                self._inflight = True
            t0 = time.perf_counter()
            try:
                self._write(_to_host(snap, ready), idx, meta)
                dur: float | None = time.perf_counter() - t0
            except Exception as e:  # raised by the next save() or flush()
                dur = None
                with self._cond:
                    self._error = e
            del snap
            with self._cond:
                self._inflight = False
                if dur is not None:
                    self._record(dur)
                self._cond.notify_all()

    def _write(self, host_state: Any, idx: int, meta: dict) -> None:
        """The two-phase commit: the state file, then the marker."""
        path = os.path.join(self.model_dir, f"{self.algo}_{idx}")
        shutil.rmtree(path, ignore_errors=True)  # an older save of this idx
        os.makedirs(path)
        with open(os.path.join(path, STATE_FILE), "wb") as f:
            torch.save(_to_plain(host_state), f)
            f.flush()
            os.fsync(f.fileno())
        meta.setdefault("idx", idx)
        meta.setdefault("algo", self.algo)
        meta.setdefault("saved_at", time.time())
        _write_marker(path, meta)
        self._gc()

    def _record(self, dur: float) -> None:
        self.n_saves += 1
        self.last_save_secs = dur
        self._durations.append(dur)

    # ----------------------------------------------------------- observation
    @property
    def pending(self) -> int:
        """Saves accepted but not yet committed (0-2: one queued, one in
        flight)."""
        with self._cond:
            return (self._queued is not None) + self._inflight

    def drain_save_secs(self) -> list[float]:
        """Wall seconds of the saves committed since the last drain, on
        whichever thread wrote them."""
        with self._cond:
            out, self._durations = self._durations, []
        return out

    def flush(self, timeout: float | None = None) -> None:
        """Block until every accepted save is committed (async mode)."""
        with self._cond:
            deadline = None if timeout is None else time.monotonic() + timeout
            while self._queued is not None or self._inflight:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    break
                self._cond.wait(timeout=left)
        self._raise_pending_error()

    # --------------------------------------------------------------- restore
    def latest_idx(self) -> int | None:
        found = _ckpt_dirs(self.model_dir, self.algo)
        return found[-1][0] if found else None

    def restore_latest(self, template: Any) -> tuple[Any, int] | None:
        """The newest committed checkpoint restored into the structure of
        ``template``: (state, idx), or None when there is none."""
        out = self.restore_run(template)
        return (out[0], out[1]) if out is not None else None

    def restore_run(
        self, template: Any, fingerprint: str | None = None, force: bool = False
    ) -> tuple[Any, int, dict] | None:
        """Full-run resume: (state, idx, meta) of the newest committed
        checkpoint, or None. When ``fingerprint`` is given and the stored one
        differs, refuses (RuntimeError) unless ``force``: a tree written by a
        structurally different config is corruption, not a resume."""
        return self.restore_nth_latest(template, 1, fingerprint, force)

    def restore_nth_latest(
        self, template: Any, n: int = 1, fingerprint: str | None = None, force: bool = False
    ) -> tuple[Any, int, dict] | None:
        """The ``n``-th newest committed checkpoint (``n=1`` the newest; past
        the oldest, the oldest), with :meth:`restore_run`'s fingerprint
        rule."""
        found = _ckpt_dirs(self.model_dir, self.algo)
        if not found:
            return None
        idx, path = found[max(0, len(found) - max(1, int(n)))]
        meta = read_meta(path)
        stored = meta.get("fingerprint")
        if fingerprint is not None and stored is not None and stored != fingerprint:
            if not force:
                raise RuntimeError(
                    f"checkpoint {path} was written by a different config "
                    f"(fingerprint {stored} != {fingerprint}); set resume_force to override"
                )
            print(
                f"[checkpoint] WARNING: fingerprint mismatch ({stored} != {fingerprint}) "
                "overridden by resume_force",
                flush=True,
            )
        plain = _load(path)
        return (plain if template is None else _into(template, plain)), idx, meta

    def discard_above(self, idx: int) -> int:
        """Remove every committed checkpoint above ``idx`` (a rollback calls
        it after :meth:`flush`); returns how many went."""
        removed = 0
        for ck_idx, path in _ckpt_dirs(self.model_dir, self.algo):
            if ck_idx > idx:
                shutil.rmtree(path, ignore_errors=True)
                removed += 1
        return removed

    # -------------------------------------------------------------------- gc
    def _gc(self) -> None:
        """Keep the ``keep`` newest committed directories. Uncommitted ones
        are never touched: one may be a save in flight."""
        for _idx, path in _ckpt_dirs(self.model_dir, self.algo)[: -self.keep]:
            shutil.rmtree(path, ignore_errors=True)

    def close(self) -> None:
        """Drain the queued save, stop the writer thread, and raise a
        writer's error."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=120.0)
            self._thread = None
        self._raise_pending_error()
