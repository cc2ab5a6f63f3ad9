"""Crash flight recorder: postmortem state capture for role processes.

The port's own copy of ``tpu_rl.obs.flightrec``, unchanged in behaviour.

A role that dies today leaves a traceback file (``utils.errlog``) and nothing
else — no timeline of what the process was doing in its final seconds, no
config identity to match the corpse against a deployment. The flight recorder
closes that gap: every role registers one per process, holding

- the role's bounded span ring (its ``TraceRecorder``, when tracing is on),
- the last error seen (fatal or noted by the role itself),
- a config fingerprint (sha256 over the sorted config dict) so a dump is
  attributable to an exact configuration,
- an optional role-supplied ``extra`` callable for live counters
  (queue depths, assembler stats) captured at dump time.

Dumps are atomic (tmp + rename) to
``result_dir/flightrec-<role>-<pid>.json`` and fire on:

- ``SIGUSR1`` — poke a live-but-suspect process from the shell
  (``kill -USR1 <pid>``) without stopping it;
- fatal exception — ``utils.errlog.role_entry`` calls :func:`dump_on_crash`
  before re-raising, so the recorder lands next to the crash log.

The signal handler is only installed when running on the process's main
thread (Python's signal API requires it; tests run roles as threads) — the
crash-dump path works regardless.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import socket
import threading
import time
import traceback

# One recorder per process: the crash hook in utils.errlog has no handle on
# the role object, so the installed recorder is reachable module-globally.
_CURRENT: "FlightRecorder | None" = None

# Cleanup callbacks that must fire on a fatal exception BEFORE the dump —
# e.g. ``ProfilerCapture.stop`` (``torch.profiler``) so an in-flight capture is flushed to
# disk instead of dying with the process. Kept module-global (like
# ``_CURRENT``) and run even when no recorder is installed: crash cleanup
# must not depend on result_dir being set.
_CRASH_HOOKS: list = []


def add_crash_hook(fn) -> None:
    """Register ``fn()`` to run at crash time (idempotent per callable)."""
    if fn not in _CRASH_HOOKS:
        _CRASH_HOOKS.append(fn)


def remove_crash_hook(fn) -> None:
    if fn in _CRASH_HOOKS:
        _CRASH_HOOKS.remove(fn)


def _run_crash_hooks() -> None:
    for fn in list(_CRASH_HOOKS):
        try:
            fn()
        except Exception:  # noqa: BLE001 — cleanup must not mask the crash
            pass


def config_fingerprint(cfg) -> str | None:
    """Stable short hash of a config's JSON-able dict — enough to tell two
    dumps apart by configuration without shipping the whole config."""
    try:
        d = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(vars(cfg))
        blob = json.dumps(d, sort_keys=True, default=str)
    except (TypeError, ValueError):
        return None
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class FlightRecorder:
    def __init__(
        self,
        role: str,
        result_dir: str | None,
        tracer=None,
        cfg=None,
        extra=None,
    ):
        self.role = role
        self.result_dir = result_dir
        self.tracer = tracer
        self.fingerprint = config_fingerprint(cfg) if cfg is not None else None
        self.extra = extra  # callable -> dict, evaluated at dump time
        self.last_error: str | None = None
        self.n_dumps = 0

    # ---------------------------------------------------------------- wiring
    def install(self) -> "FlightRecorder":
        global _CURRENT
        _CURRENT = self
        if threading.current_thread() is threading.main_thread():
            try:
                signal.signal(signal.SIGUSR1, self._on_signal)
            except (ValueError, OSError, AttributeError):
                pass  # exotic platform / nested handler: crash path still works
        return self

    def _on_signal(self, signum, frame) -> None:
        try:
            self.dump("SIGUSR1")
        except OSError:
            pass  # a poked process must never die of its own postmortem

    def note_error(self, exc: BaseException) -> None:
        self.last_error = "".join(
            traceback.format_exception(type(exc), exc, exc.__traceback__)
        )

    # ------------------------------------------------------------------ dump
    def snapshot(self, reason: str = "snapshot") -> dict:
        doc = {
            "role": self.role,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "ts_ns": time.time_ns(),
            "reason": reason,
            "config_fingerprint": self.fingerprint,
            "last_error": self.last_error,
            "trace": (
                self.tracer.to_chrome() if self.tracer is not None else None
            ),
        }
        if self.extra is not None:
            try:
                doc["extra"] = self.extra()
            except Exception as e:  # noqa: BLE001 — extra() runs role code
                doc["extra"] = {"error": repr(e)}
        return doc

    def dump(self, reason: str = "snapshot") -> str | None:
        """Atomic write; returns the path, or None without a result_dir."""
        if self.result_dir is None:
            return None
        os.makedirs(self.result_dir, exist_ok=True)
        path = os.path.join(
            self.result_dir, f"flightrec-{self.role}-{os.getpid()}.json"
        )
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(reason), f)
        os.replace(tmp, path)
        self.n_dumps += 1
        return path


def install(
    role: str, result_dir: str | None, tracer=None, cfg=None, extra=None
) -> FlightRecorder:
    """Create + register the process's recorder (latest install wins)."""
    return FlightRecorder(role, result_dir, tracer, cfg, extra).install()


def current() -> FlightRecorder | None:
    return _CURRENT


def dump_on_crash(exc: BaseException) -> str | None:
    """Crash hook for ``utils.errlog.role_entry``: run registered cleanup
    hooks (profiler stop etc.), then record the fatal error into the
    installed recorder (if any) and dump it. Never raises."""
    _run_crash_hooks()
    fr = _CURRENT
    if fr is None:
        return None
    try:
        fr.note_error(exc)
        return fr.dump("fatal-exception")
    except Exception:  # noqa: BLE001 — postmortem must not mask the crash
        return None
