"""Transport-, data- and service-level fault injectors — the port of
``tpu_rl.chaos.inject``: the same seeds, draws and counts, so the same
frames and payloads come out of both packages byte for byte.

``TransportChaos`` shims one role's ``Pub``/``Sub`` sockets; ``ServiceChaos``
hooks the inference service's flush/reply path. Both are seeded per
``(chaos_seed, site, instance)`` with a salt-free hash (``zlib.crc32`` —
Python's ``hash()`` is salted per process and would break cross-process
determinism), so a fleet run replays exactly from the config alone.

Corruption flips one byte of the wire frame *past* the 12-byte protocol
header, guaranteeing a CRC mismatch at ``decode()`` — i.e. every injected
corruption yields exactly one ``n_rejected`` in the same recv call that
injected it. That same-call pairing is what makes the chaos-smoke
accounting check (`injected == fleet rejected delta`) exact rather than
eventually-consistent.
"""

from __future__ import annotations

import time
import zlib

import numpy as np

from tpu_rl_torch.chaos.plan import Fault, FaultPlan
from tpu_rl_torch.runtime.protocol import _HEADER

# XOR mask for corruption: any nonzero delta breaks the body CRC.
_FLIP = 0x5A


def site_seed(chaos_seed: int, site: str, instance: int = 0) -> int:
    """Deterministic per-socket-owner seed, stable across processes."""
    return (int(chaos_seed) & 0xFFFFFFFF) ^ zlib.crc32(
        f"{site}/{instance}".encode()
    )


class TransportChaos:
    """Per-socket fault shim: mutate/drop/delay multipart frames.

    ``on_send``/``on_recv`` return the (possibly mutated) parts list, or
    ``None`` to swallow the frame. The transport layer holds ``chaos=None``
    by default and guards with a single ``is None`` check, so the disabled
    path stays allocation-free (pinned by a tracemalloc test).
    """

    __slots__ = (
        "_send_faults",
        "_recv_faults",
        "_rng",
        "_sleep",
        "n_corrupted",
        "n_dropped",
        "n_delayed",
    )

    def __init__(
        self,
        send_faults: list[Fault],
        recv_faults: list[Fault],
        seed: int,
        sleep=time.sleep,
    ):
        self._send_faults = list(send_faults)
        self._recv_faults = list(recv_faults)
        self._rng = np.random.default_rng(seed)
        self._sleep = sleep
        self.n_corrupted = 0
        self.n_dropped = 0
        self.n_delayed = 0

    def on_send(self, parts):
        return self._apply(self._send_faults, parts)

    def on_recv(self, parts):
        return self._apply(self._recv_faults, parts)

    def _apply(self, faults, parts):
        for f in faults:
            if f.protos is not None and (
                len(parts) < 2
                or len(parts[0]) != 1
                or parts[0][0] not in f.protos
            ):
                continue
            if f.action == "delay":
                if f.p >= 1.0 or self._rng.random() < f.p:
                    self.n_delayed += 1
                    self._sleep(f.delay_ms / 1e3)
            elif f.action == "drop":
                if self._rng.random() < f.p:
                    self.n_dropped += 1
                    return None
            elif f.action == "corrupt":
                if self._rng.random() < f.p and len(parts) >= 2:
                    parts = self._corrupt(parts)
                    self.n_corrupted += 1
        return parts

    def _corrupt(self, parts):
        body = bytearray(parts[1])
        if not body:
            return parts  # already malformed; decode rejects it as-is
        # Flip a byte past the header so peek() (header-only validation at
        # the relay) passes but the body CRC at decode() fails.
        lo = _HEADER.size if len(body) > _HEADER.size else 0
        idx = lo + int(self._rng.integers(len(body) - lo))
        body[idx] ^= _FLIP
        out = list(parts)
        out[1] = bytes(body)
        return out


class DataChaos:
    """Payload-VALUE faults (``nan``/``spike``) at the producing worker.

    ``on_tick`` mutates the RolloutBatch dict just before the send —
    read-only columns (numpy views of decoded frames: a remote act's
    reply) are swapped for writable copies in the payload; a writable
    column (the port's local act step hands its CPU tensors over as
    ``.numpy()`` views) is poisoned in place, so its tensor sees it too.
    The frame stays wire-valid (CRC passes):
    the corruption must be caught by the self-healing plane, not the
    codec. Channels:

    - ``rollout`` poisons obs+rew (``nan``) or writes a finite absurd
      magnitude into obs (``spike``) — the columns ingress validates. At
      most ONE rollout-channel injection lands per frame, so
      ``n_nan + n_spike == storage-poisoned-frames`` holds exactly.
    - ``logp`` poisons log_prob, which ingress deliberately does not
      check: it reaches training and must be contained by the in-jit
      guards + watchdog (defense in depth).

    Active window per fault: ``t+..s`` offsets from construction (worker
    start), ``for=..s`` bounds the length; absent = always / forever.
    """

    __slots__ = ("_faults", "_rng", "_clock", "_t0", "n_nan", "n_spike",
                 "n_logp_nan")

    SPIKE = 1e9  # finite, but past any sane Config.ingress_abs_max

    def __init__(self, faults: list[Fault], seed: int, clock=time.monotonic):
        self._faults = list(faults)
        self._rng = np.random.default_rng(seed)
        self._clock = clock
        self._t0 = clock()
        self.n_nan = 0
        self.n_spike = 0
        self.n_logp_nan = 0

    def _active(self, f: Fault, now: float) -> bool:
        if f.at_s is None:
            return True
        start = self._t0 + f.at_s
        if now < start:
            return False
        if f.dur_s is not None and now > start + f.dur_s:
            return False
        return True

    @staticmethod
    def _writable(payload, key):
        # A read-only view is swapped for a copy, so the poke never touches
        # memory the worker does not own.
        x = payload.get(key)
        if x is None:
            return None
        if not x.flags.writeable:
            x = np.array(x)
            payload[key] = x
        return x

    def on_tick(self, payload: dict) -> None:
        """Maybe poison one RolloutBatch payload in place, pre-send."""
        now = self._clock()
        rollout_hit = False
        for f in self._faults:
            if not self._active(f, now):
                continue
            if self._rng.random() >= f.p:
                continue
            if f.target == "rollout":
                if rollout_hit:
                    continue  # one rollout injection per frame: exact parity
                rollout_hit = True
                obs = self._writable(payload, "obs")
                if f.action == "nan":
                    if obs is not None:
                        obs.flat[0] = np.nan
                    rew = self._writable(payload, "rew")
                    if rew is not None:
                        rew.flat[0] = np.nan
                    self.n_nan += 1
                else:  # spike: finite but absurd — trips the range check
                    if obs is not None:
                        obs.flat[0] = self.SPIKE
                    self.n_spike += 1
            else:  # logp
                lp = self._writable(payload, "log_prob")
                if lp is not None:
                    lp.flat[0] = np.nan
                    self.n_logp_nan += 1


class ServiceChaos:
    """Inference-service faults: pre-flush stalls and swallowed replies."""

    __slots__ = ("_stalls", "_refusals", "_rng", "_sleep", "n_stalled", "n_refused")

    def __init__(self, faults: list[Fault], seed: int, sleep=time.sleep):
        self._stalls = [f for f in faults if f.action == "stall"]
        self._refusals = [f for f in faults if f.action == "refuse"]
        self._rng = np.random.default_rng(seed)
        self._sleep = sleep
        self.n_stalled = 0
        self.n_refused = 0

    def maybe_stall(self) -> None:
        """Called once per batch flush."""
        for f in self._stalls:
            if f.p >= 1.0 or self._rng.random() < f.p:
                self.n_stalled += 1
                self._sleep(f.delay_ms / 1e3)

    def refuse(self) -> bool:
        """Called once per reply; True means swallow it (client times out)."""
        for f in self._refusals:
            if self._rng.random() < f.p:
                self.n_refused += 1
                return True
        return False


def maybe_transport_chaos(cfg, site: str, instance: int = 0):
    """Build a ``TransportChaos`` for one role, or None (the common case)."""
    spec = getattr(cfg, "chaos_spec", None)
    if not spec:
        return None
    send_f, recv_f = FaultPlan.parse(spec).transport_faults(site)
    if not send_f and not recv_f:
        return None
    return TransportChaos(
        send_f, recv_f, seed=site_seed(getattr(cfg, "chaos_seed", 0), site, instance)
    )


def maybe_data_chaos(cfg, site: str = "worker", instance: int = 0):
    """Build a ``DataChaos`` for one worker instance, or None. Faults
    carrying ``wid=`` only reach the named instance; the rest of the fleet
    gets None and keeps producing clean data."""
    spec = getattr(cfg, "chaos_spec", None)
    if not spec:
        return None
    faults = FaultPlan.parse(spec).data_faults(instance)
    if not faults:
        return None
    return DataChaos(
        faults, seed=site_seed(getattr(cfg, "chaos_seed", 0), site, instance)
    )


def maybe_service_chaos(cfg, service: str = "inference"):
    """Build a ``ServiceChaos`` for one service, or None."""
    spec = getattr(cfg, "chaos_spec", None)
    if not spec:
        return None
    faults = FaultPlan.parse(spec).service_faults(service)
    if not faults:
        return None
    return ServiceChaos(
        faults, seed=site_seed(getattr(cfg, "chaos_seed", 0), service)
    )
