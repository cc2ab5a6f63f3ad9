"""NTP-style clock-offset estimation from timestamp echoes on existing frames.

The port's own copy of ``tpu_rl.obs.clocksync``, unchanged in behaviour.

Every role's ``TraceRecorder`` anchors its spans to the local ``time.time_ns``
wall clock — but fleet hosts' wall clocks disagree by milliseconds (or worse),
which is the same order as the transport latencies the fleet trace is supposed
to show. This estimator recovers each remote process's offset against the
storage process's clock WITHOUT new ports or probe traffic, from timestamps
already riding the fleet's frames:

- ``t0``: the learner stamps ``t_tx`` onto every Model broadcast;
- ``t1``: the worker notes its receive time for the newest broadcast;
- ``t2``: the worker stamps its Telemetry snapshot at send (``clk`` field,
  echoing t0/t1);
- ``t3``: the storage edge notes the snapshot's ingest time.

Learner and storage are colocated by construction (they share a shm store),
so t0 and t3 are readings of the SAME reference clock and the four stamps
form a full NTP round trip through the worker:

    offset = ((t1 - t0) + (t2 - t3)) / 2        (remote minus reference)
    delay  = (t3 - t0) - (t2 - t1)

with the classic bound |error| <= delay/2, which holds under arbitrarily
asymmetric path latencies — that worst case is exactly what the uncertainty
must cover, so it is reported, never assumed away. Samples are filtered
NTP-style: the estimate comes from the minimum-delay sample in a sliding
window (least queueing noise), and its uncertainty grows with sample age at a
generous crystal-drift allowance.

Managers have no return path on existing frames (their snapshots flow one
way), so they get a one-way estimate: each ``t_rx - t_tx`` observation is
``delay - offset`` shifted, making ``max(t_tx - t_rx)`` a lower bound on the
offset that tightens with the minimum-delay frame. These estimates are
flagged ``kind="one-way"`` so the merger and dashboards can show them as
bounds, not truths.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

# Crystal-oscillator drift allowance: uncertainty grows by this much per
# second since the sample was taken. 200 ppm is far beyond typical server
# crystals (~10-50 ppm) — generous on purpose, the bound must hold.
DRIFT_PPM = 200.0
# Uncertainty floor: even a zero-delay sample can't beat timestamp
# granularity + interrupt jitter.
MIN_UNCERTAINTY_NS = 1_000
# One-way estimates can't bound the path delay at all; give them a wide
# floor so nobody mistakes them for a calibrated offset.
ONE_WAY_FLOOR_NS = 1_000_000


@dataclass
class ClockEstimate:
    """Offset of a remote process's clock relative to the reference clock
    (``remote = reference + offset_ns``), with an uncertainty the true
    offset is guaranteed to lie within (NTP delay bound + drift allowance)."""

    offset_ns: int
    uncertainty_ns: int
    n_samples: int
    kind: str  # "rtt" (full round trip) or "one-way" (lower bound)
    age_s: float  # age of the winning sample when the estimate was made


class _Sample:
    __slots__ = ("t_local_ns", "offset_ns", "delay_ns", "kind")

    def __init__(self, t_local_ns: int, offset_ns: int, delay_ns: int, kind: str):
        self.t_local_ns = t_local_ns
        self.offset_ns = offset_ns
        self.delay_ns = delay_ns
        self.kind = kind


class ClockSync:
    """Per-source sliding-window offset estimator. Keys are opaque strings
    (the telemetry plane uses ``"role/host/pid"``)."""

    def __init__(self, window: int = 64, clock=time.time_ns):
        self.window = int(window)
        self.clock = clock
        self._samples: dict[str, deque] = {}
        self.n_samples = 0

    # ---------------------------------------------------------------- ingest
    def add_round_trip(
        self, key: str, t0: int, t1: int, t2: int, t3: int
    ) -> None:
        """One full NTP exchange: reference-send t0, remote-recv t1,
        remote-send t2, reference-recv t3 (all ``time_ns`` readings)."""
        delay = (t3 - t0) - (t2 - t1)
        if delay < 0:
            # Physically impossible ordering — a re-used echo or a stepped
            # clock mid-exchange. Clamp rather than drop: the offset sample
            # is still the best available, just with no delay credit.
            delay = 0
        offset = ((t1 - t0) + (t2 - t3)) // 2
        self._push(key, offset, delay, "rtt")

    def add_one_way(self, key: str, t_tx: int, t_rx: int) -> None:
        """One remote-send / reference-recv pair (no return path). The
        sample ``t_tx - t_rx = offset - delay`` lower-bounds the offset."""
        self._push(key, t_tx - t_rx, 0, "one-way")

    def _push(self, key: str, offset: int, delay: int, kind: str) -> None:
        dq = self._samples.get(key)
        if dq is None:
            dq = self._samples[key] = deque(maxlen=self.window)
        dq.append(_Sample(self.clock(), offset, delay, kind))
        self.n_samples += 1

    # -------------------------------------------------------------- estimate
    def estimate(self, key: str) -> ClockEstimate | None:
        dq = self._samples.get(key)
        if not dq:
            return None
        now = self.clock()
        rtts = [s for s in dq if s.kind == "rtt"]
        if rtts:
            # NTP clock filter: the minimum-delay sample saw the least
            # queueing, so its delay/2 bound is the tightest available.
            best = min(rtts, key=lambda s: s.delay_ns)
            offsets = [s.offset_ns for s in rtts]
            # Jitter term: the window's own spread catches a clock that
            # stepped between samples, which the single best sample can't.
            jitter = (max(offsets) - min(offsets)) // 2
            age_s = max(0.0, (now - best.t_local_ns) / 1e9)
            unc = (
                best.delay_ns // 2
                + jitter
                + int(DRIFT_PPM * 1e3 * age_s)
                + MIN_UNCERTAINTY_NS
            )
            return ClockEstimate(
                offset_ns=best.offset_ns,
                uncertainty_ns=unc,
                n_samples=len(rtts),
                kind="rtt",
                age_s=age_s,
            )
        # One-way only: every sample under-estimates by its (unknown) delay,
        # so take the max (minimum-delay frame) and report a wide bound —
        # the spread plus a floor, because the residual delay is unbounded
        # from this side.
        best = max(dq, key=lambda s: s.offset_ns)
        offsets = [s.offset_ns for s in dq]
        age_s = max(0.0, (now - best.t_local_ns) / 1e9)
        unc = (
            (max(offsets) - min(offsets))
            + int(DRIFT_PPM * 1e3 * age_s)
            + ONE_WAY_FLOOR_NS
        )
        return ClockEstimate(
            offset_ns=best.offset_ns,
            uncertainty_ns=unc,
            n_samples=len(dq),
            kind="one-way",
            age_s=age_s,
        )

    def snapshot(self) -> dict[str, dict]:
        """JSON-ready map of every source's current estimate — embedded into
        the storage trace dump's ``meta.clock`` for the merger."""
        out = {}
        for key in self._samples:
            est = self.estimate(key)
            if est is None:
                continue
            out[key] = {
                "offset_ns": est.offset_ns,
                "uncertainty_ns": est.uncertainty_ns,
                "n_samples": est.n_samples,
                "kind": est.kind,
                "age_s": round(est.age_s, 3),
            }
        return out
