"""Online anomaly detection over the history plane's channel stream.

The port's own copy of ``tpu_rl.obs.anomaly``, unchanged in behaviour.

One EWMA mean/variance tracker per channel, fed each exporter-cadence
row by :meth:`TimeSeriesStore.record`. Two trip conditions, both
published as labeled counters (``anomaly-spikes`` / ``anomaly-level-shifts``
with ``{"channel": name}``) so the SLO engine and autopilot can rule on
them (`counter:anomaly-spikes` — the SignalScraper sums across labels):

- **spike**: one sample beyond ``z_spike`` sigma. The sample is folded
  into the baseline *clamped* to the spike threshold so a single outlier
  cannot drag the mean toward itself and mask a follow-up.
- **level shift**: ``sustain`` consecutive samples beyond ``z_level``
  sigma on the same side, opened by a sigma-scale first-difference (a
  *step*). While the candidate streak runs the baseline is frozen —
  folding would chase the new level and dissolve the streak before
  sustain. On trip the baseline re-centers on the new level (one event
  per shift, not one per sample forever after).

Slow drift — per-sample deltas small against the tracked sigma — never
clears the streak-opening jump gate, so the EWMA mean keeps folding
along with the signal and neither condition trips (pinned by test). Counter-kind channels are skipped: a healthy counter
is monotone by construction and every increment would z-trip.
"""

from __future__ import annotations

import math

# EWMA horizon ~1/alpha samples: at the default 10s exporter cadence,
# alpha=0.05 tracks a ~3-minute baseline.
_ALPHA = 0.05
_WARMUP = 8  # samples before the variance estimate is trustworthy
_Z_SPIKE = 8.0
_Z_LEVEL = 3.0
_SUSTAIN = 5
# Floor on sigma relative to the mean's magnitude: a channel that sat
# bit-identical through warmup (constant gauge) has var=0 and any
# sub-ppm wobble would otherwise z-trip.
_REL_FLOOR = 1e-3

ANOMALY_SPIKES_METRIC = "anomaly-spikes"
ANOMALY_LEVEL_SHIFTS_METRIC = "anomaly-level-shifts"


class _Channel:
    __slots__ = ("mean", "var", "n", "streak", "prev")

    def __init__(self):
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.streak = 0  # signed run length of same-side z_level excursions
        self.prev = 0.0  # last raw sample (for the step-vs-ramp jump gate)


class AnomalyDetector:
    def __init__(
        self,
        alpha: float = _ALPHA,
        warmup: int = _WARMUP,
        z_spike: float = _Z_SPIKE,
        z_level: float = _Z_LEVEL,
        sustain: int = _SUSTAIN,
    ):
        assert 0 < alpha < 1 and warmup >= 2 and sustain >= 1
        assert z_spike > z_level > 0
        self.alpha = alpha
        self.warmup = warmup
        self.z_spike = z_spike
        self.z_level = z_level
        self.sustain = sustain
        self._channels: dict[str, _Channel] = {}
        self.spikes: dict[str, int] = {}
        self.level_shifts: dict[str, int] = {}

    def observe(
        self,
        samples: dict[str, float],
        kinds: dict[str, str],
        registry=None,
    ) -> list[tuple[str, str]]:
        """Feed one row; returns [(channel, "spike"|"level-shift"), ...]
        for the events this row tripped. With ``registry``, publishes the
        running totals as labeled counters."""
        events: list[tuple[str, str]] = []
        for ch, value in samples.items():
            if kinds.get(ch) == "counter":
                continue
            ev = self._observe_one(ch, float(value))
            if ev is not None:
                events.append((ch, ev))
        if registry is not None:
            for ch, n in self.spikes.items():
                registry.counter(
                    ANOMALY_SPIKES_METRIC, {"channel": ch}
                ).set_total(n)
            for ch, n in self.level_shifts.items():
                registry.counter(
                    ANOMALY_LEVEL_SHIFTS_METRIC, {"channel": ch}
                ).set_total(n)
        return events

    def _observe_one(self, ch: str, x: float) -> str | None:
        st = self._channels.get(ch)
        if st is None:
            st = self._channels[ch] = _Channel()
        if st.n == 0:
            st.mean = x
            st.prev = x
        st.n += 1
        if st.n <= self.warmup:
            self._fold(st, x)
            st.prev = x
            return None
        sigma = max(math.sqrt(st.var), _REL_FLOOR * abs(st.mean), 1e-12)
        z = (x - st.mean) / sigma
        jump = abs(x - st.prev) / sigma
        st.prev = x
        if abs(z) >= self.z_spike:
            self.spikes[ch] = self.spikes.get(ch, 0) + 1
            # fold clamped: the baseline absorbs at most z_spike sigma
            self._fold(st, st.mean + math.copysign(self.z_spike * sigma, z))
            st.streak = 0
            return "spike"
        if abs(z) >= self.z_level:
            side = 1 if z > 0 else -1
            if st.streak * side > 0:
                st.streak += side
            elif jump >= self.z_level:
                # A step, not a ramp: only a sigma-scale first-difference
                # opens a candidate shift. A slow drift reaches z_level
                # through sub-sigma increments and keeps folding below.
                st.streak = side
            else:
                st.streak = 0
                self._fold(st, x)
                return None
            if abs(st.streak) >= self.sustain:
                self.level_shifts[ch] = self.level_shifts.get(ch, 0) + 1
                # re-center on the new level; variance restarts its EWMA
                st.mean = x
                st.streak = 0
                return "level-shift"
            # Baseline frozen while the candidate shift accumulates
            # evidence: folding here would chase the new level and
            # dissolve the streak before sustain is ever reached.
            return None
        st.streak = 0
        self._fold(st, x)
        return None

    def _fold(self, st: _Channel, x: float) -> None:
        d = x - st.mean
        st.mean += self.alpha * d
        st.var = (1.0 - self.alpha) * (st.var + self.alpha * d * d)
