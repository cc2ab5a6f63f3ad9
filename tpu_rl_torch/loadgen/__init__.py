"""Synthetic load plane for the inference fleet — the port of
``tpu_rl.loadgen``.

Drives tens of thousands of lightweight synthetic clients — request replay
against the fleet's ObsRequest/Act channel, no env stepping, no tensor —
from a few driver processes, sweeps offered load, and grades the resulting
latency distributions through the SLO engine. The output is a saturation
curve (``loadgen.json``): offered vs achieved rate, success rate, round-trip
quantiles, and hedge/failover/dedup accounting per stage.

A "client" here is a (wid, seq) identity stamped on replayed requests, not
a socket: one DEALER lane per replica per driver process carries every
client's traffic. The driver mirrors
:class:`~tpu_rl_torch.fleet.client.FleetClient` semantics — power-of-two
lane choice, hedged retries, version-floor pinning — in open-loop form
(sends on a schedule, never waits for replies), so its numbers measure the
fleet, not a closed-loop client's self-throttling.
"""

from tpu_rl_torch.loadgen.driver import LoadDriver, normalize_schedule, probe_ready, run_loadgen

__all__ = ["LoadDriver", "normalize_schedule", "probe_ready", "run_loadgen"]
