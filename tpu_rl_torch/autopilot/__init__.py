"""Fleet autopilot: closed-loop autoscaling from the fleet's own health
signals (SLO burn rates, goodput ratios, straggler scores) — the port of
``tpu_rl.autopilot``.

Three parts, mirroring every control plane in the repo:

- :mod:`tpu_rl_torch.autopilot.signals` — scrape the existing read-only HTTP
  endpoints (``/slo``, ``/goodput``, ``/metrics``) into a windowed
  signal store; zero new member-side protocol;
- :mod:`tpu_rl_torch.autopilot.policy` — the declarative rule grammar
  (``Config.autopilot_spec``) and the deterministic decision engine
  with sustain/cooldown/hysteresis/bounds/rate-limit anti-flap
  guarantees;
- :mod:`tpu_rl_torch.autopilot.controller` — the actuator: spawn/retire
  ``inference-<i>`` replicas and workers through the real
  :class:`~tpu_rl_torch.runtime.runner.Supervisor` inside the portplan's
  pre-planned port range, audit every decision to
  ``result_dir/autopilot.jsonl``.
"""

from tpu_rl_torch.autopilot.controller import AutopilotController, ReplicaSet
from tpu_rl_torch.autopilot.policy import AutopilotSpec, DecisionEngine, Rule
from tpu_rl_torch.autopilot.signals import SignalScraper, SignalStore

__all__ = [
    "AutopilotController",
    "AutopilotSpec",
    "DecisionEngine",
    "ReplicaSet",
    "Rule",
    "SignalScraper",
    "SignalStore",
]
