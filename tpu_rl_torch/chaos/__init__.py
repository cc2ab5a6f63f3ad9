"""Deterministic fault injection for the actor-learner fleet — the port of
``tpu_rl.chaos``.

See ``tpu_rl_torch.chaos.plan`` for the fault-plan grammar. The subsystem is
entirely off-path unless ``Config.chaos_spec`` is set.
"""

from tpu_rl_torch.chaos.inject import (
    DataChaos,
    ServiceChaos,
    TransportChaos,
    maybe_data_chaos,
    maybe_service_chaos,
    maybe_transport_chaos,
    site_seed,
)
from tpu_rl_torch.chaos.plan import Fault, FaultPlan
from tpu_rl_torch.chaos.process import ProcessChaos

__all__ = [
    "DataChaos",
    "Fault",
    "FaultPlan",
    "ProcessChaos",
    "ServiceChaos",
    "TransportChaos",
    "maybe_data_chaos",
    "maybe_service_chaos",
    "maybe_transport_chaos",
    "site_seed",
]
