"""Population plane: PBT over K member runs — the port of
``tpu_rl.population``.

A :class:`PopulationController` launches K hyperparameter variants as
supervised member processes (one colocated loop each, or the Sebulba split,
or a whole nested fleet a member), scrapes their telemetry exporters for
fitness, and runs seeded truncation-selection PBT: losers stop, adopt the
winner's newest COMMITTED checkpoint (two-phase copy,
``checkpoint.copy_committed``) and hyperparameters, mutate, and resume at a
bumped run epoch. Everything is reproducible from ``(pop_spec, pop_seed)``;
every event is audited to ``result_dir/population.jsonl`` and the final
leaderboard and lineage land crash-atomically in ``population.json``. The
controller opens no CUDA context; each member opens its own.
"""

from tpu_rl_torch.population.controller import PopulationController, population_doc
from tpu_rl_torch.population.spec import (
    PopSpec,
    SampleDim,
    fold_in,
    member_seed,
    mutate,
    sample_member,
    truncation_select,
)

__all__ = [
    "PopSpec",
    "PopulationController",
    "SampleDim",
    "fold_in",
    "member_seed",
    "mutate",
    "population_doc",
    "sample_member",
    "truncation_select",
]
