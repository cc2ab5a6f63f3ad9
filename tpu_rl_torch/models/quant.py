"""Act-step dispatch — the port of ``tpu_rl.models.quant.make_act_fn``.

(Only the dispatch so far: bf16/int8 serving params come with a later slice
of the port, and ``Config.validate`` refuses them until then.)
"""

from __future__ import annotations


def make_act_fn(cfg, family):
    """Resolve ``Config.act_kernel`` to the act callable serving consumers
    run. ``"xla"`` -> ``family.act`` (the unfused module forward);
    ``"pallas"`` -> the fused act kernel (:mod:`tpu_rl_torch.ops.fused_act`),
    which raises for a family out of its scope. The name ``"pallas"`` is
    kept so ``tpu_rl`` params files load."""
    if cfg.act_kernel != "pallas":
        return family.act
    from tpu_rl_torch.ops.fused_act import make_fused_act

    return make_fused_act(family)
