"""IMPALA and V-MPO on the transformer family in the port against ``tpu_rl``
on the CPU, with each attention impl (``"full"``; ``"blockwise"`` at 6-row
tiles in both packages, so the 16 steps span three tiles and a padded one;
``"flash"``, which is ``full_attention`` in ``tpu_rl`` off the TPU and B4's
plain versions in the port): one whole train step from one bridged state
(after a JAX warm-up step, so RMSprop nu is nonzero) on one batch with
seams, at K_epoch 1 and 2. V-MPO's per-epoch KL-bound draws are
``tpu_rl``'s, handed over (``coef_alpha_u``). Tolerances as for the LSTM
steps (``tests/test_torch_ppo.py``): loss rtol 1e-5; params, the duals and
RMSprop nu 1e-5; every other metric 1e-5, relative above magnitude 1 (as
``chip_smoke.REF_TOL`` holds metrics): the transformer's IMPALA diag row
``w2`` reaches ~30, where 1e-5 absolute is five f32 ulps of a sum."""

import jax
import numpy as np
import pytest

from tests.conftest import small_config
from tests.test_torch_ppo import _assert_metrics_close, _assert_states_close
from tests.test_torch_transformer import TF, _batch_np, perturbed, small_blocks
from tests.test_torch_vmpo import KEY, _draws
from tpu_rl.algos.registry import get_algo as jax_get_algo
from tpu_rl.types import Batch as JaxBatch
from tpu_rl_torch.algos.registry import get_algo
from tpu_rl_torch.bridge import train_state_from_flax
from tpu_rl_torch.config import Config
from tpu_rl_torch.types import Batch


@pytest.mark.parametrize("k_epoch", [1, 2])
@pytest.mark.parametrize("impl", ["full", "blockwise", "flash"])
@pytest.mark.parametrize("algo", ["IMPALA", "V-MPO"])
def test_train_step_matches_tpu_rl(algo, impl, k_epoch, monkeypatch):
    small_blocks(monkeypatch)
    kw = dict(algo=algo, attention_impl=impl, K_epoch=k_epoch, learn_diag=True,
              update_guard=True)
    jcfg = small_config(**{**TF, **kw})
    _fam, jstate, jstep = jax_get_algo(algo).build(jcfg, jax.random.key(0))
    jstate = jstate.replace(params={**jstate.params,
                                    "actor": perturbed(jstate.params["actor"], 3)})
    jstep = jax.jit(jstep)
    jstate, _ = jstep(jstate, JaxBatch.from_mapping(_batch_np(8, 16, 20)), jax.random.key(1))
    jstate = jax.device_get(jstate)
    batch_np = _batch_np(8, 16, 21)
    jnew, jmetrics = jstep(jstate, JaxBatch.from_mapping(batch_np), jax.random.key(KEY))

    cfg = Config.from_dict({**TF, **kw, "buffer_size": 32, "time_horizon": 32})
    family, _s, step = get_algo(algo).build(cfg, device="cpu")
    assert family.store_carry is False and cfg.model == "transformer"
    state = train_state_from_flax(jstate)
    batch = Batch.from_mapping(batch_np, device="cpu")
    noise = {"coef_alpha_u": _draws(k_epoch)} if algo == "V-MPO" else {}
    new, metrics = step(state, batch, **noise)
    _assert_metrics_close(metrics, jax.device_get(jmetrics), relative_above_one=True)
    _assert_states_close(new, jax.device_get(jnew))
    assert float(metrics["nonfinite-updates"]) == 0.0
    if algo == "V-MPO":
        assert set(new.params["duals"]) == {"log_eta", "log_alpha"}
    assert np.isfinite(float(metrics["loss"]))
