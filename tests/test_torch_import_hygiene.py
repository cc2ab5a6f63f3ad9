"""The PyTorch port imports only torch: importing every ``tpu_rl_torch``
module must load no ``jax``, ``flax`` or ``tpu_rl`` module, and its entry
points must refuse to run without CUDA unless asked for the CPU. The import
check runs in a subprocess because this test process already imported jax
(conftest)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tpu_rl_torch
from tpu_rl_torch.algos.registry import get_algo
from tpu_rl_torch.config import Config
from tpu_rl_torch.models.families import build_family
from tpu_rl_torch.runtime.colocated import ColocatedLoop
from tpu_rl_torch.runtime.inference_service import InferenceService
from tpu_rl_torch.runtime.local_router import LocalRouter

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import tpu_rl_torch
names = sorted(m.name for m in pkgutil.walk_packages(tpu_rl_torch.__path__, "tpu_rl_torch."))
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "tpu_rl"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_tpu_rl():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["bad"] == [], doc["bad"]
    # every module of the slice was really imported
    for name in (
        "tpu_rl_torch.config", "tpu_rl_torch.bridge", "tpu_rl_torch.utils.timer",
        "tpu_rl_torch.ops.distributions", "tpu_rl_torch.ops.fused_act",
        "tpu_rl_torch.models.cells", "tpu_rl_torch.models.policies",
        "tpu_rl_torch.models.families", "tpu_rl_torch.models.quant",
        "tpu_rl_torch.kernels.build", "tpu_rl_torch.runtime.protocol",
        "tpu_rl_torch.runtime.local_router", "tpu_rl_torch.runtime.inference_service",
        "tpu_rl_torch.types", "tpu_rl_torch.ops.lstm", "tpu_rl_torch.ops.returns",
        "tpu_rl_torch.ops.losses", "tpu_rl_torch.heal.guards", "tpu_rl_torch.obs.learn",
        "tpu_rl_torch.algos.base", "tpu_rl_torch.algos.ppo", "tpu_rl_torch.algos.registry",
        "tpu_rl_torch.envs", "tpu_rl_torch.envs.core", "tpu_rl_torch.envs.cartpole",
        "tpu_rl_torch.runtime.colocated", "tpu_rl_torch.ops.attention",
        "tpu_rl_torch.parallel", "tpu_rl_torch.parallel.sequence",
        "tpu_rl_torch.models.transformer",
    ):
        assert name in doc["imported"], name


def _needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-CUDA refusal cannot be observed")


def test_entry_points_refuse_to_run_on_cpu_unasked():
    _needs_no_cuda()
    cfg = Config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_family(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpu_rl_torch.resolve_device()
    family = build_family(cfg, device="cpu")
    params = family.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceService(cfg, family, params, LocalRouter())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_algo("PPO").build(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ColocatedLoop(Config(env_mode="colocated", hidden_size=16))


def test_config_keeps_unknown_keys_and_refuses_later_slices():
    cfg = Config.from_dict(
        {"hidden_size": 32, "obs_shape": [6], "chaos_spec": None, "lr": 3e-4, "mesh_seq": 2}
    )
    assert cfg.obs_shape == (6,) and cfg.hidden_size == 32 and cfg.lr == 3e-4
    assert cfg.extra == {"chaos_spec": None, "mesh_seq": 2}
    with pytest.raises(NotImplementedError, match="quantized-serving slice"):
        Config.from_dict({"inference_dtype": "bf16"})
    with pytest.raises(AssertionError):
        Config.from_dict({"act_kernel": "triton"})
    with pytest.raises(AssertionError):
        Config().replace(inference_buckets=-1)
    for kw, slice_name in (
        ({"algo": "SAC"}, "other-algorithms"),
        ({"model": "transformer", "attention_impl": "ring"}, "sequence-parallel slice"),
        ({"model": "transformer", "attention_impl": "ulysses"}, "sequence-parallel slice"),
        ({"model": "transformer", "attention_impl": "blockwise"}, "blockwise-attention slice"),
        # bf16 compute: the transformer takes it, the LSTM not yet
        ({"compute_dtype": "bfloat16"}, "bf16-compute slice"),
    ):
        with pytest.raises(NotImplementedError, match=slice_name):
            build_family(Config.from_dict(kw), device="cpu")


def test_config_loads_a_full_tpu_rl_params_file():
    """Every key of tpu_rl's Config loads: known ones as fields, the rest
    kept aside."""
    from tpu_rl.config import Config as JaxConfig

    raw = json.loads(json.dumps(JaxConfig(hidden_size=256, inference_batch=256).to_dict()))
    cfg = Config.from_dict(raw)
    assert cfg.hidden_size == 256 and cfg.inference_batch == 256
    assert cfg.obs_shape == (4,)
    assert "chaos_spec" in cfg.extra and "hidden_size" not in cfg.extra
