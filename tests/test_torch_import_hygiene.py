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
gym = sorted(m for m in sys.modules if m.split(".")[0] == "gymnasium")
print(json.dumps({"imported": names, "bad": bad, "gymnasium": gym}))
"""


def test_port_imports_no_jax_and_no_tpu_rl():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["bad"] == [], doc["bad"]
    # the env adapter and the inline trainer import gymnasium only when run
    assert doc["gymnasium"] == [], doc["gymnasium"]
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
        *(f"tpu_rl_torch.parallel.{m}" for m in ("mesh", "dp", "multihost")),
        "tpu_rl_torch.models.transformer", "tpu_rl_torch.checkpoint",
        *(f"tpu_rl_torch.obs.{m}" for m in (
            "registry", "aggregator", "goodput", "audit", "flightrec", "perf", "learn",
            "exporters", "slo", "anomaly", "history")),
        "tpu_rl_torch.utils.metrics",
        "tpu_rl_torch.runtime.env", "tpu_rl_torch.examples.train_inline",
        *(f"tpu_rl_torch.data.{m}" for m in ("layout", "assembler", "shm_ring", "prefetch")),
        "tpu_rl_torch.obs.report", "tpu_rl_torch.obs.compare",
        *(f"tpu_rl_torch.runtime.{m}" for m in (
            "zmtp", "transport", "native", "mailbox", "portplan", "manager", "storage",
            "worker", "learner_service", "runner")),
        "tpu_rl_torch.heal.ingress", "tpu_rl_torch.heal.watchdog",
        *(f"tpu_rl_torch.obs.{m}" for m in ("trace", "clocksync", "merge")),
        "tpu_rl_torch.utils.errlog", "tpu_rl_torch.utils.platform", "tpu_rl_torch.__main__",
        *(f"tpu_rl_torch.fleet.{m}" for m in ("client", "membership", "replica")),
        "tpu_rl_torch.fleet", "tpu_rl_torch.loadgen", "tpu_rl_torch.loadgen.driver",
        "tpu_rl_torch.examples.loadgen_smoke",
        "tpu_rl_torch.runtime.sebulba", "tpu_rl_torch.launch", "tpu_rl_torch.population",
        *(f"tpu_rl_torch.population.{m}" for m in ("spec", "member", "controller")),
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
        {"hidden_size": 32, "obs_shape": [6], "chaos_spec": None, "lr": 3e-4,
         "worker_step_sleep": 0.05, "mesh_seq": 1, "sebulba_queue": 2, "chaos_seed": 3}
    )
    assert cfg.obs_shape == (6,) and cfg.hidden_size == 32 and cfg.lr == 3e-4
    # the distributed runtime's keys are fields since its slice, the mesh
    # keys since the multi-GPU slice, the split's since the topology slice
    assert cfg.worker_step_sleep == 0.05 and cfg.mesh_seq == 1 and cfg.sebulba_queue == 2
    assert cfg.extra == {"chaos_spec": None, "chaos_seed": 3}
    # bf16/int8 serving and the checkpoint directory load now
    for mode in ("bf16", "int8"):
        assert Config.from_dict({"inference_dtype": mode}).inference_dtype == mode
    assert Config.from_dict({"model_dir": "/tmp/ckpt"}).model_dir == "/tmp/ckpt"
    with pytest.raises(AssertionError):
        Config.from_dict({"act_kernel": "triton"})
    with pytest.raises(AssertionError):
        Config().replace(inference_buckets=-1)
    # SAC builds now; in colocated mode (no replay) it is refused as in tpu_rl
    with pytest.raises(AssertionError, match="on-policy only"):
        Config.from_dict({"algo": "SAC", "env_mode": "colocated"})
    # ring and Ulysses build since the multi-GPU slice (full attention
    # outside a sequence-parallel mesh, as in tpu_rl)
    for impl in ("ring", "ulysses"):
        fam = build_family(Config.from_dict({"model": "transformer", "attention_impl": impl}),
                           device="cpu")
        assert fam.actor.block0.attn.attention_impl == impl
    # blockwise attention builds now
    fam = build_family(Config.from_dict({"model": "transformer", "attention_impl": "blockwise"}),
                       device="cpu")
    assert fam.actor.block0.attn.attention_impl == "blockwise"
    # bf16 compute: the LSTM takes it too now; with the fused act kernel,
    # which computes in f32 only, it is refused
    assert build_family(Config.from_dict({"compute_dtype": "bfloat16"}), device="cpu").actor.dtype \
        == torch.bfloat16
    with pytest.raises(NotImplementedError, match="f32 only"):
        Config.from_dict({"compute_dtype": "bfloat16", "act_kernel": "pallas"})


@pytest.mark.parametrize("key,value,slice_name", [
    ("autopilot_spec", "scale_out:replicas?burn:x>0.5", "serving and operations slice"),
    ("chaos_spec", "nan:rollout@p=0.4", "serving and operations slice"),
])
def test_config_refuses_keys_the_port_would_drop(key, value, slice_name):
    """A key that makes tpu_rl run its autopilot or arm chaos is refused
    away from its default, naming the slice that brings it; at its default
    (or absent) it loads. (The split, refused here until it was ported,
    is a field now: tests/test_torch_sebulba.py.)"""
    with pytest.raises(NotImplementedError, match=slice_name):
        Config.from_dict({key: value})
    assert Config.from_dict({key: None}).extra == {key: None}


@pytest.mark.parametrize("key,value", [("inference_replicas", 3), ("inference_mesh_data", 2)])
def test_config_loads_the_fleet_keys_as_fields(key, value):
    """The inference fleet's keys are fields with tpu_rl's defaults."""
    from tpu_rl.config import Config as JaxConfig

    assert getattr(Config(), key) == getattr(JaxConfig(), key) == 1
    cfg = Config.from_dict({key: value})
    assert getattr(cfg, key) == value and cfg.extra == {}
    assert getattr(JaxConfig.from_dict({key: value}), key) == value


# tpu_rl's fleet asserts (config.py:752-785) on inputs that break each
@pytest.mark.parametrize("raw", [
    {"inference_replicas": 0},
    {"inference_mesh_data": 0},
    {"inference_replicas": 2, "inference_base_port": 65535},
    {"inference_replicas": 3, "inference_base_port": 31010, "telemetry_port": 31012},
], ids=["replicas0", "mesh_data0", "ports-past-65535", "range-hits-telemetry"])
def test_fleet_asserts_match_tpu_rl(raw):
    from tpu_rl.config import Config as JaxConfig

    with pytest.raises(AssertionError):
        JaxConfig.from_dict(raw)
    with pytest.raises(AssertionError):
        Config.from_dict(raw)


@pytest.mark.parametrize("key,value", [
    ("mesh_data", 2), ("mesh_seq", 1),
    ("multihost", {"coordinator": "127.0.0.1:1234", "num_processes": 2, "process_id": 0}),
])
def test_config_loads_the_mesh_keys_as_fields(key, value):
    """The multi-GPU slice's keys are fields with tpu_rl's defaults."""
    from tpu_rl.config import Config as JaxConfig

    assert getattr(Config(), key) == getattr(JaxConfig(), key)
    cfg = Config.from_dict({key: value})
    assert getattr(cfg, key) == value and cfg.extra == {}


# tpu_rl's mesh asserts (config.py:685, 716-727, 882-895, 940-950) on inputs
# that break each; the port refuses each with the same exception type
_TF = {"model": "transformer", "seq_len": 8, "n_heads": 4}
_HOST = {"coordinator": "127.0.0.1:1", "num_processes": 3, "process_id": 0}


@pytest.mark.parametrize("raw", [
    {"mesh_data": 0},
    {"mesh_seq": 2},
    {**_TF, "mesh_seq": 2, "attention_impl": "full"},
    {**_TF, "mesh_seq": 3, "attention_impl": "ring"},
    {**_TF, "n_heads": 3, "hidden_size": 63, "mesh_seq": 2, "attention_impl": "ulysses"},
    {**_TF, "mesh_seq": 2, "attention_impl": "ring", "learner_chain": 2},
    {"multihost": _HOST, "learner_chain": 2},
    {"env_mode": "colocated", "colocated_envs": 8, "multihost": _HOST},
], ids=["mesh_data0", "mesh_seq-lstm", "mesh_seq-full", "mesh_seq-divides-seq_len",
        "ulysses-heads", "chain-mesh_seq", "chain-multihost", "colocated-envs-per-host"])
def test_mesh_asserts_match_tpu_rl(raw):
    from tpu_rl.config import Config as JaxConfig

    with pytest.raises(AssertionError):
        JaxConfig.from_dict(raw)
    with pytest.raises(AssertionError):
        Config.from_dict(raw)


def test_mesh_configs_tpu_rl_accepts_load():
    from tpu_rl.config import Config as JaxConfig

    for raw in ({**_TF, "mesh_data": 2, "mesh_seq": 2, "attention_impl": "ring"},
                {**_TF, "mesh_seq": 4, "attention_impl": "ulysses"},
                {"env_mode": "colocated", "colocated_envs": 9, "multihost": _HOST}):
        JaxConfig.from_dict(raw)
        cfg = Config.from_dict(raw)
        assert all(getattr(cfg, k) == v for k, v in raw.items())


@pytest.mark.parametrize("key", ["telemetry_port", "result_dir"])
def test_config_loads_telemetry_keys_and_builds_the_plane(key, tmp_path):
    """telemetry_port and result_dir are fields now (they were refused
    until the telemetry plane came): each one alone turns the plane on, and
    a colocated loop built with it has its registry; absent, nothing is
    built."""
    from tests.test_torch_colocated import free_port

    value = free_port() if key == "telemetry_port" else str(tmp_path)
    cfg = Config.from_dict({key: value, "env_mode": "colocated", "hidden_size": 16})
    assert getattr(cfg, key) == value and cfg.extra == {} and cfg.telemetry_enabled
    loop = ColocatedLoop(cfg, device="cpu")
    try:
        assert loop.aggregator is not None and loop._perf is not None
        assert (loop._http is not None) == (key == "telemetry_port")
        assert (loop._json_exp is not None) == (key == "result_dir")
    finally:
        loop.close()
    off = ColocatedLoop(Config.from_dict({"env_mode": "colocated", "hidden_size": 16}),
                        device="cpu")
    assert not off.cfg.telemetry_enabled and off.aggregator is None and off._perf is None


def test_config_example_files_load_or_refuse():
    """params.example.json and both long-context configs load: the
    single-chip one, and the (data 2, seq 4) ring-attention one since the
    multi-GPU slice."""
    root = Path(__file__).resolve().parent.parent / "configs"
    raw = json.loads((root / "params.example.json").read_text())
    assert Config.from_dict(raw).worker_step_sleep == raw["worker_step_sleep"] == 0.05
    raw = json.loads((root / "longcontext_singlechip.example.json").read_text())
    assert Config.from_dict(dict(raw, attention_impl="flash")).mesh_seq == 1
    raw = json.loads((root / "longcontext.example.json").read_text())
    cfg = Config.from_dict(raw)
    assert (cfg.mesh_data, cfg.mesh_seq, cfg.attention_impl) == (2, 4, "ring")


def test_config_loads_a_full_tpu_rl_params_file():
    """Every key of tpu_rl's Config loads: known ones as fields, the rest
    kept aside."""
    from tpu_rl.config import Config as JaxConfig

    raw = json.loads(json.dumps(JaxConfig(hidden_size=256, inference_batch=256).to_dict()))
    cfg = Config.from_dict(raw)
    assert cfg.hidden_size == 256 and cfg.inference_batch == 256
    assert cfg.obs_shape == (4,)
    assert "chaos_spec" in cfg.extra and "hidden_size" not in cfg.extra


# The reference's algorithm keys: (key, default, a value its assert refuses).
ALGO_KEYS = [
    ("alpha", 0.2, 0.0), ("tau", 0.005, 1.5), ("alpha_min", 0.0, -0.1), ("alpha_lr", None, 0.0),
    ("target_entropy", None, None), ("sac_reference_alpha", False, None), ("rho_bar", 0.8, 0.05),
    ("rho_min", 0.1, 0.0), ("c_bar", 1.0, 0.0), ("value_target_clip", None, [1.0, 1.0]),
    ("v_mpo_lagrange_multiplier_init", 5.0, None), ("coef_eta", 0.01, 0.0),
    ("coef_alpha_upper", 0.01, None), ("coef_alpha_below", 0.005, None), ("std_floor", 0.0, -1.0),
]


@pytest.mark.parametrize("key,default,bad", ALGO_KEYS, ids=[k[0] for k in ALGO_KEYS])
def test_algorithm_keys_load_with_the_reference_default_and_assert(key, default, bad):
    """Each algorithm key of tpu_rl's Config is a field of the port's, with
    tpu_rl's default (they used to fall into ``extra`` without a word), and
    the value tpu_rl's validate refuses is refused here too."""
    from tpu_rl.config import Config as JaxConfig

    assert getattr(Config(), key) == getattr(JaxConfig(), key) == default
    cfg = Config.from_dict({key: default})
    assert key not in cfg.extra and getattr(cfg, key) == default
    if bad is not None:
        with pytest.raises(AssertionError):
            JaxConfig.from_dict({key: bad})
        with pytest.raises(AssertionError):
            Config.from_dict({key: bad})


def test_algorithm_keys_parse_like_tpu_rl():
    """value_target_clip comes back a tuple; rho_bar 0.5 is a field, not a
    silent extra; SAC's two entropy rules conflict; a continuous env with a
    discrete algorithm is refused; off-policy algorithms are refused in
    colocated mode, as in tpu_rl."""
    from tpu_rl.config import Config as JaxConfig

    assert Config.from_dict({"value_target_clip": [0, 9.93]}).value_target_clip == (0, 9.93)
    cfg = Config.from_dict({"algo": "PPO", "rho_bar": 0.5})
    assert cfg.rho_bar == 0.5 and cfg.extra == {}
    for raw, err in (
        ({"sac_reference_alpha": True, "target_entropy": -1.0}, ValueError),
        ({"algo": "PPO", "is_continuous": True}, ValueError),
        ({"algo": "SAC-Continuous", "env_mode": "colocated"}, AssertionError),
    ):
        with pytest.raises(err):
            JaxConfig.from_dict(raw)
        with pytest.raises(err):
            Config.from_dict(raw)
    assert Config.from_dict({"algo": "V-MPO", "env_mode": "colocated"}).algo == "V-MPO"
