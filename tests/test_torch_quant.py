"""Serving precision (``tpu_rl_torch.models.quant``) against
``tpu_rl.models.quant`` on the CPU, on bridged parameters: ``quantize_tree``
code for code (``q8`` equal, ``scale`` and the bf16 leaves bit for bit,
after the bridge carries ``tpu_rl``'s quantized tree across),
``dequantize_tree`` (exact: both widen the same numbers), idempotence,
``quant_spec`` through the bridge's names, ``tree_bytes``, and the policy
bar of ``tests/test_quant.py:140-157`` on its margin-scaled head (argmax
agreement >= 99%, mean log-prob drift <= 0.05 bf16 / 0.08 int8)."""

import jax
import numpy as np
import pytest
import torch

from tests.conftest import small_config
from tests.test_torch_bridge import with_random_biases
from tpu_rl.models import quant as JQ
from tpu_rl.models.families import build_family as jax_build_family
from tpu_rl_torch.bridge import flax_to_state_dict
from tpu_rl_torch.config import Config
from tpu_rl_torch.models.families import build_family
from tpu_rl_torch.models.quant import (
    QUANT_MODES,
    dequantize_tree,
    is_q8_leaf,
    quant_spec,
    quantize_tree,
    tree_bytes,
)

CONFIGS = {
    "PPO": dict(hidden_size=32),
    "PPO-Continuous": dict(algo="PPO-Continuous", is_continuous=True, hidden_size=32,
                           obs_shape=(3,), action_space=1),
    "SAC-Continuous": dict(algo="SAC-Continuous", is_continuous=True, hidden_size=32,
                           obs_shape=(2,), action_space=1),
}


def _actor(name="PPO", seed=0):
    """tpu_rl's actor tree (numpy leaves, perturbed biases) and the port's
    state_dict of it."""
    jcfg = small_config(**CONFIGS[name])
    params = jax_build_family(jcfg).init_params(jax.random.key(seed), seq_len=jcfg.seq_len)
    tree = with_random_biases(jax.tree_util.tree_map(np.asarray, params["actor"]), seed + 1)
    return tree, flax_to_state_dict(tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=is_q8_leaf)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("mode", QUANT_MODES)
def test_quantize_matches_tpu_rl_code_for_code(name, mode):
    """The port's quantized state_dict against tpu_rl's quantized tree
    carried across the bridge: int8 codes equal (0 codes off by one), the
    scales and the bf16 leaves bit for bit, the same leaves quantized."""
    tree, sd = _actor(name)
    want = flax_to_state_dict(jax.device_get(JQ.quantize_tree(tree, mode)))
    got = quantize_tree(sd, mode)
    assert set(got) == set(want)
    off = 0
    for k, w in want.items():
        g = got[k]
        assert is_q8_leaf(g) == is_q8_leaf(w), k
        if is_q8_leaf(w):
            assert g["q8"].dtype == w["q8"].dtype == torch.int8, k
            off += int((g["q8"].int() - w["q8"].int()).abs().gt(0).sum())
            assert int((g["q8"].int() - w["q8"].int()).abs().max()) <= 1, k
            assert torch.equal(g["scale"], w["scale"]) and g["scale"].dtype == torch.float32, k
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), k
    assert off == 0, f"{off} int8 codes off by one"


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_dequantize_matches_tpu_rl(mode):
    """The widened tree equals tpu_rl's widened tree bit for bit, f32, and
    int8 stays within half a code of the f32 weights."""
    tree, sd = _actor()
    want = flax_to_state_dict(jax.device_get(JQ.dequantize_tree(JQ.quantize_tree(tree, mode))))
    got = dequantize_tree(quantize_tree(sd, mode))
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], w), k
        if mode == "int8" and sd[k].dim() >= 2:
            bound = max(float(sd[k].abs().max()) / 254.0, 1e-7)
            assert float((got[k] - sd[k]).abs().max()) <= bound + 1e-7, k


def test_quantize_is_idempotent_and_keeps_biases_f32():
    _tree, sd = _actor()
    for mode in QUANT_MODES:
        once = quantize_tree(sd, mode)
        twice = quantize_tree(once, mode)
        for a, b in zip(_leaves(once), _leaves(twice), strict=True):
            if is_q8_leaf(a):
                assert torch.equal(a["q8"], b["q8"]) and torch.equal(a["scale"], b["scale"])
            else:
                assert torch.equal(a, b)
    q = quantize_tree({"actor": sd}, "int8")["actor"]
    n_q8 = sum(is_q8_leaf(v) for v in q.values())
    assert n_q8 == 5  # body, x_proj, recurrent, logits, value
    for k, v in q.items():
        if not is_q8_leaf(v):
            assert v.dim() < 2 and v.dtype == torch.float32, k
    for v in quantize_tree(sd, "bf16").values():
        assert v.dtype == torch.bfloat16
    assert quantize_tree(sd, "f32") is sd


def test_quant_spec_names_the_port_paths_as_the_bridge_maps_tpu_rl():
    """quant_spec in the port's names and layouts; tpu_rl's spec mapped
    through the bridge's names (``kernel`` (in, out) -> ``weight`` (out, in))
    is the same map."""
    tree, sd = _actor()
    for mode in QUANT_MODES:
        got = quant_spec(quantize_tree({"actor": sd}, mode))
        want = {}
        for path, (dtype, shape) in JQ.quant_spec({"actor": JQ.quantize_tree(tree, mode)}).items():
            parts = path.split(".")
            assert parts[1] == "params", path
            name = ".".join([parts[0], *parts[2:]])
            if name.endswith(".kernel"):
                name, shape = name[: -len("kernel")] + "weight", shape[::-1]
            want[name] = (dtype, shape)
        assert got == want, mode
    assert quant_spec({"blocks": {"0": {"w": torch.zeros(2, 3)}}}) == {"blocks.*.w": ("float32", (2, 3))}


def test_tree_bytes_matches_tpu_rl_and_shrinks_with_the_mode():
    tree, sd = _actor()
    got = [tree_bytes(quantize_tree(sd, m)) for m in QUANT_MODES]
    want = [JQ.tree_bytes(JQ.quantize_tree(tree, m)) for m in QUANT_MODES]
    assert got == want
    assert got[2] < got[1] < got[0]


def _margin_actor(fam, scale=4.0, seed=0):
    """tests/test_quant.py's ``_margin_params``: the port's init with the
    logits head scaled, so the policy has a trained one's decisive margins."""
    actor = fam.init_params(torch.Generator().manual_seed(seed))["actor"]
    actor["logits.weight"] = actor["logits.weight"] * scale
    return actor


def test_policy_parity_at_trained_margins():
    """bf16 and int8 served policies against f32 under shared Gumbel noise:
    argmax agreement >= 99% of 512 rows, mean |log-prob drift| <= 0.05
    (bf16) and 0.08 (int8); tpu_rl's bars (tests/test_quant.py:140-157)."""
    fam = build_family(Config(hidden_size=32), device="cpu")
    actor = _margin_actor(fam)
    rng = np.random.default_rng(7)
    obs = torch.from_numpy(rng.standard_normal((512, 4)).astype(np.float32))
    gumbel = torch.from_numpy(rng.gumbel(size=(512, 2)).astype(np.float32))
    zeros = torch.zeros((512, 32))

    def act(mode):
        served = dequantize_tree(quantize_tree({"actor": actor}, mode))
        return fam.act(served, obs, zeros, zeros, gumbel=gumbel)

    a32, lg32, lp32, _h, _c = act("f32")
    for mode, bar in (("bf16", 0.05), ("int8", 0.08)):
        a, lg, lp, _h, _c = act(mode)
        agree = float((lg.argmax(-1) == lg32.argmax(-1)).float().mean())
        assert agree >= 0.99, (mode, agree)
        drift = float((lp - lp32).abs().mean())
        assert drift <= bar, (mode, drift)
        assert float((a == a32).float().mean()) >= 0.99, mode
