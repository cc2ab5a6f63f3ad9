"""Weight bridge: tpu_rl's flax actor tree -> the port's state_dict -> flax
tree is exact, and the state_dict loads into the port's module."""

import jax
import numpy as np
import pytest
import torch

from tests.conftest import small_config
from tpu_rl.models.families import build_family as jax_build_family
from tpu_rl_torch.bridge import flax_to_state_dict, state_dict_to_flax
from tpu_rl_torch.config import Config
from tpu_rl_torch.models.families import build_family


def with_random_biases(tree, seed):
    """``tree`` with every ``bias`` leaf replaced by seeded N(0, 0.1^2)
    values: flax (and the port) initialise biases to zero, and a trained
    policy's are not, so parity checks run on nonzero ones."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if getattr(path[-1], "key", None) != "bias":
            return leaf
        return leaf + (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _jax_actor_tree(hidden=32, obs=6, actions=3, seed=0):
    cfg = small_config(hidden_size=hidden, obs_shape=(obs,), action_space=actions)
    params = jax_build_family(cfg).init_params(jax.random.key(seed), seq_len=cfg.seq_len)
    return with_random_biases(jax.tree_util.tree_map(np.asarray, params["actor"]), seed + 1)


@pytest.mark.parametrize("hidden,obs,actions", [(32, 6, 3), (16, 4, 2)])
def test_roundtrip_is_exact(hidden, obs, actions):
    tree = _jax_actor_tree(hidden, obs, actions)
    back = state_dict_to_flax(flax_to_state_dict(tree))
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b, strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b)
    assert tree["params"]["cell"]["x_proj"]["bias"].any()


def test_layouts_and_module_load():
    tree = _jax_actor_tree(32, 6, 3)
    sd = flax_to_state_dict(tree)
    p = tree["params"]
    np.testing.assert_array_equal(sd["body.weight"].numpy(), p["body"]["kernel"].T)
    np.testing.assert_array_equal(sd["cell.x_proj.weight"].numpy(), p["cell"]["x_proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["cell.recurrent_kernel"].numpy(), p["cell"]["recurrent_kernel"])
    assert sd["cell.recurrent_kernel"].shape == (32, 128)
    assert sd["logits.weight"].shape == (3, 32) and sd["value.weight"].shape == (1, 32)
    cfg = Config.from_dict({"hidden_size": 32, "obs_shape": (6,), "action_space": 3})
    family = build_family(cfg, device="cpu")
    family.actor.load_state_dict(sd, strict=True)
    # and the port's own init produces exactly the same key set and shapes
    own = family.init_params(torch.Generator().manual_seed(0))["actor"]
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in sd.items()
    }


def test_port_init_matches_flax_statistics():
    """lecun_normal: truncated normal with variance 1/fan_in; zero biases."""
    cfg = Config.from_dict({"hidden_size": 256, "obs_shape": (64,), "action_space": 8})
    own = build_family(cfg, device="cpu").init_params(torch.Generator().manual_seed(3))["actor"]
    for key, fan_in in (("cell.x_proj.weight", 256), ("cell.recurrent_kernel", 256),
                        ("body.weight", 64)):
        w = own[key].numpy()
        assert abs(w.var() * fan_in - 1.0) < 0.05, (key, w.var() * fan_in)
        assert np.abs(w).max() <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6
    for key in ("body.bias", "cell.x_proj.bias", "logits.bias", "value.bias"):
        assert not own[key].any()


def _jax_transformer_tree(seed=0):
    cfg = small_config(model="transformer", hidden_size=32, n_heads=4, n_layers=2, seq_len=8,
                       obs_shape=(6,), action_space=3)
    params = jax_build_family(cfg).init_params(jax.random.key(seed), seq_len=cfg.seq_len)
    return with_random_biases(jax.tree_util.tree_map(np.asarray, params["actor"]), seed + 1)


def test_transformer_roundtrip_keeps_layer_norm_untransposed():
    """The transformer's tree (Dense and LayerNorm nodes) round-trips
    exactly; a LayerNorm scale becomes a 1-D ``.weight`` and comes back as
    ``scale``, not as a transposed ``kernel``; the state_dict loads into the
    port's module, whose own init has the same keys and shapes."""
    tree = _jax_transformer_tree()
    sd = flax_to_state_dict(tree)
    back = state_dict_to_flax(sd)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b, strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b)
    p = tree["params"]
    assert set(p["block1"]["ln2"]) == {"scale", "bias"}
    np.testing.assert_array_equal(sd["block1.ln2.weight"].numpy(), p["block1"]["ln2"]["scale"])
    np.testing.assert_array_equal(sd["ln_f.bias"].numpy(), p["ln_f"]["bias"])
    np.testing.assert_array_equal(
        sd["block0.attn.qkv.weight"].numpy(), p["block0"]["attn"]["qkv"]["kernel"].T
    )
    assert sd["block0.attn.qkv.weight"].shape == (96, 32) and sd["embed.weight"].shape == (32, 6)
    cfg = Config.from_dict({"model": "transformer", "hidden_size": 32, "n_heads": 4, "n_layers": 2,
                            "obs_shape": (6,), "action_space": 3})
    family = build_family(cfg, device="cpu")
    family.actor.load_state_dict(sd, strict=True)
    own = family.init_params(torch.Generator().manual_seed(0))["actor"]
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: tuple(v.shape) for k, v in sd.items()}
    assert (own["block0.ln1.weight"] == 1.0).all() and not own["ln_f.bias"].any()
    w = own["block1.ff1.weight"].numpy()
    assert abs(w.var() * 32 - 1.0) < 0.1  # lecun_normal over fan_in 32
