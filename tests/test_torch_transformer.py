"""The port's transformer family (``tpu_rl_torch.models.transformer`` and its
family in ``tpu_rl_torch.models.families``) against ``tpu_rl``'s on the CPU,
with ``tpu_rl``'s weights through the bridge (biases and LayerNorm scales
perturbed from their init) and the same numpy inputs:

- ``TransformerActorCritic.unroll`` logits and value, with both attention
  impls (``tpu_rl``'s "flash" takes ``full_attention`` off the TPU; the
  port's runs B4's plain versions): f32 at 1e-5, bf16 at the reference's own
  bf16 bar (rtol 0.05, atol 0.03, ``tests/test_transformer.py``);
- ``decode`` over several steps, with per-row counts that wrap the ring:
  logits, value and caches at 1e-5;
- ``family.act`` under shared Gumbel noise: equal actions, log-probs at
  1e-6, caches at 1e-5;
- one PPO train step and ``ColocatedLoop.program`` fed ``tpu_rl``'s rollout
  batch, at the tolerances of ``tests/test_torch_ppo.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from tests.conftest import small_config
from tests.test_torch_ppo import _assert_metrics_close, _assert_states_close
from tpu_rl.algos.registry import get_algo as jax_get_algo
from tpu_rl.config import Config as JaxConfig
from tpu_rl.models.families import build_family as jax_build_family
from tpu_rl.runtime.colocated import ColocatedLoop as JaxColocatedLoop
from tpu_rl.runtime.colocated import act_params as jax_act_params
from tpu_rl.types import BATCH_FIELDS
from tpu_rl.types import Batch as JaxBatch
from tpu_rl_torch.algos.registry import get_algo
from tpu_rl_torch.bridge import flax_to_state_dict, train_state_from_flax
from tpu_rl_torch.config import Config
from tpu_rl_torch.models.families import build_family
from tpu_rl_torch.runtime.colocated import ColocatedLoop
from tpu_rl_torch.types import Batch

ATOL = 1e-5
BF16_TOL = dict(rtol=0.05, atol=0.03)
TF = dict(model="transformer", hidden_size=32, n_heads=4, n_layers=2, seq_len=16,
          batch_size=8, obs_shape=(4,), action_space=2)


def perturbed(tree, seed):
    """``tree`` with seeded N(0, 0.1^2) added to every ``bias`` and
    ``scale`` leaf: the init makes biases 0 and LayerNorm scales 1."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if getattr(path[-1], "key", None) not in ("bias", "scale"):
            return leaf
        return leaf + (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _setup(**kw):
    jcfg = small_config(**{**TF, **kw})
    jfam = jax_build_family(jcfg)
    jparams = jfam.init_params(jax.random.key(0), seq_len=jcfg.seq_len)
    jparams = {"actor": perturbed(jax.tree_util.tree_map(np.asarray, jparams["actor"]), 1)}
    cfg = Config.from_dict({**TF, **kw})
    fam = build_family(cfg, device="cpu")
    return jcfg, jfam, jparams, cfg, fam, {"actor": flax_to_state_dict(jparams["actor"])}


def _firsts(B, S, rng):
    firsts = (rng.random((B, S, 1)) < 0.2).astype(np.float32)
    firsts[:, 0] = 1.0
    return firsts


def _close(got, want, what, **tol):
    tol = tol or dict(atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, dtype=np.float32), err_msg=what, **tol
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["full", "flash"])
def test_unroll_matches_tpu_rl(impl, dtype):
    jcfg, jfam, jparams, cfg, fam, params = _setup(attention_impl=impl, compute_dtype=dtype)
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(3, 16, 4)).astype(np.float32)
    firsts = _firsts(3, 16, rng)
    lw, vw, _ = jfam.actor_unroll(jparams["actor"], jnp.asarray(obs), None, jnp.asarray(firsts))
    logits, value, carry = fam.actor_unroll(
        params["actor"], torch.from_numpy(obs), None, torch.from_numpy(firsts)
    )
    assert carry is None and logits.dtype == value.dtype == torch.float32
    assert logits.shape == (3, 16, 2) and value.shape == (3, 16, 1)
    tol = {} if dtype == "float32" else BF16_TOL
    _close(logits, lw, "logits", **tol)
    _close(value, vw, "value", **tol)


def test_decode_matches_tpu_rl_over_steps():
    """Cached decode from random caches with per-row counts, some past the
    context (the ring wraps), over four steps."""
    jcfg, jfam, jparams, cfg, fam, params = _setup(act_ctx=6)
    rng = np.random.default_rng(3)
    B, L, ctx, H, D = 4, 2, 6, 4, 8
    kc, vc = (rng.normal(size=(B, L, ctx, H, D)).astype(np.float32) for _ in range(2))
    count = np.array([0, 2, 5, 9], np.int32)
    jk, jv, tk, tv = jnp.asarray(kc), jnp.asarray(vc), torch.from_numpy(kc), torch.from_numpy(vc)
    for step in range(4):
        obs = rng.normal(size=(B, 4)).astype(np.float32)
        lw, vw, jk, jv = jfam.actor.apply(
            jparams["actor"], jnp.asarray(obs), jk, jv, jnp.asarray(count + step), method="decode"
        )
        logits, value, tk, tv = functional_call(
            fam.actor, params["actor"],
            (torch.from_numpy(obs), (tk, tv, torch.from_numpy(count + step))),
        )
        for got, want, name in ((logits, lw, "logits"), (value, vw, "value"),
                                (tk, jk, "k caches"), (tv, jv, "v caches")):
            _close(got, want, f"step {step} {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_matches_tpu_rl_with_shared_gumbel(dtype):
    """family.act over an episode's first steps from zero caches, tpu_rl's
    Gumbel draws handed over: equal actions, log-probs at 1e-6 (f32), carries
    at 1e-5 (f32) or the bf16 bar."""
    jcfg, jfam, jparams, cfg, fam, params = _setup(act_ctx=8, compute_dtype=dtype)
    assert fam.carry_widths == tuple(jfam.carry_widths) == (2 * 8 * 32, 2 * 8 * 32 + 1)
    assert fam.store_carry is False
    rng = np.random.default_rng(4)
    B = 5
    jh, jc = jnp.zeros((B, fam.carry_widths[0])), jnp.zeros((B, fam.carry_widths[1]))
    h, c = torch.zeros(B, fam.carry_widths[0]), torch.zeros(B, fam.carry_widths[1])
    for step in range(5):
        obs = rng.normal(size=(B, 4)).astype(np.float32)
        key = jax.random.key(20 + step)
        a_w, l_w, lp_w, jh, jc = jfam.act(jparams, jnp.asarray(obs), jh, jc, key)
        gumbel = np.array(jax.random.gumbel(key, (B, 2), jnp.float32))
        a, logits, log_prob, h, c = fam.act(
            params, torch.from_numpy(obs), h, c, gumbel=torch.from_numpy(gumbel)
        )
        np.testing.assert_array_equal(a.numpy(), np.asarray(a_w))
        if dtype == "float32":
            _close(log_prob, lp_w, "log_prob", atol=1e-6, rtol=0)
            _close(h, jh, "K caches")
            _close(c, jc, "V caches and counter")
        else:
            _close(log_prob, lp_w, "log_prob", **BF16_TOL)
            _close(c, jc, "V caches and counter", **BF16_TOL)
    assert (c[:, -1] == 5.0).all()


def _batch_np(B, S, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, S, 2)).astype(np.float32)
    logits = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    act = rng.integers(0, 2, size=(B, S, 1)).astype(np.float32)
    log_prob = np.take_along_axis(logits, act.astype(np.int64), -1)
    log_prob = (log_prob + 0.1 * rng.normal(size=log_prob.shape)).astype(np.float32)
    firsts = _firsts(B, S, rng)
    for b in range(B):  # one mid-window seam per row at least
        firsts[b, rng.integers(1, S)] = 1.0
    return {
        "obs": rng.normal(size=(B, S, 4)).astype(np.float32), "act": act,
        "rew": (0.1 * rng.normal(size=(B, S, 1))).astype(np.float32), "logits": logits,
        "log_prob": log_prob, "is_fir": firsts,
        # 1-wide placeholders: the transformer's batch stores no carry
        "hx": np.zeros((B, S, 1), np.float32), "cx": np.zeros((B, S, 1), np.float32),
    }


@pytest.mark.parametrize("k_epoch", [1, 2])
@pytest.mark.parametrize("impl", ["full", "flash"])
def test_train_step_matches_tpu_rl(impl, k_epoch):
    """One PPO train step of the transformer family in f32 from one state
    (after a JAX warm-up step, so RMSprop nu is nonzero) on one batch with
    seams: loss at rtol 1e-5, every metric incl. diag, params and nu."""
    kw = dict(attention_impl=impl, K_epoch=k_epoch, learn_diag=True, update_guard=True)
    jcfg = small_config(**{**TF, **kw})
    _fam, jstate, jstep = jax_get_algo("PPO").build(jcfg, jax.random.key(0))
    jstate = jstate.replace(params={"actor": perturbed(jstate.params["actor"], 3)})
    jstep = jax.jit(jstep)
    jstate, _ = jstep(jstate, JaxBatch.from_mapping(_batch_np(8, 16, 20)), jax.random.key(1))
    jstate = jax.device_get(jstate)
    batch_np = _batch_np(8, 16, 21)
    jnew, jmetrics = jstep(jstate, JaxBatch.from_mapping(batch_np), jax.random.key(1))

    cfg = Config.from_dict({**TF, **kw, "buffer_size": 32, "time_horizon": 32})
    _f, _s, step = get_algo("PPO").build(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = train_state_from_flax(jstate)
    assert "block0.ln1.weight" in state.opt_state["nu"]["actor"]
    new, metrics = step(state, Batch.from_mapping(batch_np, device="cpu"))
    _assert_metrics_close(metrics, jax.device_get(jmetrics))
    _assert_states_close(new, jax.device_get(jnew))
    assert float(metrics["nonfinite-updates"]) == 0.0


COLOCATED = dict(env="CartPole-v1", env_mode="colocated", algo="PPO", model="transformer",
                 hidden_size=16, n_heads=2, n_layers=2, seq_len=8, act_ctx=4, batch_size=4,
                 buffer_size=4, time_horizon=6, reward_scale=1.0, loss_log_interval=10**9,
                 attention_impl="flash")


class _WithoutMesh:
    """An algo spec whose ``build`` drops the mesh: tpu_rl's ColocatedLoop
    hands the transformer its one-axis data mesh, and the transformer then
    looks up a "seq" axis that mesh lacks (tpu_rl/models/transformer.py:91-94).
    Without a mesh the one-device program is the same."""

    def __init__(self, spec):
        self.spec = spec

    def build(self, cfg, key, mesh=None):
        return self.spec.build(cfg, key)


def test_colocated_program_matches_tpu_rl(monkeypatch):
    """tpu_rl's colocated rollout of the transformer gives one batch (with
    its 1-wide carry placeholders); the port's ``program`` from the bridged
    state, fed that rollout, matches tpu_rl's standalone train step."""
    import tpu_rl.algos.registry as jax_registry

    jax_get = jax_registry.get_algo
    monkeypatch.setattr(jax_registry, "get_algo", lambda name: _WithoutMesh(jax_get(name)))
    jloop = JaxColocatedLoop(JaxConfig(**COLOCATED))
    jstate = jloop.state.replace(params={"actor": perturbed(jloop.state.params["actor"], 5)})
    k_roll, k_train = jax.random.split(jax.random.PRNGKey(42))
    _c, jbatch, jdone, jret = jloop.rollout(
        jax_act_params(jstate), jloop.init_carry(jax.random.PRNGKey(7)), k_roll
    )
    jnew, jmetrics = jax.jit(jloop._train_step)(jstate, jbatch, k_train)
    assert np.asarray(jbatch.hx).shape == (4, 8, 1)

    loop = ColocatedLoop(Config(**COLOCATED), device="cpu")
    state = train_state_from_flax(jax.device_get(jstate))
    batch = Batch.from_mapping({f: np.array(getattr(jbatch, f)) for f in BATCH_FIELDS}, device="cpu")
    done, ep_ret = torch.from_numpy(np.array(jdone)), torch.from_numpy(np.array(jret))
    monkeypatch.setattr(loop, "rollout", lambda params, carry, generator=None: (carry, batch, done, ep_ret))
    new, _carry, stats, metrics = loop.program(state, loop.init_carry(), loop.init_stats())
    _assert_metrics_close(metrics, jax.device_get(jmetrics))
    _assert_states_close(new, jax.device_get(jnew))
    assert int(stats["episodes"]) == int(np.asarray(jdone).sum()) > 0


def test_colocated_rollout_stores_placeholders_and_runs():
    """The port's own transformer rollout stores zero (B,S,1) hx/cx, not
    the caches, empties the caches at episode ends, and a short run ends
    with finite metrics."""
    loop = ColocatedLoop(Config(**COLOCATED), seed=0, max_updates=2, device="cpu")
    carry = loop.init_carry(torch.Generator().manual_seed(0))
    assert carry["h"].shape == (4, 2 * 4 * 16) and carry["c"].shape == (4, 2 * 4 * 16 + 1)
    carry2, batch, done, _ret = loop.rollout(
        {"actor": loop.state.params["actor"]}, carry, torch.Generator().manual_seed(1)
    )
    assert batch.hx.shape == batch.cx.shape == (4, 8, 1)
    assert not batch.hx.any() and not batch.cx.any()
    assert done[:, 5].all()  # horizon 6
    # the counter restarted at the episode end: 8 ticks, the last 2 after the reset
    np.testing.assert_array_equal(carry2["c"][:, -1].numpy(), 2.0)
    out = loop.run(log=False)
    assert out["updates"] == 2 and np.isfinite(out["mean_return_overall"])


def test_family_owns_its_carry_storage_and_bf16_reduction(monkeypatch):
    """The family says what a batch stores for the carry (1-wide placeholders
    for the transformer, the acting carry for the LSTM), and building a bf16
    transformer makes bf16 products reduce in f32, as tpu_rl's do; an f32
    model leaves the flag alone."""
    matmul = torch.backends.cuda.matmul
    monkeypatch.setattr(matmul, "allow_bf16_reduced_precision_reduction", True)
    fam = build_family(Config.from_dict(TF), device="cpu")
    assert fam.stored_carry_widths == (1, 1) and fam.store_carry is False
    assert matmul.allow_bf16_reduced_precision_reduction is True
    build_family(Config.from_dict({**TF, "compute_dtype": "bfloat16"}), device="cpu")
    assert matmul.allow_bf16_reduced_precision_reduction is False
    lstm = build_family(Config(hidden_size=24), device="cpu")
    assert lstm.stored_carry_widths == lstm.carry_widths == (24, 24)


def test_config_carries_tpu_rl_transformer_fields():
    """n_heads, n_layers, attention_impl and act_ctx load with tpu_rl's names
    and defaults; the long-context example config loads with the flash impl
    (its blockwise impl waits for its slice); the transformer is refused for
    off-policy algos and, for now, by the inference service."""
    import json
    from pathlib import Path

    from tpu_rl_torch.runtime.inference_service import InferenceService
    from tpu_rl_torch.runtime.local_router import LocalRouter

    for name in ("n_heads", "n_layers", "attention_impl", "act_ctx"):
        assert getattr(Config(), name) == getattr(JaxConfig(), name), name
    raw = json.loads((Path(__file__).parent.parent / "configs/longcontext_singlechip.example.json").read_text())
    with pytest.raises(NotImplementedError, match="blockwise-attention slice"):
        Config.from_dict(raw)
    raw.update(attention_impl="flash", env_mode="colocated")
    cfg, jcfg = Config.from_dict(raw), JaxConfig.from_dict(raw)
    for name in ("model", "compute_dtype", "hidden_size", "n_heads", "n_layers", "seq_len",
                 "act_ctx", "effective_act_ctx", "batch_size", "attention_impl"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert Config(seq_len=7, model="transformer").effective_act_ctx == 7
    with pytest.raises(AssertionError, match="on-policy"):
        Config.from_dict({"model": "transformer", "algo": "SAC"})
    cfg = Config.from_dict(TF)
    fam = build_family(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="transformer-serving slice"):
        InferenceService(cfg, fam, fam.init_params(), LocalRouter(), device="cpu")
