"""The port's inline trainer (``tpu_rl_torch.examples.train_inline``) on the
CPU: ``tests/test_train_inline.py``'s four stats-contract tests on
``device="cpu"``; then, for SAC (CartPole-v1) and SAC-Continuous
(Pendulum-v1) under random-action warm-up, both trainers run from one set of
weights (``tpu_rl``'s init, bridged) and are held against each other:

- every call on the host generator (warm-up actions, replay indices) is the
  same call with the same result, so the sampled indices are equal;
- every replay window: ``obs``, ``act``, ``rew`` and ``is_fir`` bit for bit,
  ``logits`` and ``log_prob`` NaN in both (the warm-up poisoning), ``hx`` and
  ``cx`` at 1e-5 (the acting LSTM on each side) while both sides' params
  agree;
- the first train batch, and one train step on it against ``tpu_rl``'s
  ``train_step`` from the bridged state, with ``tpu_rl``'s noise for
  SAC-Continuous: loss rtol 1e-5, other metrics and params 1e-5, optimizer
  moments 3e-5. ``tpu_rl``'s step runs its LSTM as the scan here (its
  automatic mode off the TPU); its kernel in interpret mode is held to the
  same plain arithmetic by ``tests/test_torch_lstm.py``.
"""

import collections
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import examples.train_inline as jax_inline  # noqa: E402
from tests.test_torch_ppo import _assert_metrics_close  # noqa: E402
from tests.test_torch_sac import assert_sac_states_close  # noqa: E402
from tpu_rl.types import BATCH_FIELDS  # noqa: E402
from tpu_rl_torch.bridge import sac_state_from_flax  # noqa: E402
from tpu_rl_torch.examples import train_inline  # noqa: E402
from tpu_rl_torch.types import Batch  # noqa: E402

STATS_KEYS = {
    "algo", "env", "final_mean_50", "target", "reached_target",
    "time_to_target_s", "greedy_eval_mean_20", "updates", "env_steps",
    "wallclock_s", "env_steps_per_s", "seed",
}
CARRY_ATOL = 1e-5


# ------------------------------------------------------------ stats contract
@pytest.mark.timeout(300)
def test_on_policy_inline_with_anneal_and_eval():
    stats = train_inline.run(
        updates=4, algo="IMPALA", env_name="CartPole-v1", batch_size=4,
        overrides=dict(hidden_size=16, entropy_anneal={"coef": 1e-4, "lr": 1e-4, "frac": 0.5}),
        device="cpu",
    )
    assert STATS_KEYS <= set(stats)
    assert stats["updates"] == 4
    assert stats["env_steps"] >= 4 * 4 * 5
    assert stats["greedy_eval_mean_20"] is not None
    assert stats["reached_target"] is False and stats["target"] is None


@pytest.mark.timeout(300)
def test_off_policy_inline_replay():
    stats = train_inline.run(
        updates=3, algo="SAC", env_name="CartPole-v1", batch_size=4,
        overrides=dict(hidden_size=16, buffer_size=16), device="cpu",
    )
    assert stats["updates"] == 3
    assert stats["env_steps"] < 3 * 4 * 5 + 4 * 5 + 25


@pytest.mark.timeout(300)
def test_continuous_warmup_and_greedy_eval():
    stats = train_inline.run(
        updates=3, algo="SAC-Continuous", env_name="Pendulum-v1", batch_size=4,
        overrides=dict(hidden_size=16, buffer_size=16, warmup_steps=10_000,
                       time_horizon=30, zero_window_carry=True),
        device="cpu",
    )
    assert stats["updates"] == 3
    assert stats["greedy_eval_mean_20"] is not None
    assert stats["greedy_eval_mean_20"] < 0.0


def test_warmup_rejected_for_on_policy():
    with pytest.raises(ValueError, match="off-policy"):
        train_inline.run(updates=1, algo="PPO", overrides=dict(warmup_steps=5), device="cpu")


@pytest.mark.timeout(300)
def test_std_floor_anneal_rebuilds_the_family():
    """An entropy_anneal with std_floor rebuilds the family: the new act
    and train step use the floored Gaussian, and the params carry over."""
    built = []
    real = train_inline.build_family

    def spy(cfg, device="cuda"):
        built.append(cfg.std_floor)
        return real(cfg, device=device)

    mp = pytest.MonkeyPatch()
    mp.setattr(train_inline, "build_family", spy)
    try:
        stats = train_inline.run(
            updates=2, algo="PPO-Continuous", env_name="Pendulum-v1", batch_size=4,
            overrides=dict(hidden_size=16, time_horizon=30,
                           entropy_anneal={"coef": 1e-4, "std_floor": 0.3, "at": 1}),
            device="cpu",
        )
    finally:
        mp.undo()
    assert built == [0.3] and stats["updates"] == 2


# ------------------------------------------------- both trainers, one start
class _RecordingRng:
    """np.random.Generator proxy that logs every call and its result."""

    def __init__(self, rng, log):
        self._rng, self._log = rng, log

    def __getattr__(self, name):
        fn = getattr(self._rng, name)

        def call(*a, **kw):
            out = fn(*a, **kw)
            self._log.append((name, a, tuple(sorted(kw.items())), np.array(out, copy=True)))
            return out

        return call


def _recording_modules(deques):
    """A stand-in ``collections`` whose deques are kept in ``deques``."""
    def deque(*a, **kw):
        d = collections.deque(*a, **kw)
        deques.append(d)
        return d

    return types.SimpleNamespace(deque=deque)


SCENARIOS = {
    "SAC": dict(algo="SAC", env_name="CartPole-v1"),
    "SAC-Continuous": dict(algo="SAC-Continuous", env_name="Pendulum-v1"),
}
RUN_KW = dict(updates=6, batch_size=4, seed=3, log_every=1000)
OVERRIDES = dict(hidden_size=16, buffer_size=16, warmup_steps=10_000, time_horizon=40)


def _run_both(algo):
    """Both trainers from tpu_rl's initial state; returns what each saw."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        # tpu_rl: keep its initial state and its first train call
        rec = {"rng": [], "deques": [], "calls": []}
        real_get = jax_inline.get_algo

        def jax_get_algo(name):
            spec = real_get(name)

            class Spec:
                make_train_step = spec.make_train_step

                @staticmethod
                def build(cfg, key):
                    fam, state, step = spec.build(cfg, key)
                    rec["init"], rec["cfg"], rec["step"] = jax.device_get(state), cfg, step
                    return fam, state, step

            return Spec

        def recording_jit(fn):
            """jax.jit that keeps the train step's concrete inputs."""
            jitted = jax.jit(fn)
            if fn is not rec.get("step"):
                return jitted

            def call(state, batch, key):
                rec["calls"].append((jax.device_get(state), jax.device_get(batch), key))
                return jitted(state, batch, key)

            return call

        real_rng = np.random.default_rng
        mp.setattr(jax_inline, "get_algo", jax_get_algo)
        mp.setattr(jax_inline, "jax", types.SimpleNamespace(random=jax.random, jit=recording_jit))
        mp.setattr(jax_inline, "collections", _recording_modules(rec["deques"]))
        mp.setattr(np.random, "default_rng", lambda s: _RecordingRng(real_rng(s), rec["rng"]))
        jax_inline.run(**RUN_KW, **SCENARIOS[algo], overrides=dict(OVERRIDES))
        out["tpu_rl"] = rec
        mp.undo()

        # the port, from the bridged initial state
        rec2 = {"rng": [], "deques": [], "calls": []}
        real_port_get = train_inline.get_algo

        def port_get_algo(name):
            spec = real_port_get(name)

            class Spec:
                make_train_step = spec.make_train_step

                @staticmethod
                def build(cfg, generator, device):
                    fam, _state, step = spec.build(cfg, generator, device=device)
                    rec2["cfg"], rec2["family"] = cfg, fam

                    def recording_step(state, batch, generator=None):
                        rec2["calls"].append(batch)
                        return step(state, batch, generator=generator)

                    return fam, sac_state_from_flax(rec["init"]), recording_step

            return Spec

        mp.setattr(train_inline, "get_algo", port_get_algo)
        mp.setattr(train_inline, "collections", _recording_modules(rec2["deques"]))
        mp.setattr(np.random, "default_rng", lambda s: _RecordingRng(real_rng(s), rec2["rng"]))
        train_inline.run(**RUN_KW, **SCENARIOS[algo], overrides=dict(OVERRIDES), device="cpu")
        out["port"] = rec2
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def both(request):
    return request.param, _run_both(request.param)


def _replay(rec):
    (d,) = [d for d in rec["deques"] if d.maxlen == OVERRIDES["buffer_size"]]
    return list(d)


def test_host_generator_calls_and_sampled_indices_match(both):
    algo, out = both
    got, want = out["port"]["rng"], out["tpu_rl"]["rng"]
    assert [(n, a, k) for n, a, k, _ in got] == [(n, a, k) for n, a, k, _ in want]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g[3], w[3])
    sampled = [r for n, a, k, r in want if n == "integers" and np.shape(r) == (4,)]
    assert len(sampled) == RUN_KW["updates"]  # one batch of indices per update
    warm = {"SAC": "integers", "SAC-Continuous": "normal"}[algo]
    assert sum(n == warm for n, *_ in want) > 20  # warm-up actions were drawn


def test_replay_windows_match(both):
    """Every window of both replays: obs, act, rew, is_fir bit for bit (the
    warm-up actions do not depend on the policy); the poisoned
    logits/log_prob NaN; hx and cx at 1e-5 — for SAC in every window (its
    train step draws nothing, so both sides' params stay together), for
    SAC-Continuous in the windows collected before the first update (its
    step then draws its noise from each side's own generator)."""
    algo, out = both
    got, want = _replay(out["port"]), _replay(out["tpu_rl"])
    # a batch of windows before the first update, then one per update
    assert len(got) == len(want) == RUN_KW["batch_size"] + RUN_KW["updates"] - 1
    carried = len(want) if algo == "SAC" else RUN_KW["batch_size"]
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert set(g) == set(w) == set(BATCH_FIELDS)
        for f in ("obs", "act", "rew", "is_fir"):
            np.testing.assert_array_equal(g[f], w[f], err_msg=f)
            assert g[f].dtype == np.float32
        for f in ("logits", "log_prob"):
            assert np.isnan(g[f]).all() and np.isnan(w[f]).all(), f
        for f in ("hx", "cx"):
            if i < carried:
                np.testing.assert_allclose(g[f], w[f], atol=CARRY_ATOL, rtol=0, err_msg=f)
    assert any(w["hx"].any() for w in want)  # the acting carry really moved


def _noise(key, shape, k_epoch):
    """tpu_rl's per-epoch draws: ``k_pol, k_cri = split(fold_in(key, e))``."""
    out = []
    for e in range(k_epoch):
        ks = jax.random.split(jax.random.fold_in(key, e))
        out.append(tuple(torch.tensor(np.asarray(jax.random.normal(k, shape, jnp.float32)))
                         for k in ks))
    return out


def test_first_train_step_matches_tpu_rl(both):
    """The first train batch of both trainers agrees (hx/cx 1e-5, the rest
    bit for bit), and the port's train step on tpu_rl's batch from the
    bridged state matches tpu_rl's train_step at the reference's bars."""
    algo, out = both
    jstate, jbatch, jkey = out["tpu_rl"]["calls"][0]
    pbatch = out["port"]["calls"][0]
    for f in BATCH_FIELDS:
        got, want = getattr(pbatch, f).numpy(), np.asarray(getattr(jbatch, f))
        if f in ("hx", "cx"):
            np.testing.assert_allclose(got, want, atol=CARRY_ATOL, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    jstep = jax_inline.get_algo(algo).make_train_step(
        out["tpu_rl"]["cfg"], jax_inline.get_algo(algo).build(out["tpu_rl"]["cfg"],
                                                               jax.random.key(0))[0])
    jnew, jmetrics = jax.device_get(jax.jit(jstep)(jstate, jbatch, jkey))
    cfg, fam = out["port"]["cfg"], out["port"]["family"]
    step = train_inline.get_algo(algo).make_train_step(cfg, fam)
    batch = Batch.from_mapping({f: np.array(getattr(jbatch, f)) for f in BATCH_FIELDS},
                               device="cpu")
    noise = _noise(jkey, batch.act.shape, cfg.K_epoch) if fam.continuous else None
    new, metrics = step(sac_state_from_flax(jstate), batch, noise=noise)
    _assert_metrics_close(metrics, jmetrics)
    assert_sac_states_close(new, jnew)
    assert float(metrics["nonfinite-updates"]) == 0.0  # the NaN fields trip no guard
    assert np.isfinite(float(metrics["loss"]))
