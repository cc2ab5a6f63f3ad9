"""The port's colocated loop (``tpu_rl_torch.runtime.colocated``) on the
CPU: a short run returns ``tpu_rl``'s summary keys with finite values, the
rollout keeps the worker's tick semantics, and one ``program`` step fed
``tpu_rl``'s params and rollout batch matches ``tpu_rl``'s standalone train
step (as ``tests/test_colocated.py`` pins the fused update in ``tpu_rl``),
at the train-step tolerances of ``tests/test_torch_ppo.py``."""

import math

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_bridge import with_random_biases
from tests.test_torch_ppo import _assert_metrics_close, _assert_states_close
from tpu_rl.config import Config as JaxConfig
from tpu_rl.models import cells as jax_cells
from tpu_rl.runtime.colocated import ColocatedLoop as JaxColocatedLoop
from tpu_rl.runtime.colocated import act_params as jax_act_params
from tpu_rl.runtime.colocated import resolve_colocated_config as jax_resolve
from tpu_rl.types import BATCH_FIELDS
from tpu_rl_torch.bridge import train_state_from_flax
from tpu_rl_torch.config import Config
from tpu_rl_torch.runtime.colocated import ColocatedLoop, resolve_colocated_config
from tpu_rl_torch.types import Batch
from tpu_rl_torch.utils.tree import tree_leaves

SUMMARY_KEYS = (
    "updates", "env_steps", "episodes", "mean_return_overall", "mean_return_recent",
    "mean_return_best_window", "elapsed_s", "transitions_per_s",
)


def _kw(**kw):
    base = dict(
        env="CartPole-v1", env_mode="colocated", algo="PPO", batch_size=8, buffer_size=8,
        seq_len=5, hidden_size=16, time_horizon=100, loss_log_interval=10**9,
    )
    base.update(kw)
    return base


def test_cpu_run_returns_finite_summary():
    loop = ColocatedLoop(Config(**_kw(loss_log_interval=1, time_horizon=3)), seed=0,
                         max_updates=3, device="cpu")
    out = loop.run(log=False)
    assert out["updates"] == 3
    assert out["env_steps"] == 3 * 8 * 5
    assert out["episodes"] > 0  # horizon 3 inside 15 ticks: every env ends episodes
    for k in SUMMARY_KEYS:
        assert math.isfinite(out[k]), (k, out[k])
    assert out["transitions_per_s"] > 0
    assert "colocated-iteration-elapsed-mean-sec" in out["scalars"]
    assert int(loop.state.step) == 3


def test_rollout_window_tick_semantics():
    """is_fir=1 on every env's first row and on every post-done row; the
    stored carry is the pre-step carry (zeros on a fresh episode's first
    row); the reward carries reward_scale."""
    loop = ColocatedLoop(Config(**_kw(batch_size=2, time_horizon=3)), device="cpu")
    carry = loop.init_carry(torch.Generator().manual_seed(0))
    params = {"actor": loop.state.params["actor"]}
    _carry, batch, done, ep_ret = loop.rollout(params, carry, torch.Generator().manual_seed(1))
    is_fir = batch.is_fir[..., 0].numpy()
    assert np.all(is_fir[:, 0] == 1.0)
    np.testing.assert_array_equal(is_fir[:, 1:], done[:, :-1].numpy().astype(np.float32))
    assert done[:, 2].all()  # horizon 3: done at t=2
    np.testing.assert_array_equal(batch.hx[:, 0].numpy(), 0.0)
    np.testing.assert_array_equal(batch.cx[:, 0].numpy(), 0.0)
    np.testing.assert_allclose(batch.rew.numpy(), loop.cfg.reward_scale)
    np.testing.assert_array_equal(ep_ret[:, 2].numpy(), 3.0)  # raw return of a 3-step episode
    for f in BATCH_FIELDS:
        assert getattr(batch, f).shape[:2] == (2, 5), f


def test_resolve_colocated_config_matches():
    kw = _kw(colocated_envs=16)
    got = resolve_colocated_config(Config(**kw))
    want = jax_resolve(JaxConfig(**kw))
    for k in ("batch_size", "buffer_size", "obs_shape", "action_space", "is_continuous"):
        assert getattr(got, k) == getattr(want, k), k
    with pytest.raises(ValueError, match="env_mode='colocated'"):
        ColocatedLoop(Config(**_kw(env_mode="distributed")), device="cpu")


def test_program_step_matches_tpu_rl_standalone_train_step(monkeypatch):
    """tpu_rl's colocated rollout gives one batch; tpu_rl's standalone train
    step on it is the reference. The port's ``program``, from the same
    (bridged) train state and fed that same rollout, must match it in loss,
    metrics, params and nu, and count the rollout's episodes."""
    jloop = JaxColocatedLoop(JaxConfig(**_kw(time_horizon=4)))
    jstate = jloop.state.replace(params={"actor": with_random_biases(jloop.state.params["actor"], 5)})
    k_roll, k_train = jax.random.split(jax.random.PRNGKey(42))
    jcarry = jloop.init_carry(jax.random.PRNGKey(7))
    _c, jbatch, jdone, jret = jloop.rollout(jax_act_params(jstate), jcarry, k_roll)
    jax_cells.set_pallas_mode("interpret")
    try:
        jnew, jmetrics = jax.jit(jloop._train_step)(jstate, jbatch, k_train)
    finally:
        jax_cells.set_pallas_mode("auto")

    loop = ColocatedLoop(Config(**_kw(time_horizon=4)), device="cpu")
    state = train_state_from_flax(jax.device_get(jstate))
    batch = Batch.from_mapping({f: np.array(getattr(jbatch, f)) for f in BATCH_FIELDS}, device="cpu")
    done = torch.from_numpy(np.array(jdone))
    ep_ret = torch.from_numpy(np.array(jret))
    monkeypatch.setattr(loop, "rollout", lambda params, carry, generator=None: (carry, batch, done, ep_ret))
    new, _carry, stats, metrics = loop.program(state, loop.init_carry(), loop.init_stats())
    _assert_metrics_close(metrics, jax.device_get(jmetrics))
    _assert_states_close(new, jax.device_get(jnew))
    assert int(stats["episodes"]) == int(np.asarray(jdone).sum()) > 0
    np.testing.assert_allclose(float(stats["ret_sum"]), float(np.asarray(jret).sum()), rtol=1e-6)


@pytest.mark.parametrize("env,algo", [("CartPole-v1", "IMPALA"), ("CartPole-v1", "V-MPO"),
                                      ("Pendulum-v1", "PPO-Continuous")])
def test_program_step_matches_tpu_rl_for_the_other_algorithms(monkeypatch, env, algo):
    """The other on-policy algorithms through the colocated program, as
    ``tests/test_colocated.py`` runs them in tpu_rl: tpu_rl's rollout gives
    one batch (Pendulum's: (B,S,1) f32 torques and per-dimension
    log-probs), and the port's ``program`` from the bridged state, fed that
    batch (V-MPO also tpu_rl's KL-bound draws), matches tpu_rl's train step
    on it."""
    kw = _kw(env=env, algo=algo, time_horizon=4)
    jloop = JaxColocatedLoop(JaxConfig(**kw))
    jstate = jloop.state.replace(params={**jloop.state.params,
                                         "actor": with_random_biases(jloop.state.params["actor"], 5)})
    k_roll, k_train = jax.random.split(jax.random.PRNGKey(42))
    _c, jbatch, jdone, jret = jloop.rollout(jax_act_params(jstate), jloop.init_carry(jax.random.PRNGKey(7)), k_roll)
    jax_cells.set_pallas_mode("interpret")
    try:
        jnew, jmetrics = jax.jit(jloop._train_step)(jstate, jbatch, k_train)
    finally:
        jax_cells.set_pallas_mode("auto")

    loop = ColocatedLoop(Config(**kw), device="cpu")
    batch = Batch.from_mapping({f: np.array(getattr(jbatch, f)) for f in BATCH_FIELDS}, device="cpu")
    if algo == "PPO-Continuous":
        assert batch.act.shape == batch.log_prob.shape == (8, 5, 1) and not batch.logits.any()
    done, ep_ret = torch.from_numpy(np.array(jdone)), torch.from_numpy(np.array(jret))
    monkeypatch.setattr(loop, "rollout", lambda params, carry, generator=None: (carry, batch, done, ep_ret))
    if algo == "V-MPO":
        u = torch.tensor([float(jax.random.uniform(jax.random.fold_in(k_train, e), ()))
                          for e in range(loop.cfg.K_epoch)])
        step = loop.train_step
        monkeypatch.setattr(loop, "train_step", lambda s, b, generator=None: step(s, b, coef_alpha_u=u))
    state = train_state_from_flax(jax.device_get(jstate))
    new, _carry, stats, metrics = loop.program(state, loop.init_carry(), loop.init_stats())
    jmetrics = jax.device_get(jmetrics)
    if algo == "IMPALA":
        # On-policy data puts the importance weights at 1 within an ulp,
        # on the c-clip row's threshold (w >= c_bar = 1): there the row's
        # 0/1 flags follow the last bit of each side's log-probs. Rows with
        # a weight that close may differ; every other row must agree.
        from tpu_rl_torch.algos.ppo import policy_outputs

        lp = policy_outputs(loop.family, state.params, batch)[0]
        w = torch.exp(lp[:, :-1] - batch.log_prob[:, :-1]).reshape(lp.shape[0], -1)
        near = ((w - loop.cfg.c_bar).abs() <= 1e-6).any(dim=1).numpy()
        got = metrics["diag"]["rows"].pop("c-clip").numpy()
        want = np.asarray(jmetrics["diag"]["rows"].pop("c-clip"))
        np.testing.assert_array_equal(got[~near], want[~near])
    _assert_metrics_close(metrics, jmetrics)
    _assert_states_close(new, jax.device_get(jnew))
    assert int(stats["episodes"]) == int(np.asarray(jdone).sum()) > 0


def test_pendulum_rollout_carries_continuous_actions():
    """PPO-Continuous on Pendulum: (B,S,A) f32 actions and per-dimension
    log-probs, zero behaviour logits, negative costs scaled, and a few
    updates that stay finite."""
    loop = ColocatedLoop(Config(**_kw(env="Pendulum-v1", algo="PPO-Continuous", time_horizon=3,
                                      loss_log_interval=1)), seed=0, max_updates=2, device="cpu")
    carry = loop.init_carry(torch.Generator().manual_seed(0))
    _c, batch, done, _r = loop.rollout({"actor": loop.state.params["actor"]}, carry,
                                       torch.Generator().manual_seed(1))
    assert batch.act.shape == batch.log_prob.shape == batch.logits.shape == (8, 5, 1)
    assert batch.act.dtype == torch.float32 and not batch.logits.any()
    assert float(batch.rew.max()) <= 0.0 and done[:, 2].all()
    out = loop.run(log=False)
    assert out["updates"] == 2 and all(math.isfinite(out[k]) for k in SUMMARY_KEYS)
    assert out["episodes"] > 0


# ------------------------------------------------------- the telemetry plane
# tpu_rl's own colocated test (tests/test_colocated.py) reads these names
# from telemetry.json; the performance plane adds the rest.
TELEMETRY_NAMES = (
    "colocated-updates", "colocated-env-steps", "colocated-env-steps-per-s",
    "colocated-scan-chunk-s", "colocated-flops-per-step", "colocated-achieved-flops",
    "colocated-mfu", "colocated-xla-recompiles", "colocated-device-mem-bytes",
    "colocated-device-mem-peak-bytes", "colocated-goodput-ratio", "learner-diag-entropy",
    "learner-diag-ess",
)


def free_port() -> int:
    """A port no socket holds now (the OS's pick for port 0)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_run_with_result_dir_writes_the_reference_files(tmp_path, monkeypatch):
    """telemetry.json under tpu_rl's metric names, learn.jsonl at the log
    cadence (and at the last update), goodput.jsonl, slo.json and the
    history store; the FLOPs gauge is the tracker's count of the first
    update and no update recompiled."""
    import json

    monkeypatch.setenv("TPU_RL_PEAK_FLOPS", "1e12")
    cfg = Config(**_kw(loss_log_interval=5, result_dir=str(tmp_path), telemetry_interval_s=1e-3,
                       slo_spec="gauge:colocated-updates-per-s>0,counter:colocated-xla-recompiles==0"))
    loop = ColocatedLoop(cfg, seed=0, max_updates=12, device="cpu")
    out = loop.run(log=False)
    assert out["updates"] == 12
    assert {"telemetry.json", "learn.jsonl", "goodput.jsonl", "slo.json", "history"} <= set(
        p.name for p in tmp_path.iterdir())
    payload = (tmp_path / "telemetry.json").read_text()
    for name in TELEMETRY_NAMES:
        assert f'"{name}"' in payload, name
    gauges = {g[0]: g[2] for s in json.loads(payload)["sources"] for g in s["gauges"]}
    assert gauges["colocated-flops-per-step"] == loop._perf.flops_per_call > 0
    assert gauges["colocated-mfu"] == pytest.approx(gauges["colocated-achieved-flops"] / 1e12)
    assert loop._perf.recompiles == 0
    learn = [json.loads(x) for x in (tmp_path / "learn.jsonl").read_text().splitlines()]
    assert [r["idx"] for r in learn] == [5, 10, 12]
    assert [r["n_updates"] for r in learn] == [5, 5, 2]
    assert list(learn[0]["buckets"]) == ["0"] and learn[0]["buckets"]["0"]["rows"] == 5 * 8
    slo = json.loads((tmp_path / "slo.json").read_text())
    assert slo["ok"] is True and not loop.slo_failed
    goodput = json.loads((tmp_path / "goodput.jsonl").read_text().splitlines()[-1])
    assert goodput["colocated"]["buckets"]["compute"] > 0


@pytest.mark.parametrize("fail_run", [False, True], ids=["gate_off", "gate_armed"])
def test_slo_fail_run_raises_at_the_end_of_a_failing_run(tmp_path, fail_run):
    """An impossible rule fails the final verdict. With slo_fail_run the run
    raises SloFailedError after writing its files; without it the run
    returns its totals and only slo.json says so."""
    import json

    from tpu_rl_torch.runtime.colocated import SloFailedError

    cfg = Config(**_kw(loss_log_interval=2, result_dir=str(tmp_path), telemetry_interval_s=1e-3,
                       slo_spec="gauge:colocated-updates-per-s<0", slo_fail_run=fail_run))
    loop = ColocatedLoop(cfg, seed=0, max_updates=4, device="cpu")
    if fail_run:
        with pytest.raises(SloFailedError, match=r"colocated-updates-per-s<0"):
            loop.run(log=False)
    else:
        assert loop.run(log=False)["updates"] == 4
    assert loop.slo_failed and int(loop.state.step) == 4
    slo = json.loads((tmp_path / "slo.json").read_text())
    assert slo["ok"] is False and slo["failing"] == 1
    assert (tmp_path / "telemetry.json").exists()


def test_checkpointed_restart_writes_the_resume_record(tmp_path):
    """A resumed run appends one {"idx", "epoch", "t"} line to
    learner_resume.jsonl, the schema of tpu_rl's learner and loop."""
    import json

    from tpu_rl.obs.audit import append_resume as jax_append_resume

    cfg = Config(**_kw(result_dir=str(tmp_path), model_dir=str(tmp_path / "models"),
                       model_save_interval=5, ckpt_async=False))
    ColocatedLoop(cfg, seed=0, max_updates=10, device="cpu").run(log=False)
    assert not (tmp_path / "learner_resume.jsonl").exists()
    loop = ColocatedLoop(cfg, seed=0, max_updates=15, device="cpu")
    assert loop.run(log=False)["updates"] == 15
    recs = [json.loads(x) for x in (tmp_path / "learner_resume.jsonl").read_text().splitlines()]
    assert [(r["idx"], r["epoch"]) for r in recs] == [(10, 1)]
    jax_append_resume(str(tmp_path / "ref"), 10, 1)
    ref = json.loads((tmp_path / "ref" / "learner_resume.jsonl").read_text())
    assert set(recs[0]) == set(ref) == {"idx", "epoch", "t"}


def test_params_with_telemetry_on_are_bitwise_those_with_it_off(tmp_path):
    """The plane never feeds back into the update: the counted first
    update, the diag fold and the readbacks leave every parameter and
    optimizer leaf bit for bit where a run without the plane leaves it."""
    states = []
    for kw in ({}, dict(result_dir=str(tmp_path), telemetry_interval_s=1e-3)):
        loop = ColocatedLoop(Config(**_kw(loss_log_interval=3, **kw)), seed=0, max_updates=7,
                             device="cpu")
        loop.run(log=False)
        states.append(loop.state)
    off, on = states
    assert int(off.step) == int(on.step) == 7
    for tree in ("params", "opt_state"):
        a, b = tree_leaves(getattr(off, tree)), tree_leaves(getattr(on, tree))
        assert len(a) == len(b) > 0
        assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True)), tree


def test_live_metrics_scrape_shows_mfu_and_diag(monkeypatch):
    """While the loop runs, /metrics serves colocated_mfu and the
    learner_diag_* gauges; /healthz and /goodput answer."""
    import json
    import urllib.request

    monkeypatch.setenv("TPU_RL_PEAK_FLOPS", "1e12")
    port = free_port()
    cfg = Config(**_kw(loss_log_interval=2, telemetry_port=port))
    loop = ColocatedLoop(cfg, seed=0, max_updates=6, device="cpu")
    scraped = {}
    tick = loop._telemetry_tick

    def tick_and_scrape(updates, *a):
        tick(updates, *a)
        if updates >= 4 and not scraped:  # the diag of the first window is published
            base = f"http://127.0.0.1:{port}"
            for path in ("/metrics", "/healthz", "/goodput"):
                with urllib.request.urlopen(base + path, timeout=30) as r:
                    scraped[path] = (r.status, r.read().decode())

    loop._telemetry_tick = tick_and_scrape
    loop.run(log=False)
    status, text = scraped["/metrics"]
    assert status == 200
    for series in ("colocated_mfu", "colocated_flops_per_step", "learner_diag_entropy",
                   "learner_diag_approx_kl", "learner_diag_by_stale_ess"):
        assert f"\n{series}{{" in text, series
    assert scraped["/healthz"][0] == 200
    assert json.loads(scraped["/goodput"][1])["colocated"]["buckets"]["compute"] > 0
