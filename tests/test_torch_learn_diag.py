"""The learning-dynamics plane of the port (``tpu_rl_torch.obs.learn``)
against ``tpu_rl.obs.learn``: the staleness buckets, the on-device
accumulator over diag dicts made from a numpy seed at mixed staleness
(``derive`` equal within 1e-6), and ``derive`` of a real diag after one
bridged PPO step and one IMPALA step (at those steps' 1e-5 bar)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_rl.obs.learn as JL
import tpu_rl_torch.obs.learn as TL
from tests.test_torch_ppo import _jax_step, setup_algo_step
from tpu_rl.obs import MetricsRegistry as JaxRegistry
from tpu_rl_torch.obs import MetricsRegistry

SCALARS = ("grad-norm-torso", "grad-norm-cell", "grad-norm-heads", "update-norm", "param-norm")


def _assert_doc_close(got: dict, want: dict, atol: float, rtol: float = 0.0) -> None:
    """Two derived documents: the same keys, every number within the bar."""
    assert got["n_updates"] == want["n_updates"]
    assert set(got["global"]) == set(want["global"])
    for k, w in want["global"].items():
        np.testing.assert_allclose(got["global"][k], w, atol=atol, rtol=rtol, err_msg=k)
    assert set(got["buckets"]) == set(want["buckets"])
    for label, vals in want["buckets"].items():
        assert set(got["buckets"][label]) == set(vals), label
        for k, w in vals.items():
            np.testing.assert_allclose(got["buckets"][label][k], w, atol=atol, rtol=rtol,
                                       err_msg=f"{label} {k}")


def test_stale_bucket_index_and_host_rows_match():
    stale = np.array([-3, 0, 0.5, 1, 2, 3, 4, 7, 8, 15, 16, 31, 32, 63, 64, 1000], np.float32)
    want = np.asarray(JL.stale_bucket_index(jnp.asarray(stale)))
    got = TL.stale_bucket_index(torch.from_numpy(stale)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7]
    vers = np.array([-1, 3, 10, 12])
    for v, n in ((vers, 4), (None, 4), (vers, 5)):
        np.testing.assert_array_equal(TL.host_stale_rows(12, v, n), JL.host_stale_rows(12, v, n))
    assert TL.N_STALE_BUCKETS == JL.N_STALE_BUCKETS
    assert TL.STALE_BUCKET_LABELS == JL.STALE_BUCKET_LABELS
    assert (TL.GAUGE_PREFIX, TL.BUCKET_GAUGE_PREFIX) == (JL.GAUGE_PREFIX, JL.BUCKET_GAUGE_PREFIX)


def _diags(seed: int, n: int, rows: int):
    """n diag dicts (numpy) and their per-row staleness, mixed buckets."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = rng.uniform(0.2, 2.0, rows).astype(np.float32)
        adv = rng.normal(0.0, 1.5, rows).astype(np.float32)
        ret = rng.normal(1.0, 2.0, rows).astype(np.float32)
        err = (ret - rng.normal(1.0, 1.0, rows)).astype(np.float32)
        rows_d = {
            "ent": rng.uniform(0.1, 0.7, rows), "kl": rng.normal(0, 0.01, rows),
            "clip": rng.uniform(0, 0.3, rows), "w": w, "w2": w * w * 1.1, "adv": adv,
            "adv2": adv * adv + 0.1, "ret": ret, "ret2": ret * ret + 0.2, "err": err,
            "err2": err * err + 0.05,
        }
        diag = {
            "rows": {k: np.asarray(v, np.float32) for k, v in rows_d.items()},
            "scalars": {k: np.asarray(rng.uniform(0.01, 30.0), np.float32) for k in SCALARS},
        }
        stale = rng.choice([0, 1, 2, 3, 5, 9, 40, 70], rows).astype(np.float32)
        out.append((diag, stale))
    return out


@pytest.mark.parametrize("seed,n,rows", [(0, 1, 8), (1, 7, 128), (2, 3, 5)])
def test_accumulator_matches_tpu_rl_over_mixed_staleness(seed, n, rows):
    """Fold the same diags through tpu_rl's jitted accumulate and the
    port's DiagAccumulator; drained documents agree within 1e-6 (the sums
    are f32 in both), and a second drain is empty."""
    diags = _diags(seed, n, rows)
    jacc = JL.DiagAccumulator()
    tacc = TL.DiagAccumulator()
    for diag, stale in diags:
        jacc.add(jax.tree.map(jnp.asarray, diag), jnp.asarray(stale))
        tacc.add(jax.tree.map(torch.from_numpy, diag), torch.from_numpy(stale))
    want, got = jacc.drain(n), tacc.drain(n)
    _assert_doc_close(got, want, atol=1e-6, rtol=1e-6)
    assert got["n_updates"] == n and len(got["buckets"]) > 1
    assert tacc.drain(n + 1) is None
    # publish: the same gauges and histograms in both registries
    reg, jreg = MetricsRegistry(role="r", pid=0, host="h"), JaxRegistry(role="r", pid=0, host="h")
    TL.publish(reg, got)
    JL.publish(jreg, want)
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    for kind in ("counters", "gauges"):
        assert [e[:2] for e in snap[kind]] == [e[:2] for e in jsnap[kind]]
        np.testing.assert_allclose([e[2] for e in snap[kind]], [e[2] for e in jsnap[kind]],
                                   atol=1e-6, rtol=1e-6)
    assert [h[:2] for h in snap["hists"]] == [h[:2] for h in jsnap["hists"]]
    rec, jrec = TL.learn_record(n, got), JL.learn_record(n, want)
    assert set(rec) == set(jrec) and rec["idx"] == jrec["idx"] == n


def test_accumulator_without_scalars():
    """A diag with no scalars drains as tpu_rl's does."""
    diag, stale = _diags(3, 1, 4)[0]
    diag = {"rows": diag["rows"], "scalars": {}}
    jacc, tacc = JL.DiagAccumulator(), TL.DiagAccumulator()
    jacc.add(jax.tree.map(jnp.asarray, diag), jnp.asarray(stale))
    tacc.add(jax.tree.map(torch.from_numpy, diag), torch.from_numpy(stale))
    _assert_doc_close(tacc.drain(1), jacc.drain(1), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("algo", ["PPO", "IMPALA"])
def test_derive_of_a_real_diag_matches_tpu_rl(algo):
    """One bridged train step of each package (B8 S5 H16); the port's diag
    and tpu_rl's folded at staleness 0 and derived agree at the steps' own
    bar (1e-5 on every diag row and scalar, tests/test_torch_ppo.py)."""
    jstate, jstep, jbatch, state, step, batch = setup_algo_step(algo, 1)
    _jnew, jmetrics = _jax_step(jstep, jstate, jbatch)
    _new, metrics = step(state, batch)
    jdiag = jax.device_get(jmetrics)["diag"]
    diag = metrics["diag"]
    rows = next(iter(diag["rows"].values())).shape[0]
    jacc, tacc = JL.DiagAccumulator(), TL.DiagAccumulator()
    jacc.add(jdiag, jnp.zeros((rows,), jnp.float32))
    tacc.add(diag, torch.zeros((rows,)))
    want, got = jacc.drain(1), tacc.drain(1)
    _assert_doc_close(got, want, atol=1e-5, rtol=1e-5)
    assert list(got["buckets"]) == ["0"] and got["buckets"]["0"]["rows"] == rows
