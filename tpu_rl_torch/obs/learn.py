"""Learning-dynamics diagnostics — the port of ``tpu_rl.obs.learn``.

The train step returns a ``diag`` dict: per-row means of quantities the
loss already computed (``rows``, each a (R,) tensor) and per-update scalars
(per-module grad norms, update and param norms). Nothing here feeds back
into the update: params with the plane on are bitwise equal to off.

The loop folds each dispatch's ``diag`` into an on-device accumulator
bucketed by the batch's policy staleness (:class:`DiagAccumulator`; the
colocated loop's rows are all staleness 0): per-row channels add into their
bucket through one ``onehotᵀ @ rows`` product per channel, scalars and
counts add. The host reads the sums back only at the log cadence
(:meth:`DiagAccumulator.drain`), where :func:`derive` turns them into the
published curves: ``learner-diag-*`` gauges, the per-staleness
``learner-diag-by-stale-*`` families (:func:`publish`) and
``result_dir/learn.jsonl`` lines (:func:`learn_record`).

Row channels are per-row means, so pooled moments weight rows equally;
the accumulator holds pure sums, and all division happens on the host.
"""

from __future__ import annotations

import math
import time
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from tpu_rl_torch.ops.losses import global_norm

# Power-of-two staleness buckets: 0 (fresh / colocated), 1, 2-3, 4-7, ...
# 64+ (tpu_rl.obs.learn's layout).
N_STALE_BUCKETS = 8
STALE_BUCKET_LABELS: tuple[str, ...] = (
    "0", "1", "2-3", "4-7", "8-15", "16-31", "32-63", "64+",
)

GAUGE_PREFIX = "learner-diag-"
BUCKET_GAUGE_PREFIX = "learner-diag-by-stale-"

# Headline series of the two families.
ENTROPY_GAUGE = "learner-diag-entropy"
APPROX_KL_GAUGE = "learner-diag-approx-kl"
ESS_GAUGE = "learner-diag-ess"
BY_STALE_ESS_GAUGE = "learner-diag-by-stale-ess"
APPROX_KL_HIST = "learner-diag-approx-kl-hist"
ESS_HIST = "learner-diag-ess-hist"

_EPS = 1e-12


def rows_mean(x: torch.Tensor) -> torch.Tensor:
    """Per-row mean over all non-batch axes: (R, ...) -> (R,)."""
    return torch.mean(x.reshape(x.shape[0], -1), dim=1)


def module_grad_norms(grads: dict) -> dict[str, torch.Tensor]:
    """Global grad norm split by module group over ``{group: {name: grad}}``
    (names are state_dict keys): ``torso`` (a path part containing "body"),
    ``cell`` (the recurrent core), ``heads`` (everything else). The first
    path part that decides wins, as in ``tpu_rl``'s walk of the flax path."""
    parts: dict[str, list[torch.Tensor]] = {"torso": [], "cell": [], "heads": []}
    for group, tree in grads.items():
        for name, leaf in tree.items():
            kind = "heads"
            for part in (group, *name.split(".")):
                if "body" in part:
                    kind = "torso"
                    break
                if part == "cell":
                    kind = "cell"
                    break
            parts[kind].append(leaf.float())
    # A group with no leaves (the transformer has no torso or cell) is 0.
    device = next(t.device for ts in parts.values() for t in ts)
    return {
        k: global_norm(ts) if ts else torch.zeros((), device=device) for k, ts in parts.items()
    }


def tree_delta_norm(new: dict, old: dict) -> torch.Tensor:
    """Global norm of ``new - old`` over ``{group: {name: tensor}}`` (the
    applied update's magnitude; exactly 0 when a guard skipped it)."""
    return global_norm(
        new[g][n].float() - old[g][n].float() for g in new for n in new[g]
    )


def tree_norm(tree: dict) -> torch.Tensor:
    return global_norm(t for group in tree.values() for t in group.values())


# ------------------------------------------------------ on-device accumulator
def stale_bucket_index(stale: torch.Tensor) -> torch.Tensor:
    """Map per-row staleness (updates of policy lag, any numeric dtype) to a
    bucket index in ``[0, N_STALE_BUCKETS)``: 0 for <=0, else
    ``min(1 + floor(log2(s)), K-1)``."""
    s = stale.float()
    idx = 1 + torch.floor(torch.log2(torch.clamp(s, min=1.0))).long()
    idx = torch.clamp(idx, max=N_STALE_BUCKETS - 1)
    return torch.where(s <= 0.0, 0, idx)


def host_stale_rows(idx: int, vers: Any, n_rows: int) -> np.ndarray:
    """Per-row policy staleness for one dispatch: ``max(0, idx - ver)`` where
    the version is known (>= 0), 0 elsewhere. None or a size mismatch
    degrades to all-fresh rather than misattributing rows."""
    if vers is None:
        return np.zeros(n_rows, np.float32)
    v = np.asarray(vers).reshape(-1)
    if v.size != n_rows:
        return np.zeros(n_rows, np.float32)
    return np.where(
        v >= 0, np.maximum(np.float64(idx) - v, 0.0), 0.0
    ).astype(np.float32)


def init_acc(diag: Mapping[str, Any], device: str | torch.device) -> dict:
    """Zero accumulator on ``device`` matching a ``diag`` dict's channels."""
    f32 = dict(dtype=torch.float32, device=device)
    k = N_STALE_BUCKETS
    return {
        "n-updates": torch.zeros((), **f32),
        "rows-n": torch.zeros((k,), **f32),
        "rows": {n: torch.zeros((k,), **f32) for n in diag["rows"]},
        "scalars": {n: torch.zeros((), **f32) for n in diag["scalars"]},
    }


def accumulate(acc: dict, diag: Mapping[str, Any], stale: torch.Tensor) -> dict:
    """Fold one dispatch's ``diag`` into the accumulator: per-row channels
    add into their staleness bucket (``onehotᵀ @ rows``, no host sync),
    scalars and counts add. ``stale`` is ``(R,)``, aligned with the rows."""
    onehot = F.one_hot(stale_bucket_index(stale), N_STALE_BUCKETS).float()  # (R, K)
    n_up = diag.get("n-updates", 1.0)
    return {
        "n-updates": acc["n-updates"] + n_up,
        "rows-n": acc["rows-n"] + torch.sum(onehot, dim=0),
        "rows": {
            n: acc["rows"][n] + onehot.T @ v.float() for n, v in diag["rows"].items()
        },
        "scalars": {n: acc["scalars"][n] + v.float() for n, v in diag["scalars"].items()},
    }


# ---------------------------------------------------- host-side derived math
def ess_normalized(w_mean: float, w2_mean: float) -> float:
    """Normalized importance-weight effective sample size
    ``E[w]²/E[w²]`` in (0, 1]; 0 on no data."""
    if w2_mean <= _EPS:
        return 0.0
    return min(1.0, (w_mean * w_mean) / w2_mean)


def explained_variance(
    ret_mean: float, ret2_mean: float, err_mean: float, err2_mean: float
) -> float:
    """Value explained-variance ``1 - Var(err)/Var(ret)`` from pooled first
    and second moments (``err = target - value``); degenerate targets
    (Var(ret)=0) score 0."""
    var_ret = max(0.0, ret2_mean - ret_mean * ret_mean)
    var_err = max(0.0, err2_mean - err_mean * err_mean)
    if var_ret <= _EPS:
        return 0.0
    return 1.0 - var_err / var_ret


# Row-channel pairs -> derived metric names. Channels an algo doesn't emit
# simply don't appear (SAC has no "clip"; PPO has no "rho-clip").
_MEAN_CHANNELS = {
    "ent": "entropy",
    "kl": "approx-kl",
    "clip": "clip-frac",
    "rho-clip": "rho-clip-rate",
    "c-clip": "c-clip-rate",
    "adv": "adv-mean",
    "tq": "target-q-mean",
}


def _derive_channels(sums: Mapping[str, float], n_rows: float) -> dict:
    """Derived metrics for one pool (a staleness bucket or the global sum)
    from per-row-mean sums and the pooled row count."""
    if n_rows <= 0:
        return {}
    m = {k: v / n_rows for k, v in sums.items()}
    out = {name: m[ch] for ch, name in _MEAN_CHANNELS.items() if ch in m}
    if "w" in m and "w2" in m:
        out["ess"] = ess_normalized(m["w"], m["w2"])
    if "adv" in m and "adv2" in m:
        out["adv-std"] = math.sqrt(max(0.0, m["adv2"] - m["adv"] ** 2))
    if "tq" in m and "tq2" in m:
        out["target-q-std"] = math.sqrt(max(0.0, m["tq2"] - m["tq"] ** 2))
    if all(ch in m for ch in ("ret", "ret2", "err", "err2")):
        out["explained-variance"] = explained_variance(
            m["ret"], m["ret2"], m["err"], m["err2"]
        )
    return out


def derive(acc: Mapping[str, Any]) -> dict:
    """Turn a host copy of the accumulator (floats and lists of floats) into
    the published document: ``{"n_updates", "global": {...}, "buckets":
    {label: {..., "rows": n}}}`` — global pools every bucket; only nonempty
    buckets appear."""
    n_up = float(acc["n-updates"])
    rows_n = [float(x) for x in acc["rows-n"]]
    sums = {k: [float(x) for x in v] for k, v in acc["rows"].items()}

    glob = _derive_channels({k: sum(v) for k, v in sums.items()}, sum(rows_n))
    if n_up > 0:
        for name, v in acc["scalars"].items():
            glob[name] = float(v) / n_up
        if glob.get("param-norm", 0.0) > _EPS:
            glob["update-ratio"] = glob.get("update-norm", 0.0) / glob["param-norm"]
    buckets = {}
    for b, label in enumerate(STALE_BUCKET_LABELS):
        if rows_n[b] <= 0:
            continue
        d = _derive_channels({k: v[b] for k, v in sums.items()}, rows_n[b])
        d["rows"] = rows_n[b]
        buckets[label] = d
    return {"n_updates": n_up, "global": glob, "buckets": buckets}


def publish(reg, derived: Mapping[str, Any]) -> None:
    """Export one derived document into a MetricsRegistry: global curves as
    ``learner-diag-<name>`` gauges, per-staleness families as
    ``learner-diag-by-stale-<name>`` gauges labeled ``stale_bucket``, and
    approx-KL/ESS additionally as histograms."""
    for name, val in derived["global"].items():
        reg.gauge(GAUGE_PREFIX + name).set(val)
        if name in ("approx-kl", "ess"):
            reg.histogram(GAUGE_PREFIX + name + "-hist").observe(float(val))
    for label, vals in derived["buckets"].items():
        for name, val in vals.items():
            reg.gauge(BUCKET_GAUGE_PREFIX + name, labels={"stale_bucket": label}).set(val)


def learn_record(idx: int, derived: Mapping[str, Any]) -> dict:
    """One ``learn.jsonl`` line: the derived document stamped with the
    update index and wall clock."""
    return {
        "ts": time.time(),
        "idx": int(idx),
        "n_updates": derived["n_updates"],
        **derived["global"],
        "buckets": derived["buckets"],
    }


class DiagAccumulator:
    """Owns the device accumulator: ``add(diag, stale)`` per dispatch (a
    few device ops, no sync), ``drain(idx)`` at the log cadence (the only
    readback: one copy of every sum) returning the derived document and
    resetting the sums. Built only when ``Config.learn_diag`` is on."""

    def __init__(self):
        self._acc: dict | None = None

    def add(self, diag: Mapping[str, Any], stale: torch.Tensor) -> None:
        if self._acc is None:
            self._acc = init_acc(diag, stale.device)
        self._acc = accumulate(self._acc, diag, stale)

    def drain(self, idx: int) -> dict | None:
        """Read back the accumulated sums, derive, reset. Returns None when
        nothing was accumulated since the last drain."""
        acc = self._acc
        if acc is None:
            return None
        rows, scalars = list(acc["rows"]), list(acc["scalars"])
        flat = torch.cat(
            [acc["n-updates"][None], acc["rows-n"], *(acc["rows"][n] for n in rows),
             torch.stack([acc["scalars"][n] for n in scalars]) if scalars
             else acc["rows-n"][:0]]
        ).tolist()
        k = N_STALE_BUCKETS
        host = {
            "n-updates": flat[0],
            "rows-n": flat[1:1 + k],
            "rows": {n: flat[1 + k * (i + 1):1 + k * (i + 2)] for i, n in enumerate(rows)},
            "scalars": dict(zip(scalars, flat[1 + k * (len(rows) + 1):], strict=True)),
        }
        if host["n-updates"] <= 0:
            return None
        self._acc = init_acc(acc, acc["rows-n"].device)
        return derive(host)
