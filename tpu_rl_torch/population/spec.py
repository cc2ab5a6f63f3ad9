"""Population search-space grammar + deterministic sampling/selection math —
the port's own copy of ``tpu_rl.population.spec`` (stdlib only; the
searchable fields are the port's ``Config``'s).

One string (``Config.pop_spec``/``--pop-spec``) drives the whole PBT plane:
parsed once, validated
at config load, and everything downstream — initial sampling, exploit
mutation, truncation selection — consumes the parsed :class:`PopSpec`,
never the string. Determinism is the point: a population is reproducible
from ``(pop_spec, pop_seed)`` alone, because every random draw derives from
:func:`fold_in` over the pop seed and structural indices (member idx,
generation), never from wall clock or process state.

Grammar (whitespace- or semicolon-separated clauses; commas live INSIDE
clause values, e.g. ``perturb=1.2,0.8``, so they cannot separate clauses)::

    spec      := clause (WS clause)*
    clause    := dim | knob
    dim       := field ":" kind "[" num ("," num)* "]"
    kind      := "log" | "lin" | "choice"
    knob      := "perturb=" num ("," num)*     (exploit mutation factors)
               | "interval=" num ("u" | "s")   (eval cadence: member updates
                                                or wall seconds)
               | "quantile=" num               (truncation fraction, (0,0.5])
               | "k=" int                      (population size, >= 2)
               | "fitness=" metric-name        (leaderboard gauge; default
                                                windowed mean return)

Dimension kinds: ``log[lo,hi]`` samples uniformly in log space (the lr
shape), ``lin[lo,hi]`` uniformly, ``choice[a,b,...]`` from the listed
values. Exploit mutation multiplies log/lin values by a seeded choice of
the perturb factors (clamped back into ``[lo,hi]``) and resamples choice
dims — the standard PBT explore step.

Searchable-field rule (:meth:`PopSpec.check_searchable`, enforced by
``Config.validate``): a dimension must name a numeric ``Config`` field
OUTSIDE ``FINGERPRINT_FIELDS``. The exploit step copies checkpoints across
members, so a mutation must never change the resume fingerprint — a
structural mutation would strand every checkpoint it touches.

Pure stdlib so ``Config.validate()`` can parse-check specs cheaply.
"""

from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass

DIM_KINDS = ("log", "lin", "choice")

# Default fitness gauge: the colocated loop's windowed completed-episode
# mean return (obs plane, PR 7). Distributed members must name their own
# fitness metric in the spec — the controller enforces that at launch.
DEFAULT_FITNESS = "colocated-mean-episode-return"
# Default progress counter for 'u' intervals (absolute update index, so it
# survives member respawns).
DEFAULT_PROGRESS = "colocated-updates"


@dataclass(frozen=True)
class SampleDim:
    """One searchable dimension of the population's hyperparameter space."""

    field: str
    kind: str  # "log" | "lin" | "choice"
    lo: float = 0.0
    hi: float = 0.0
    choices: tuple[float, ...] = ()


@dataclass(frozen=True)
class PopSpec:
    """Parsed ``Config.pop_spec``: the population's search space + schedule."""

    dims: tuple[SampleDim, ...]
    k: int = 4
    perturb: tuple[float, ...] = (1.2, 0.8)
    interval: float = 200.0
    interval_unit: str = "u"  # "u" = member updates, "s" = wall seconds
    quantile: float = 0.25
    fitness: str = ""  # "" = the role default (DEFAULT_FITNESS)

    @classmethod
    def parse(cls, spec: str) -> "PopSpec":
        clauses = [c for c in spec.replace(";", " ").split() if c]
        if not clauses:
            raise ValueError(f"empty pop spec {spec!r}")
        dims: list[SampleDim] = []
        knobs: dict = {}
        for clause in clauses:
            if "[" in clause:
                dims.append(_parse_dim(clause))
            else:
                knobs.update(_parse_knob(clause))
        if not dims:
            raise ValueError(
                f"pop spec {spec!r} has no sampled dimension "
                "(need at least one 'field:log/lin/choice[...]' clause)"
            )
        seen: set[str] = set()
        for d in dims:
            if d.field in seen:
                raise ValueError(
                    f"pop spec {spec!r}: field {d.field!r} sampled twice"
                )
            seen.add(d.field)
        out = cls(dims=tuple(dims), **knobs)
        if out.n_select() * 2 > out.k:
            raise ValueError(
                f"pop spec {spec!r}: quantile {out.quantile} selects "
                f"{out.n_select()} winners AND {out.n_select()} losers from "
                f"k={out.k} members — they would overlap"
            )
        return out

    def n_select(self) -> int:
        """Members truncated (and copied from) per eval: the bottom/top
        ``quantile`` of the population, at least one."""
        return max(1, int(self.k * self.quantile))

    def check_searchable(self) -> None:
        """Raise unless every sampled dimension is a searchable Config
        field (numeric + fingerprint-exempt). Split from :meth:`parse` so
        tests can build specs without importing Config."""
        table = searchable_fields()
        for d in self.dims:
            if d.field not in table:
                raise ValueError(
                    f"pop spec dimension {d.field!r} is not searchable: "
                    "must be a numeric Config field outside "
                    "FINGERPRINT_FIELDS (mutating a structural field would "
                    "strand the checkpoints the exploit step copies); "
                    f"searchable e.g. {sorted(table)[:8]}..."
                )


def _parse_num(clause: str, tok: str, what: str) -> float:
    try:
        return float(tok)
    except ValueError:
        raise ValueError(
            f"pop clause {clause!r}: {what} must be a number, got {tok!r}"
        ) from None


def _parse_dim(clause: str) -> SampleDim:
    head, _, tail = clause.partition(":")
    field = head.strip()
    if not field or not tail:
        raise ValueError(
            f"pop clause {clause!r}: expected 'field:kind[values]'"
        )
    if not tail.endswith("]") or "[" not in tail:
        raise ValueError(
            f"pop clause {clause!r}: expected bracketed values, "
            "e.g. 'lr:log[1e-4,1e-2]'"
        )
    kind, _, inner = tail[:-1].partition("[")
    if kind not in DIM_KINDS:
        raise ValueError(
            f"pop clause {clause!r}: unknown kind {kind!r} "
            f"(one of {list(DIM_KINDS)})"
        )
    vals = [
        _parse_num(clause, v.strip(), "value")
        for v in inner.split(",")
        if v.strip()
    ]
    if kind == "choice":
        if len(vals) < 2:
            raise ValueError(
                f"pop clause {clause!r}: choice needs >= 2 values"
            )
        return SampleDim(field, kind, choices=tuple(vals))
    if len(vals) != 2:
        raise ValueError(
            f"pop clause {clause!r}: {kind} needs exactly [lo,hi]"
        )
    lo, hi = vals
    if not lo < hi:
        raise ValueError(
            f"pop clause {clause!r}: need lo < hi, got [{lo}, {hi}]"
        )
    if kind == "log" and lo <= 0:
        raise ValueError(
            f"pop clause {clause!r}: log sampling needs lo > 0, got {lo}"
        )
    return SampleDim(field, kind, lo=lo, hi=hi)


def _parse_knob(clause: str) -> dict:
    key, eq, val = clause.partition("=")
    if not eq or not val:
        raise ValueError(
            f"pop clause {clause!r}: expected 'key=value' or "
            "'field:kind[values]'"
        )
    if key == "perturb":
        factors = tuple(
            _parse_num(clause, v, "perturb factor") for v in val.split(",")
        )
        if not factors or any(f <= 0 for f in factors):
            raise ValueError(
                f"pop clause {clause!r}: perturb factors must be > 0"
            )
        return {"perturb": factors}
    if key == "interval":
        unit = val[-1]
        if unit not in ("u", "s"):
            raise ValueError(
                f"pop clause {clause!r}: interval needs a unit — "
                "'<n>u' (member updates) or '<n>s' (wall seconds)"
            )
        n = _parse_num(clause, val[:-1], "interval")
        if n <= 0:
            raise ValueError(
                f"pop clause {clause!r}: interval must be > 0, got {n}"
            )
        return {"interval": n, "interval_unit": unit}
    if key == "quantile":
        q = _parse_num(clause, val, "quantile")
        if not 0.0 < q <= 0.5:
            raise ValueError(
                f"pop clause {clause!r}: quantile must be in (0, 0.5] "
                f"(winners and losers must not overlap), got {q}"
            )
        return {"quantile": q}
    if key == "k":
        k = int(_parse_num(clause, val, "k"))
        if k < 2:
            raise ValueError(
                f"pop clause {clause!r}: population needs k >= 2, got {k}"
            )
        return {"k": k}
    if key == "fitness":
        return {"fitness": val}
    raise ValueError(
        f"pop clause {clause!r}: unknown knob {key!r} "
        "(one of perturb, interval, quantile, k, fitness)"
    )


# --------------------------------------------------------------- searchable
def searchable_fields() -> dict[str, type]:
    """Config fields a pop-spec may sample/mutate: numeric (int/float,
    optionally Optional) and OUTSIDE ``FINGERPRINT_FIELDS``. bool fields
    are excluded — a perturb-factor multiply on a flag is meaningless."""
    import dataclasses as dc

    from tpu_rl_torch.config import FINGERPRINT_FIELDS, Config

    out: dict[str, type] = {}
    for f in dc.fields(Config):
        if f.name in FINGERPRINT_FIELDS:
            continue
        # Annotations are strings under `from __future__ import annotations`;
        # accept "float", "int" and their "| None" unions.
        ann = str(f.type).split("|")[0].strip()
        if ann == "float":
            out[f.name] = float
        elif ann == "int":
            out[f.name] = int
    return out


# ------------------------------------------------------------- determinism
def fold_in(seed: int, *data: int) -> int:
    """Deterministic stdlib seed derivation — the ``jax.random.fold_in``
    shape without importing jax into the orchestrator: blake2b over the
    seed and operands, reduced to 63 bits. Feeds ``random.Random`` streams
    for sampling/mutation and the per-member training seeds."""
    h = hashlib.blake2b(digest_size=8)
    for v in (seed, *data):
        h.update(int(v).to_bytes(16, "little", signed=True))
    return int.from_bytes(h.digest(), "little") >> 1


def member_seed(pop_seed: int, idx: int) -> int:
    """Training PRNG seed for member ``idx`` — distinct per member,
    reproducible from the pop seed alone (pinned by test)."""
    return fold_in(pop_seed, idx, 0x5EED) % (2**31)


def _cast(value: float, field: str) -> float | int:
    ftype = searchable_fields().get(field, float)
    return int(round(value)) if ftype is int else float(value)


def _sample_dim(dim: SampleDim, rng: random.Random) -> float:
    if dim.kind == "choice":
        return rng.choice(dim.choices)
    if dim.kind == "log":
        return math.exp(rng.uniform(math.log(dim.lo), math.log(dim.hi)))
    return rng.uniform(dim.lo, dim.hi)


def sample_member(spec: PopSpec, pop_seed: int, idx: int) -> dict:
    """Member ``idx``'s initial hyperparameter draw. Each member gets its
    own derived stream, so the draw is independent of K and of the order
    members are spawned in."""
    rng = random.Random(fold_in(pop_seed, idx, 0x1A17))
    return {d.field: _cast(_sample_dim(d, rng), d.field) for d in spec.dims}


def mutate(
    spec: PopSpec, values: dict, pop_seed: int, idx: int, generation: int
) -> dict:
    """The PBT explore step: perturb the (winner-copied) ``values`` for the
    member ``idx`` being replaced at ``generation``. log/lin dims multiply
    by a seeded choice of the perturb factors, clamped back into [lo, hi];
    choice dims resample. Pure: same inputs, same mutation."""
    rng = random.Random(fold_in(pop_seed, idx, generation, 0xE0))
    out = dict(values)
    for d in spec.dims:
        if d.kind == "choice":
            out[d.field] = _cast(rng.choice(d.choices), d.field)
        else:
            v = float(values[d.field]) * rng.choice(spec.perturb)
            out[d.field] = _cast(min(max(v, d.lo), d.hi), d.field)
    return out


# ---------------------------------------------------------------- selection
def truncation_select(
    fitness: dict[int, float], quantile: float
) -> tuple[list[int], list[int]]:
    """``(losers, winners)`` of one truncation-selection round over the
    members with a fitness reading. Bottom/top ``quantile`` (at least one
    each, shrunk so the sets never overlap), deterministic tie-break on
    member idx. Fewer than two readings: nothing to select."""
    if len(fitness) < 2:
        return [], []
    n = max(1, int(len(fitness) * quantile))
    n = min(n, len(fitness) // 2)
    ranked = sorted(fitness.items(), key=lambda kv: (kv[1], kv[0]))
    losers = [i for i, _ in ranked[:n]]
    winners = [i for i, _ in reversed(ranked[-n:])]  # best first
    return losers, winners
