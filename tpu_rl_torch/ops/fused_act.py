"""Fused act step — the port of ``tpu_rl.ops.pallas_act``.

:func:`fused_act_step` runs torso Dense+relu -> LSTM cell -> logits head ->
log-softmax as ONE hand-written CUDA kernel (``csrc/fused_act.cu``) and
returns ``(log-softmax logits (B,A), h2 (B,H), c2 (B,H))``; the value head
is skipped because the act contract discards it. :func:`make_fused_act`
wraps it into the family's act signature, with sampling and log-prob shared
with the unfused path.

The kernel splits the hidden units across a thread-block cluster and tiles
the rows; :func:`act_launch_plan` chooses the tile sizes from (B, D, H, A)
in plain Python, so the CPU tests reach it, and refuses with
:class:`ActPlanError` what the card cannot launch.

The kernel entry is the ``torch.library.custom_op``
``tpu_rl_torch::fused_act`` with a FLOP formula registered for
``torch.utils.flop_counter`` (:func:`act_flops`, the plain version's
products): a counter charges each call its formula whether the kernel or
the plain version runs beneath. The wrapper enters the operator only while
a dispatch mode is active (:func:`tpu_rl_torch.counted`); otherwise it
calls the operator's function directly and pays no dispatcher.

On a CUDA tensor the wrapper launches the kernel or raises. The plain
PyTorch version, :func:`fused_act_step_plain`, is the same math in torch
ops; it is taken only for tensors that lie on the CPU, and it is what the
kernel is held against.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from tpu_rl_torch import counted, on_card
from tpu_rl_torch.kernels import build
from tpu_rl_torch.models.cells import lstm_gates
from tpu_rl_torch.ops import distributions as D

# Kernel launches made through fused_act_step (plain-version calls excluded),
# in all, by row count and by device index.
LAUNCHES = 0
LAUNCHES_BY_ROWS: dict[int, int] = {}
LAUNCHES_BY_DEVICE: dict[int, int] = {}

# state_dict keys, in the kernel's argument order.
_WEIGHTS = (
    "body.weight", "body.bias", "cell.x_proj.weight", "cell.x_proj.bias",
    "cell.recurrent_kernel", "logits.weight", "logits.bias",
)
# the weights the kernel reads through tensor maps
_TMA = ("cell.x_proj.weight", "cell.recurrent_kernel")


def fused_act_step_plain(actor_params, obs, h, c):
    """The act step in torch ops (the oracle, and the CPU path)."""
    p = actor_params
    x = torch.relu(F.linear(obs, p["body.weight"], p["body.bias"]))
    z = F.linear(x, p["cell.x_proj.weight"], p["cell.x_proj.bias"])
    z = z + h @ p["cell.recurrent_kernel"]
    h2, c2 = lstm_gates(z, c)
    logits = torch.log_softmax(F.linear(h2, p["logits.weight"], p["logits.bias"]), dim=-1)
    return logits, h2, c2


# The kernel's fixed sizes (csrc/fused_act.cu) and the card's limits.
CHUNK = 32  # k per ring stage
MAX_THREADS = 256
MAX_STAGES = 4
RING_BYTES = 64 * 1024  # the ring keeps at most this much in flight
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
MAX_CLUSTER_PORTABLE, MAX_CLUSTER = 8, 16
# Blocks to aim for. Each SM takes its weights at a fixed rate (~7.5 B a
# cycle by tensor-map copies on the H100), so fewer, taller row tiles (less
# weight traffic in all) beat a full wave of short ones.
TARGET_BLOCKS = 64
MIN_UNITS = 8  # units per block before the split stops adding blocks


class ActPlanError(ValueError):
    """The fused act kernel cannot launch at this shape."""


@dataclass(frozen=True)
class ActPlan:
    """One launch of ``csrc/fused_act.cu``: ``cluster`` blocks (one per unit
    slice of ``units`` hidden units) for each of ``row_tiles`` tiles of
    ``rows`` rows; a block has ``threads`` threads, each owning ``tm`` rows
    of one unit over one of ``ksplit`` slices of every k chunk, a ring of
    ``stages`` chunks and ``smem`` bytes of shared memory. ``tma``: the
    weights come by tensor-map copies (H % 4 == 0), else by 4-byte copies;
    ``push``: the slices push their share of the logits into rank 0's
    shared memory, else rank 0 pulls them."""

    rows: int
    units: int
    cluster: int
    row_tiles: int
    tm: int
    ksplit: int
    stages: int
    threads: int
    smem: int
    tma: bool
    push: bool

    @property
    def nonportable(self) -> bool:
        """A cluster above 8 blocks needs the non-portable size attribute."""
        return self.cluster > MAX_CLUSTER_PORTABLE

    @property
    def blocks(self) -> int:
        return self.cluster * self.row_tiles

    def slices(self, H: int) -> list[range]:
        """The hidden units of each cluster rank."""
        return [range(u0, min(H, u0 + self.units)) for u0 in range(0, H, self.units)]


def smem_floats(rows: int, units: int, ksplit: int, stages: int, D: int, H: int, A: int,
                slots: int) -> int:
    """Shared memory of one block, in floats, in the kernel's layout: 1 KB
    of slack to align the ring, the ring (a stage holds a Wx tile, or a Wh
    tile and h's columns; reused for the ksplit partial sums), its
    mbarriers, the x tile, the slice's h2 and c, bx, Wl and bl, ``slots``
    R x A slots for the head's partials, the obs tile."""
    xp = -(-H // CHUNK) * CHUNK + 4
    region = max(stages * (4 * units + rows) * CHUNK, 2 * ksplit * rows * 4 * units)
    return (256 + region + 2 * MAX_STAGES + rows * xp + 2 * rows * units + 4 * units
            + A * units + A + slots * rows * A + rows * D)


def _plan(B: int, D: int, H: int, A: int, tma: bool, cluster: int) -> ActPlan | None:
    """The plan with at most ``cluster`` unit slices, or None if no row
    tile fits."""
    units = -(-H // cluster)
    if tma:
        units = -(-units // 4) * 4
    cluster = -(-H // units)
    tiles_target = max(1, TARGET_BLOCKS // cluster)
    rows = 8
    while rows < 32 and rows * tiles_target < B:
        rows *= 2
    while rows >= 8:
        tm = 8 if rows >= 16 or units * 2 > MAX_THREADS else 4
        rg = rows // tm
        row_tiles = -(-B // rows)
        if units * rg <= MAX_THREADS and row_tiles <= 65535:
            ksplit = 1
            while ksplit < 8 and units * rg * ksplit * 2 <= MAX_THREADS:
                ksplit *= 2
            for push in (True, False):
                slots = cluster if push else 1
                stage = (4 * units + rows) * CHUNK
                room = SMEM_LIMIT // 4 - smem_floats(rows, units, 0, 0, D, H, A, slots)
                stages = max(2, min(MAX_STAGES, 2 * -(-H // CHUNK), room // stage,
                                    RING_BYTES // (4 * stage)))
                smem = 4 * smem_floats(rows, units, ksplit, stages, D, H, A, slots)
                if smem <= SMEM_LIMIT:
                    return ActPlan(
                        rows=rows, units=units, cluster=cluster, row_tiles=row_tiles, tm=tm,
                        ksplit=ksplit, stages=stages,
                        threads=-(-units * rg * ksplit // 32) * 32, smem=smem, tma=tma,
                        push=push,
                    )
        rows //= 2
    return None


@functools.lru_cache(maxsize=256)
def act_launch_plan(B: int, D: int, H: int, A: int) -> ActPlan:
    """The launch plan for a fused act step of B rows, obs width D, H hidden
    units and A actions. Units are split into at most 16 slices (8 above
    32 rows, where that fits) of at least 8 units, a multiple of 4 where H
    is (16-byte copies); rows into tiles of 8, 16 or 32, the smallest that
    fills about one wave of SMs, cut until the block fits 256 threads and
    227 KB (pushed head partials first, pulled ones if those do not fit).
    Raises :class:`ActPlanError` for what cannot launch."""
    for name, v in (("B", B), ("D", D), ("H", H), ("A", A)):
        if not isinstance(v, int) or v < 1:
            raise ActPlanError(f"act_launch_plan: {name}={v!r} must be a positive int")
    tma = H % 4 == 0
    # Above 32 rows there are row tiles enough to fill the card, and
    # clusters of 8 schedule more densely than clusters of 16 (where a
    # block of 8 units' slices still fits).
    for cap in ((MAX_CLUSTER_PORTABLE, MAX_CLUSTER) if B > 32 else (MAX_CLUSTER,)):
        plan = _plan(B, D, H, A, tma, min(cap, -(-H // MIN_UNITS)))
        if plan is not None:
            return plan
    raise ActPlanError(
        f"fused act kernel cannot launch at B={B}, D={D}, H={H}, A={A}: a block of "
        f"{-(-H // MAX_CLUSTER)} units and 8 rows needs more than {SMEM_LIMIT} bytes of "
        f"shared memory or {MAX_THREADS} threads"
    )


def _expected_shapes(B: int, D_: int, H: int, A: int) -> dict[str, tuple[int, ...]]:
    """Inputs in the argument order of ``fused_act_launch``."""
    return {
        "obs": (B, D_),
        "body.weight": (H, D_), "body.bias": (H,),
        "cell.x_proj.weight": (4 * H, H), "cell.x_proj.bias": (4 * H,),
        "cell.recurrent_kernel": (H, 4 * H),
        "logits.weight": (A, H), "logits.bias": (A,),
        "h": (B, H), "c": (B, H),
    }


def act_flops(B: int, D: int, H: int, A: int) -> int:
    """FLOPs of one fused act step of B rows: the torso (D·H), the input and
    recurrent projections (8H²) and the logits head (H·A), 2·B·(D·H + 8H² +
    H·A)."""
    return 2 * B * (D * H + 8 * H * H + H * A)


def fused_act_step(actor_params, obs, h, c):
    """``actor_params`` is the actor state_dict (``body.weight`` ...). CPU
    tensors take the plain version; CUDA tensors launch the kernel. Under a
    FLOP counter it runs as the operator ``tpu_rl_torch::fused_act``; a
    tensor on another device is refused first."""
    on_card("fused_act_step", obs)
    args = (obs, *(actor_params[k] for k in _WEIGHTS), h, c)
    return (_fused_act_op if counted() else _fused_act)(*args)


def _fused_act(
    obs: Tensor, body_w: Tensor, body_b: Tensor, x_w: Tensor, x_b: Tensor, wh: Tensor,
    logits_w: Tensor, logits_b: Tensor, h: Tensor, c: Tensor,
) -> tuple[Tensor, Tensor, Tensor]:
    weights = dict(zip(_WEIGHTS, (body_w, body_b, x_w, x_b, wh, logits_w, logits_b), strict=True))
    if not on_card("fused_act_step", obs):
        return fused_act_step_plain(weights, obs, h, c)
    if obs.dim() != 2 or h.dim() != 2 or obs.shape[0] < 1:
        raise ValueError(f"fused_act_step: obs {tuple(obs.shape)}, h {tuple(h.shape)}")
    B, D_ = obs.shape
    H = h.shape[1]
    A = logits_w.shape[0]
    inputs = {"obs": obs, **weights, "h": h, "c": c}
    for name, want in _expected_shapes(B, D_, H, A).items():
        t = inputs[name]
        if t.device != obs.device:
            raise ValueError(f"fused_act_step: {name} on {t.device}, obs on {obs.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_act_step: {name} is {t.dtype}, the kernel takes float32")
        if tuple(t.shape) != want:
            raise ValueError(f"fused_act_step: {name} has shape {tuple(t.shape)}, want {want}")
        if not t.is_contiguous():
            raise ValueError(f"fused_act_step: {name} is not contiguous")
    out = _launch(inputs, act_launch_plan(B, D_, H, A))
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_ROWS[B] = LAUNCHES_BY_ROWS.get(B, 0) + 1
    LAUNCHES_BY_DEVICE[obs.device.index] = LAUNCHES_BY_DEVICE.get(obs.device.index, 0) + 1
    return out


_fused_act_op = torch.library.custom_op("tpu_rl_torch::fused_act", _fused_act, mutates_args=())


@register_flop_formula(torch.ops.tpu_rl_torch.fused_act)
def _fused_act_flops(obs_shape, body_w_shape, *_shapes, out_shape=None) -> int:
    B, D_ = obs_shape
    H = body_w_shape[0]
    A = out_shape[0][1]  # logits (B, A)
    return act_flops(B, D_, H, A)


def _launch(inputs: dict, plan: ActPlan):
    """One launch of the kernel with ``plan`` on inputs ``fused_act_step``
    has checked (its dict, in the C entry's order); returns (logits, h2,
    c2). Counts nothing."""
    obs, h = inputs["obs"], inputs["h"]
    B, D_ = obs.shape
    H = h.shape[1]
    A = inputs["logits.weight"].shape[0]
    logits = torch.empty((B, A), dtype=torch.float32, device=obs.device)
    h2 = torch.empty((B, H), dtype=torch.float32, device=obs.device)
    c2 = torch.empty((B, H), dtype=torch.float32, device=obs.device)
    # Tensor maps need 16-byte aligned tensors; a view at an odd offset
    # takes the 4-byte copies.
    tma = plan.tma and all(inputs[k].data_ptr() % 16 == 0 for k in (*_TMA, "h"))
    # The launch is asynchronous on the current stream: the caching
    # allocator hands an input's memory to later work on that same stream
    # only, which runs after the kernel, so no reference needs holding here.
    # The C entry launches on (and sets the kernel's attributes for) the
    # current device, which on_card has checked is the tensors'.
    err = build.bind(
        "fused_act", [ctypes.c_void_p] * 13 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    )(
        *(t.data_ptr() for t in inputs.values()),
        logits.data_ptr(), h2.data_ptr(), c2.data_ptr(),
        B, D_, H, A, plan.rows, plan.units, plan.cluster, plan.row_tiles, plan.tm,
        plan.ksplit, plan.stages, plan.threads, plan.smem, int(tma), int(plan.push),
        torch.cuda.current_stream(obs.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"fused_act kernel launch failed at B={B}, D={D_}, H={H}, A={A} with {plan}: "
            f"CUDA error {err}"
        )
    return logits, h2, c2


def max_active_clusters(plan: ActPlan) -> int:
    """How many clusters of ``plan`` the current card holds at once
    (``cudaOccupancyMaxActiveClusters``); 0 means the launch would be
    refused. Card only."""
    n = build.bind(
        "fused_act", [ctypes.c_int] * 4, entry="fused_act_max_clusters"
    )(plan.cluster, plan.tm, plan.threads, plan.smem)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters for {plan}: CUDA error {-n}")
    return n


def make_fused_act(family):
    """Fused replacement for ``family.act`` with the same signature and
    return contract. Raises for a family the kernel does not cover
    (anything but the f32 discrete LSTM actor-critic), so that the fused
    path is never quietly served by the unfused one."""
    from tpu_rl_torch.models.policies import DiscreteActorCritic

    if not isinstance(family.actor, DiscreteActorCritic):
        raise NotImplementedError(
            f"act_kernel='pallas' for {type(family.actor).__name__}: the fused act "
            "kernel covers only the discrete actor-critic (DiscreteActorCritic), "
            "as in tpu_rl"
        )
    if family.actor.dtype is not None:
        # tpu_rl serves a bf16-compute LSTM through family.act here; the port
        # refuses rather than let act_kernel="pallas" be served unfused.
        raise NotImplementedError(
            "act_kernel='pallas' with compute_dtype='bfloat16': the fused act kernel "
            "computes in f32 only, and tpu_rl serves a bf16-compute LSTM unfused "
            "(family.act); use act_kernel='xla'"
        )

    def act(params, obs, h, c, generator=None, gumbel=None):
        logits, h2, c2 = fused_act_step(params["actor"], obs, h, c)
        a = D.categorical_sample(logits, generator, gumbel=gumbel)
        log_prob = D.categorical_log_prob(logits, a)
        return a[..., None].float(), logits, log_prob[..., None], h2, c2

    return act
