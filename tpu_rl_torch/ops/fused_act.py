"""Fused act step — the port of ``tpu_rl.ops.pallas_act``.

:func:`fused_act_step` runs torso Dense+relu -> LSTM cell -> logits head ->
log-softmax as ONE hand-written CUDA kernel (``csrc/fused_act.cu``) and
returns ``(log-softmax logits (B,A), h2 (B,H), c2 (B,H))``; the value head
is skipped because the act contract discards it. :func:`make_fused_act`
wraps it into the family's act signature, with sampling and log-prob shared
with the unfused path.

On a CUDA tensor the wrapper launches the kernel or raises. The plain
PyTorch version, :func:`fused_act_step_plain`, is the same math in torch
ops; it is taken only for tensors that lie on the CPU, and it is what the
kernel is held against.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpu_rl_torch import on_card
from tpu_rl_torch.kernels import build
from tpu_rl_torch.models.cells import lstm_gates
from tpu_rl_torch.ops import distributions as D

# Kernel launches made through fused_act_step (plain-version calls excluded).
LAUNCHES = 0

# state_dict keys, in the kernel's argument order.
_WEIGHTS = (
    "body.weight", "body.bias", "cell.x_proj.weight", "cell.x_proj.bias",
    "cell.recurrent_kernel", "logits.weight", "logits.bias",
)


def fused_act_step_plain(actor_params, obs, h, c):
    """The act step in torch ops (the oracle, and the CPU path)."""
    p = actor_params
    x = torch.relu(F.linear(obs, p["body.weight"], p["body.bias"]))
    z = F.linear(x, p["cell.x_proj.weight"], p["cell.x_proj.bias"])
    z = z + h @ p["cell.recurrent_kernel"]
    h2, c2 = lstm_gates(z, c)
    logits = torch.log_softmax(F.linear(h2, p["logits.weight"], p["logits.bias"]), dim=-1)
    return logits, h2, c2


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


def fused_act_step(actor_params, obs, h, c):
    """``actor_params`` is the actor state_dict (``body.weight`` ...). CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if not on_card("fused_act_step", obs):
        return fused_act_step_plain(actor_params, obs, h, c)
    if obs.dim() != 2 or h.dim() != 2 or obs.shape[0] < 1:
        raise ValueError(f"fused_act_step: obs {tuple(obs.shape)}, h {tuple(h.shape)}")
    B, D_ = obs.shape
    H = h.shape[1]
    A = actor_params["logits.weight"].shape[0]
    inputs = {"obs": obs, **{k: actor_params[k] for k in _WEIGHTS}, "h": h, "c": c}
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
    logits = torch.empty((B, A), dtype=torch.float32, device=obs.device)
    h2 = torch.empty((B, H), dtype=torch.float32, device=obs.device)
    c2 = torch.empty((B, H), dtype=torch.float32, device=obs.device)
    # The launch is asynchronous on the current stream: the caching
    # allocator hands an input's memory to later work on that same stream
    # only, which runs after the kernel, so no reference needs holding here.
    # A tile too wide for one block's shared memory comes back as the error
    # of the C entry's cudaFuncSetAttribute.
    err = build.bind(
        "fused_act", [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )(
        *(t.data_ptr() for t in inputs.values()),
        logits.data_ptr(), h2.data_ptr(), c2.data_ptr(),
        B, D_, H, A, torch.cuda.current_stream(obs.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"fused_act kernel launch failed at B={B}, D={D_}, H={H}, A={A}: CUDA error {err}"
        )
    global LAUNCHES
    LAUNCHES += 1
    return logits, h2, c2


def make_fused_act(family):
    """Fused replacement for ``family.act`` with the same signature and
    return contract. Raises for a family the kernel does not cover
    (anything but the discrete LSTM actor-critic), so that the fused path
    is never quietly served by the unfused one."""
    from tpu_rl_torch.models.policies import DiscreteActorCritic

    if not isinstance(family.actor, DiscreteActorCritic):
        raise NotImplementedError(
            f"act_kernel='pallas' for {type(family.actor).__name__}: the fused act "
            "kernel covers the discrete LSTM actor-critic; other families come "
            "with the other-algorithms slice of the port"
        )

    def act(params, obs, h, c, generator=None, gumbel=None):
        logits, h2, c2 = fused_act_step(params["actor"], obs, h, c)
        a = D.categorical_sample(logits, generator, gumbel=gumbel)
        log_prob = D.categorical_log_prob(logits, a)
        return a[..., None].float(), logits, log_prob[..., None], h2, c2

    return act
