"""LSTM sequence unroll — the port of ``tpu_rl.ops.pallas_lstm``.

:func:`lstm_unroll` runs the S-step recurrence over a precomputed input
projection with a per-row, per-step carry-keep mask (``h, c *= keep[t]``
before step t; gates i, f, g, o). Under autograd it is one
``torch.autograd.Function`` whose forward launches kernel B1
(``csrc/lstm_fwd.cu``, the counterpart of ``_pallas_forward``) and saves the
gate activations, and whose backward launches kernel B2
(``csrc/lstm_bwd.cu``, the counterpart of ``_pallas_backward``) for
``dxp, dh0, dc0``. The recurrent-weight gradient
``dwh = sum_t (h_prev[t]·keep[t])ᵀ dxp[t]`` is one plain product over
batch × time outside the kernel, as ``tpu_rl`` leaves it outside its own.

Layouts are batch-major, as at ``tpu_rl``'s public functions: xp (B,S,4H),
wh (H,4H), h0/c0 (B,H), keep (B,S); hs/cs (B,S,H), acts (B,S,4H).

On a CUDA tensor the unroll always launches B1, and B2 under backward: there
is no dispatch gate. ``tpu_rl``'s gate (whole batch in one VMEM tile;
forward-only calls scan) was measured on a TPU and is not carried over;
re-deriving a gate for this card waits for a benchmark cell that can show
it end to end. The plain versions, :func:`lstm_forward_plain` and
:func:`lstm_backward_plain`, are the same math as Python loops over time;
they are taken only for tensors that lie on the CPU, and they are what the
kernels are held against.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches made through lstm_fwd / lstm_bwd (plain-version calls
# excluded).
LSTM_FWD_LAUNCHES = 0
LSTM_BWD_LAUNCHES = 0


# ------------------------------------------------------------ plain versions
def lstm_forward_plain(xp, wh, h0, c0, keep):
    """``_scan_forward``'s step math as a loop over time.
    Returns ``(hs, cs, acts)``; ``acts`` holds the post-activation gates
    ``[i, f, g, o]`` of every step."""
    S = xp.shape[1]
    H = wh.shape[0]
    h, c = h0, c0
    hs, cs, acts = [], [], []
    for t in range(S):
        kp = keep[:, t, None]
        h = h * kp
        c = c * kp
        z = xp[:, t] + h @ wh
        i = torch.sigmoid(z[:, :H])
        f = torch.sigmoid(z[:, H : 2 * H])
        g = torch.tanh(z[:, 2 * H : 3 * H])
        o = torch.sigmoid(z[:, 3 * H :])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
        acts.append(torch.cat([i, f, g, o], dim=-1))
    return torch.stack(hs, 1), torch.stack(cs, 1), torch.stack(acts, 1)


def lstm_backward_plain(wh, h0, c0, keep, hs, cs, acts, dhs, dcs):
    """The reverse loop of ``pallas_lstm._bwd``: analytic LSTM backprop from
    the saved gate activations and cell states. Returns
    ``(dxp, dwh, dh0, dc0)``."""
    S = hs.shape[1]
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
    c_prev = torch.cat([c0[:, None], cs[:, :-1]], dim=1)
    dh = torch.zeros_like(h0)
    dc = torch.zeros_like(c0)
    dwh = torch.zeros_like(wh)
    dzs = [None] * S
    for t in reversed(range(S)):
        kp = keep[:, t, None]
        i, f, g, o = torch.chunk(acts[:, t], 4, dim=-1)
        hp_used = h_prev[:, t] * kp
        cp_used = c_prev[:, t] * kp
        dh_t = dhs[:, t] + dh
        t_c2 = torch.tanh(cs[:, t])
        do = dh_t * t_c2
        dc_t = dcs[:, t] + dc + dh_t * o * (1.0 - t_c2 * t_c2)
        di = dc_t * g
        dg = dc_t * i
        df = dc_t * cp_used
        dz = torch.cat(
            [di * i * (1.0 - i), df * f * (1.0 - f), dg * (1.0 - g * g), do * o * (1.0 - o)],
            dim=-1,
        )
        dwh = dwh + hp_used.T @ dz
        dh = (dz @ wh.T) * kp
        dc = dc_t * f * kp
        dzs[t] = dz
    return torch.stack(dzs, 1), dwh, dh, dc


# ------------------------------------------------------------------ binding
_LIBS: dict[str, ctypes.CDLL] = {}


def _bind(name: str, n_ptrs: int) -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signature set:
    ``n_ptrs`` pointers, then B, S, H, then the stream."""
    lib = _LIBS.get(name)
    if lib is None:
        from tpu_rl_torch.kernels import build

        lib = build.load(name)
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _check(fn: str, device: torch.device, tensors: dict, shapes: dict) -> None:
    """Device, dtype, shape and contiguity of every kernel input."""
    for name, t in tensors.items():
        want = shapes[name]
        if t.device != device:
            raise ValueError(f"{fn}: {name} on {t.device}, the others on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} is {t.dtype}, the kernel takes float32")
        if tuple(t.shape) != want:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, want {want}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
    # The C entry launches on the calling thread's current device.
    if device.index != torch.cuda.current_device():
        raise ValueError(
            f"{fn}: tensors on {device}, current device is cuda:{torch.cuda.current_device()}"
        )


def _device(fn: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {t.device}")
    return True


# ----------------------------------------------------------------- wrappers
def lstm_fwd(xp, wh, h0, c0, keep):
    """Kernel B1: ``(hs, cs, acts)``. CPU tensors take
    :func:`lstm_forward_plain`; CUDA tensors launch the kernel."""
    if not _device("lstm_fwd", xp):
        return lstm_forward_plain(xp, wh, h0, c0, keep)
    if xp.dim() != 3 or xp.shape[0] < 1 or xp.shape[1] < 1:
        raise ValueError(f"lstm_fwd: xp {tuple(xp.shape)}")
    B, S, G = xp.shape
    H = wh.shape[0]
    _check(
        "lstm_fwd", xp.device,
        {"xp": xp, "wh": wh, "h0": h0, "c0": c0, "keep": keep},
        {"xp": (B, S, 4 * H), "wh": (H, 4 * H), "h0": (B, H), "c0": (B, H), "keep": (B, S)},
    )
    lib = _bind("lstm_fwd", 8)
    hs = torch.empty((B, S, H), dtype=torch.float32, device=xp.device)
    cs = torch.empty_like(hs)
    acts = torch.empty((B, S, G), dtype=torch.float32, device=xp.device)
    # Asynchronous on the current stream; the caching allocator hands an
    # input's memory to later work on that stream only, after the kernel.
    err = lib.lstm_fwd_launch(
        xp.data_ptr(), wh.data_ptr(), h0.data_ptr(), c0.data_ptr(), keep.data_ptr(),
        hs.data_ptr(), cs.data_ptr(), acts.data_ptr(),
        B, S, H, torch.cuda.current_stream(xp.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"lstm_fwd kernel launch failed at B={B}, S={S}, H={H}: CUDA error {err}")
    global LSTM_FWD_LAUNCHES
    LSTM_FWD_LAUNCHES += 1
    return hs, cs, acts


def lstm_bwd(wh, h0, c0, keep, hs, cs, acts, dhs, dcs):
    """Kernel B2: ``(dxp, dh0, dc0)`` from the forward's saved ``cs`` and
    ``acts`` and the output cotangents ``dhs``, ``dcs``. CPU tensors take
    :func:`lstm_backward_plain`; CUDA tensors launch the kernel, which reads
    ``whᵀ`` (4H, H), transposed here once per call so that neighbouring
    threads read neighbouring addresses."""
    if not _device("lstm_bwd", acts):
        dxp, _dwh, dh0, dc0 = lstm_backward_plain(wh, h0, c0, keep, hs, cs, acts, dhs, dcs)
        return dxp, dh0, dc0
    B, S, H = cs.shape
    G = 4 * H
    wh_t = wh.t().contiguous()
    _check(
        "lstm_bwd", acts.device,
        {"acts": acts, "cs": cs, "c0": c0, "keep": keep, "dhs": dhs, "dcs": dcs, "wh_t": wh_t},
        {"acts": (B, S, G), "cs": (B, S, H), "c0": (B, H), "keep": (B, S),
         "dhs": (B, S, H), "dcs": (B, S, H), "wh_t": (G, H)},
    )
    lib = _bind("lstm_bwd", 10)
    dxp = torch.empty((B, S, G), dtype=torch.float32, device=acts.device)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=acts.device)
    dc0 = torch.empty_like(dh0)
    err = lib.lstm_bwd_launch(
        acts.data_ptr(), cs.data_ptr(), c0.data_ptr(), keep.data_ptr(), dhs.data_ptr(),
        dcs.data_ptr(), wh_t.data_ptr(), dxp.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
        B, S, H, torch.cuda.current_stream(acts.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"lstm_bwd kernel launch failed at B={B}, S={S}, H={H}: CUDA error {err}")
    global LSTM_BWD_LAUNCHES
    LSTM_BWD_LAUNCHES += 1
    return dxp, dh0, dc0


# ------------------------------------------------------------ autograd
class _LSTMUnroll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, wh, h0, c0, keep):
        hs, cs, acts = lstm_fwd(xp, wh, h0, c0, keep)
        ctx.save_for_backward(wh, h0, c0, keep, hs, cs, acts)
        return hs, cs

    @staticmethod
    def backward(ctx, dhs, dcs):
        # Grads are materialized (the default), so an unused output's
        # cotangent arrives as zeros, never None.
        wh, h0, c0, keep, hs, cs, acts = ctx.saved_tensors
        dxp, dh0, dc0 = lstm_bwd(
            wh, h0, c0, keep, hs, cs, acts, dhs.contiguous(), dcs.contiguous()
        )
        B, S, H = hs.shape
        h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1) * keep[..., None]
        dwh = h_prev.reshape(B * S, H).t() @ dxp.reshape(B * S, 4 * H)
        return dxp, dwh, dh0, dc0, None


def lstm_unroll(xp, wh, h0, c0, keep):
    """The LSTM over a sequence: ``(hs, cs)``, each (B,S,H). Differentiable
    in xp, wh, h0 and c0 (not keep)."""
    return _LSTMUnroll.apply(xp, wh, h0, c0, keep)
