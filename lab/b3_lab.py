"""On-card measurements behind the fused act kernel's design
(``tpu_rl_torch/csrc/fused_act.cu``, kernel B3). From the repository root,
on a machine with one H100:

    python3 lab/b3_lab.py intake
    python3 lab/b3_lab.py head

``intake``: one block per SM streams 8 KB chunks from global memory into a
ring of shared-memory stages (``b3_intake.cu``) by each copy path the kernel
could use; prints the median cycles per block and the bytes a cycle one SM
takes in, at 16 and 132 blocks, 16 and 64 chunks, rings of 2, 4 and 8
stages. ``head``: the policy head's two reductions at the same launch plan,
partials pushed into rank 0's shared memory or pulled by rank 0, timed in
turns (push, pull, pull, push, push, pull) at the serving model's 8, 32 and
256 rows and the default model's 8. Every line names the card and its power
limit. Builds go to the git-ignored ``tpu_rl_torch/_build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpu_rl_torch.kernels import build  # noqa: E402

HERE = Path(__file__).resolve().parent
MODES = {0: "tensor map, Wx box {32,16,4}", 1: "tensor map, Wh box {16,4,32}",
         2: "bulk 1-D, 8 KB", 3: "bulk 1-D, 8 x 1 KB", 4: "cp.async 16 B",
         5: "Wx box + cp.async 16 B together"}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def device_ms(fn, iters: int = 100, reps: int = 7) -> float:
    """Median device time of one ``fn()``, in ms, of ``iters`` calls queued
    back to back behind a busy-wait (as ``chip_smoke.device_ms``)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(4e7))  # ~20 ms: longer than enqueueing the calls
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def intake(card: str) -> None:
    out_dir = build.BUILD_DIR / "lab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libb3_intake.so"
    src = HERE / "b3_intake.cu"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"nvcc {src}:\n{r.stdout}{r.stderr}")
    run = ctypes.CDLL(str(lib_path)).run
    run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    run.restype = ctypes.c_int

    H = 256
    wx = torch.randn(4 * H, H, device="cuda")
    wh = torch.randn(H, 4 * H, device="cuda")
    flat = torch.randn(132 * 64 * 2048 * 2, device="cuda")  # > L2 at 132 blocks x 64 chunks
    out = torch.zeros(132 * 2, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for blocks in (16, 132):
        for nchunks in (16, 64):
            for stages in (2, 4, 8):
                for mode, name in MODES.items():
                    if mode in (0, 1, 5) and nchunks > 16:
                        continue  # the boxes walk one 256-wide matrix: 16 chunks
                    chunk = 16384 if mode == 5 else 8192
                    for _ in range(3):  # the last of three runs is read
                        err = run(wx.data_ptr(), wh.data_ptr(), flat.data_ptr(), H, mode, blocks,
                                  nchunks, stages, chunk, out.data_ptr(), stream)
                        if err:
                            sys.exit(f"b3_intake mode {mode}: CUDA error {err}")
                    torch.cuda.synchronize()
                    cycles = max(1, statistics.median(out[0:2 * blocks:2].cpu().tolist()))
                    out.zero_()
                    print(f"intake blocks={blocks} chunks={nchunks} stages={stages} {name}: "
                          f"{cycles:.0f} cycles, {nchunks * chunk / cycles:.1f} B/cycle per SM "
                          f"[{card}]", flush=True)


def head(card: str) -> None:
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.models.families import build_family
    from tpu_rl_torch.ops import fused_act as FA

    for B, D, H, A in ((8, 4, 256, 2), (32, 4, 256, 2), (256, 4, 256, 2), (8, 4, 64, 2)):
        cfg = Config.from_dict({"hidden_size": H, "obs_shape": (D,), "action_space": A})
        g = torch.Generator().manual_seed(0)
        actor = build_family(cfg, device="cuda").init_params(g)["actor"]
        for name, t in actor.items():
            if name.endswith(".bias"):
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
        obs, h, c = (torch.randn(s, generator=g).cuda() for s in ((B, D), (B, H), (B, H)))
        inputs = {"obs": obs, **{k: actor[k] for k in FA._WEIGHTS}, "h": h, "c": c}
        want = FA.fused_act_step_plain(actor, obs, h, c)
        plan = FA.act_launch_plan(B, D, H, A)
        if not plan.push:
            continue
        plans = {"push": plan, "pull": dataclasses.replace(plan, push=False)}
        for which, pl in plans.items():
            err = max(float((x - y).abs().max()) for x, y in zip(FA._launch(inputs, pl), want))
            if err > 1e-5:
                sys.exit(f"head {which} at {(B, D, H, A)}: max abs err {err} > 1e-5")
        times = {"push": [], "pull": []}
        for which in ("push", "pull", "pull", "push", "push", "pull"):
            times[which].append(device_ms(lambda pl=plans[which]: FA._launch(inputs, pl)))
        print(f"head rows={B} D={D} H={H} A={A} (R={plan.rows}, U={plan.units}, cluster "
              f"{plan.cluster}): push " + " / ".join(f"{t:.6f}" for t in times["push"])
              + " ms, pull " + " / ".join(f"{t:.6f}" for t in times["pull"]) + f" ms [{card}]",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("intake", "head"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("b3_lab: needs a CUDA card")
    {"intake": intake, "head": head}[args.what](card_line())


if __name__ == "__main__":
    main()
