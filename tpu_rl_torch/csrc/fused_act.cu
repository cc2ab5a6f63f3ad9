// Fused act step of the discrete LSTM actor-critic, f32, for sm_90a.
//
// Replaces: tpu_rl/ops/pallas_act.py, _act_kernel (the Pallas TPU kernel
// behind fused_act_step / make_fused_act). It computes, per row of the batch,
//
//   x      = relu(obs @ Wb^T + bb)                      torso
//   z      = (x @ Wx^T + bx) + h @ Wh                   LSTM pre-activations
//   c2     = sig(f) * c + sig(i) * tanh(g)              gates i, f, g, o
//   h2     = sig(o) * tanh(c2)
//   logits = log_softmax(h2 @ Wl^T + bl)                policy head
//
// and writes logits (B,A), h2 (B,H), c2 (B,H). The value head is skipped;
// sampling and the carry reset stay outside, shared with the unfused path.
// Weights are read in the layouts of the port's state_dict, so nothing is
// transposed or packed per call: Wb (H,D), Wx (4H,H) and Wl (A,H) are torch
// Linear weights (out, in); Wh (H,4H) is the recurrent kernel in flax's
// (in, out).
//
// What bounds it on an H100. At the serving width (D=4, H=256, A=2) the
// weights are ~526k floats (2.1 MB). By the card's peaks the act step is
// bound by those bytes at 8 rows (~0.64 us at 3.35 TB/s) and by its
// operations at 256 rows (~269 MFLOP, ~4 us at 67 TFLOP/s f32). Measured on
// the card (lab/b3_lab.py intake), what binds is each SM's intake: a block
// takes its weights at ~7.5 bytes a cycle by tensor-map copies (~10 by
// 16-byte cp.async, whatever the depth of the ring or the number of busy
// SMs), and the head must see all of h2, so one cluster of at most 16
// blocks serves a row tile. At 8 rows each of 16 SMs takes 128 KB: ~17k
// cycles at that rate, about half the kernel's ~17 us; the rest is the
// launch, the side loads and torso before the loop, and the cell, head and
// cluster barrier after it.
//
// The design (ops/fused_act.act_launch_plan chooses every size below):
//
// 1. The hidden units are split across a thread-block cluster. A block owns
//    R rows and U units with all four gates of them (4U columns of z), so
//    the cell update stays in the block. The grid is (cluster = ceil(H/U)
//    unit slices) x (row tiles): at the 8-row bucket 16 SMs work on the
//    serving model (the old design: 1), at 256 rows 64 in clusters of 8
//    (fewer, taller row tiles: less weight traffic in all). Each block
//    recomputes the torso for its rows (R*H*D FMAs, D/(8U) of its LSTM
//    work).
// 2. Weights stream through a ring of shared-memory stages by the Tensor
//    Memory Accelerator: one 3-D tensor-map copy per 32-deep k chunk, Wx as
//    a {k, unit, gate} box (128-byte swizzle, so lanes of neighbouring rows
//    read different banks) and Wh as a {unit, gate, k} box with the same k
//    columns of h beside it; each stage completes on its own mbarrier.
//    Wx and Wh chunks alternate. Nothing is read by a lane H floats from its
//    neighbour's; rows, units and k past the tensors arrive as zeros. The
//    maps are encoded on the host once per (tensor, shape). Shapes whose H
//    is not a multiple of 4 (or unaligned views) take 4-byte cp.async into
//    the same layout. c, obs, bx, Wl and bl come first, as one cp.async
//    group, and the torso runs while the first chunks land.
// 3. Each thread owns one unit, TM rows and all 4 gates (4*TM sums for
//    x @ Wx^T and 4*TM for h @ Wh, in registers) over one of KS slices of
//    every k chunk: no thread walks the 2H-long chain alone. Plain f32 FMAs
//    (no TF32), k ascending within a slice; the KS partial sums are added
//    in slice order through shared memory, then (x Wx^T + bx) + h Wh in the
//    reference's order.
// 4. The policy head is reduced over distributed shared memory: each block
//    writes h2_slice @ Wl_slice^T (R x A) straight into its slot in rank
//    0's shared memory, arrives on the cluster barrier (release) and exits;
//    rank 0 waits (acquire), adds the slots in rank order (the same sum
//    every run) and bl, and takes the max-subtracted log-softmax. Where the
//    slots do not fit (large A with large H), rank 0 pulls the partials from
//    its peers' shared memory instead and a second barrier keeps them alive
//    until it has; at the same plan that costs ~1 us more (remote reads in
//    rank 0's sum, and the barrier; lab/b3_lab.py head). Either way the act
//    step stays one launch, as on the TPU.
//
// Shared-memory attributes (up to 227 KB, clusters above 8 blocks) are set
// once per process; the C entry returns cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "device_once.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 32;  // k per ring stage: one 128-byte row of a staged Wx tile
constexpr int kMaxThreads = 256;
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;       // bytes a block may use on sm_90
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float *obs, *wb, *bb, *wx, *bx, *wh, *wl, *bl, *h, *c;
  float *logits, *h2, *c2;
  int B, D, H, A;
  int rows;    // R, rows per tile
  int units;   // U, hidden units per block
  int ksplit;  // KS, slices of each k chunk
  int stages;  // ring depth, 2..8
  int tma;     // weights by tensor-map copies (H % 4 == 0, 16-byte aligned), else 4-byte cp.async
  int push;    // head partials pushed into rank 0's slots (else rank 0 pulls them)
};

__device__ __forceinline__ float sigmoid_f(float z) { return 1.0f / (1.0f + expf(-z)); }

// relu that lets NaN through, like jnp.maximum / torch.relu.
__device__ __forceinline__ float relu_f(float v) { return v < 0.0f ? 0.0f : v; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n committed groups are pending (n < kMaxStages).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also expects `bytes` of tensor copies on this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One 3-D tile of `map` at coordinates (x, y, z) -> shared, by the copy
// engine, completing on `bar`; elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(float* dst, const CUtensorMap* map, int x, int y, int z,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Offset (floats) of element (row, k) of a staged Wx tile: 128-byte rows
// (row = g*U + j, kChunk floats of k) whose 16-byte pieces are permuted as
// TMA's 128-byte swizzle does (piece ^= row % 8), so that lanes reading one
// float4 each from neighbouring rows hit different banks.
__device__ __forceinline__ int wx_at(int row, int k) {
  return row * kChunk + ((((k >> 2) ^ (row & 7))) << 2) + (k & 3);
}

// Issue k chunk c of the block's weights into ring stage `dst`. Even
// chunks are Wx (chunk c/2 of k; [4][U][kChunk], rows g*U + j, swizzled,
// see wx_at); odd chunks are Wh (chunk c/2 of k; [kChunk][4][U]: k-th row,
// column g*U + j) followed, at dst + 4*U*kChunk, by the same k columns of
// the tile's h ([R][kChunk], swizzled as a Wx tile: wx_at(r, k)). With tma each is one tensor-map copy
// completing on the stage's mbarrier; otherwise 4-byte cp.async, one commit
// group. Units, rows and k past the tensors arrive as zeros.
__device__ __forceinline__ void stage_chunk(const Args& p, const CUtensorMap* wx_map,
                                            const CUtensorMap* wh_map, const CUtensorMap* h_map,
                                            float* dst, uint64_t* bar, int c, int u0, int uval,
                                            int row0, int rows) {
  const int U = p.units, H = p.H, R = p.rows, tid = threadIdx.x, nt = blockDim.x;
  const size_t G = 4 * (size_t)H;
  const bool wx_chunk = (c & 1) == 0;
  const int k0 = (c >> 1) * kChunk;
  float* hdst = dst + 4 * U * kChunk;
  if (p.tma) {
    if (tid == 0) {
      if (wx_chunk) {
        mbar_expect_tx(bar, 4u * kChunk * 4 * U);
        tma_load_3d(dst, wx_map, k0, u0, 0, bar);
      } else {
        mbar_expect_tx(bar, 4u * kChunk * (4 * U + R));
        tma_load_3d(dst, wh_map, u0, 0, k0, bar);
        tma_load_3d(hdst, h_map, k0, row0, 0, bar);
      }
    }
    return;
  }
  if (wx_chunk) {
    for (int i = tid; i < 4 * U * kChunk; i += nt) {
      const int row = i / kChunk, kk = i - row * kChunk;
      const int g = row / U, jj = row - g * U, k = k0 + kk;
      const bool ok = jj < uval && k < H;
      cp_async4(dst + wx_at(row, kk), ok ? p.wx + ((size_t)g * H + u0 + jj) * H + k : p.wx, ok);
    }
  } else {
    for (int i = tid; i < kChunk * 4 * U; i += nt) {
      const int kk = i / (4 * U), col = i - kk * 4 * U;
      const int g = col / U, jj = col - g * U, k = k0 + kk;
      const bool ok = jj < uval && k < H;
      cp_async4(dst + kk * 4 * U + col, ok ? p.wh + (size_t)k * G + (size_t)g * H + u0 + jj : p.wh,
                ok);
    }
    for (int i = tid; i < R * kChunk; i += nt) {
      const int r = i / kChunk, kk = i - r * kChunk, k = k0 + kk;
      const bool ok = r < rows && k < H;
      cp_async4(hdst + wx_at(r, kk), ok ? p.h + (size_t)(row0 + r) * H + k : p.h, ok);
    }
  }
  cp_async_commit();
}

template <int TM>
__global__ void __launch_bounds__(kMaxThreads)
    fused_act_kernel(const Args p, const __grid_constant__ CUtensorMap wx_map,
                     const __grid_constant__ CUtensorMap wh_map,
                     const __grid_constant__ CUtensorMap h_map) {
  extern __shared__ __align__(16) float smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  // Phase 0 of the cluster barrier: every block has started (waited for
  // just before the first access to a peer's shared memory).
  cluster_arrive_relaxed();

  const int R = p.rows, U = p.units, H = p.H, D = p.D, A = p.A, KS = p.ksplit;
  const int nk = (H + kChunk - 1) / kChunk;  // k chunks per matrix
  const int XP = nk * kChunk + 4;            // x tile row (zero past H)
  const int stage = (4 * U + R) * kChunk;    // a Wx tile, or a Wh tile and h's columns
  const int region = max(p.stages * stage, 2 * KS * R * 4 * U);
  const int n_slices = (int)cluster.num_blocks();
  // The ring first, 1024-byte aligned (the swizzle's period; the plan
  // asks for 1 KB of slack).
  float* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023) / 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + region);  // kMaxStages mbarriers
  float* xs = ring + region + 2 * kMaxStages;  // R x XP: x = relu(obs Wb^T + bb)
  float* h2s = xs + R * XP;                    // R x U: this slice of h2
  float* cs = h2s + R * U;            // R x U: this slice of c
  float* bxs = cs + R * U;            // 4U: this slice of bx, gate-major
  float* wls = bxs + 4 * U;           // A x U: this slice of Wl
  float* bls = wls + A * U;           // A
  float* slots = bls + A;             // push: n_slices x R x A (rank 0's are read); pull: R x A
  float* obs_s = slots + (p.push ? n_slices : 1) * R * A;  // R x D

  const int slice = (int)cluster.block_rank();  // == blockIdx.x
  const int u0 = slice * U;
  const int uval = min(U, H - u0);
  const int row0 = blockIdx.y * R;
  const int rows = min(R, p.B - row0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nchunks = 2 * nk;

  // The ring's mbarriers, then every load is started before the torso
  // runs: the side data and the ring's first chunks arrive meanwhile.
  if (p.tma) {
    if (tid < p.stages) mbar_init(&bars[tid]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
  }

  // The tile's c and obs and the slice's bx, Wl and bl: one group of
  // 4-byte cp.async ahead of the weights (rows past B and units past H
  // arrive as zeros).
  for (int i = tid; i < R * U; i += nt) {
    const int r = i / U, jj = i - r * U;
    const bool ok = r < rows && jj < uval;
    cp_async4(cs + i, ok ? p.c + (size_t)(row0 + r) * H + u0 + jj : p.c, ok);
  }
  for (int i = tid; i < 4 * U; i += nt) {
    const int g = i / U, jj = i - g * U;
    cp_async4(bxs + i, p.bx + g * H + u0 + min(jj, uval - 1), jj < uval);
  }
  for (int i = tid; i < A * U; i += nt) {
    const int a = i / U, jj = i - a * U;
    cp_async4(wls + i, p.wl + (size_t)a * H + u0 + min(jj, uval - 1), jj < uval);
  }
  for (int i = tid; i < A; i += nt) cp_async4(bls + i, p.bl + i, true);
  for (int i = tid; i < R * D; i += nt) {
    const int r = i / D;
    cp_async4(obs_s + i, p.obs + (size_t)(row0 + min(r, rows - 1)) * D + (i - r * D), r < rows);
  }
  cp_async_commit();
  // Two chunks of the ring go ahead of the torso; its wb loads queue behind
  // them only, and the rest of the ring follows it.
  const int ahead = min(2, min(p.stages - 1, nchunks));
  for (int s = 0; s < ahead; ++s) {
    stage_chunk(p, &wx_map, &wh_map, &h_map, ring + s * stage, &bars[s], s, u0, uval, row0, rows);
  }
  cp_async_wait_pending(p.tma ? 0 : ahead);  // the side group: the oldest
  __syncthreads();

  // Torso: item (k, group of 8 rows), d ascending from 0, then the bias.
  const int rgroups = (R + 7) / 8;
  for (int i = tid; i < XP * rgroups; i += nt) {
    const int k = i / rgroups, r0 = 8 * (i - k * rgroups);
    if (k >= H) {
      for (int r = r0; r < min(R, r0 + 8); ++r) xs[r * XP + k] = 0.0f;
      continue;
    }
    float acc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] = 0.0f;
    const float* wrow = p.wb + (size_t)k * D;
    for (int d = 0; d < D; ++d) {
      const float w = __ldg(wrow + d);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r0 + r < R) acc[r] = fmaf(obs_s[(r0 + r) * D + d], w, acc[r]);
      }
    }
    const float b = __ldg(p.bb + k);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r0 + r < R) xs[(r0 + r) * XP + k] = relu_f(acc[r] + b);
    }
  }
  for (int s = ahead; s < p.stages - 1 && s < nchunks; ++s) {
    stage_chunk(p, &wx_map, &wh_map, &h_map, ring + s * stage, &bars[s], s, u0, uval, row0, rows);
  }

  // LSTM products: thread (ks, rg, j) owns unit j, rows rg, rg + RG, ..,
  // all four gates, over k in [c*kChunk + ks*kq, +kq) of every chunk c,
  // k < H. (Interleaved rows: lanes of neighbouring rg read rows one XP
  // apart, 4 banks, so their float4 reads of x and h do not conflict.)
  const int RG = R / TM;
  const int j = tid % U, rest = tid / U;
  const int rg = rest % RG, ks = rest / RG;
  const bool active = ks < KS;
  const int kq = kChunk / KS;
  float zx[4][TM], zh[4][TM];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int r = 0; r < TM; ++r) zx[g][r] = zh[g][r] = 0.0f;
  }
  const float* xrow = xs + rg * XP;
  const int rstride = RG * XP;

  for (int c = 0; c < nchunks; ++c) {
    const int sidx = c % p.stages;
    const bool wx_chunk = (c & 1) == 0;
    if (p.tma) {
      mbar_wait(&bars[sidx], (c / p.stages) & 1);
    } else {
      cp_async_wait_pending(min(nchunks, c + p.stages - 1) - (c + 1));
    }
    __syncthreads();  // chunk c has landed for every thread; stage c-1 is free
    const int next = c + p.stages - 1;
    if (next < nchunks) {
      stage_chunk(p, &wx_map, &wh_map, &h_map, ring + (next % p.stages) * stage,
                  &bars[next % p.stages], next, u0, uval, row0, rows);
    }
    if (!active) continue;
    const float* st = ring + sidx * stage;
    const int kb = (c >> 1) * kChunk + ks * kq;
    const int kend = min(kq, H - kb);  // past H the tiles are zeros: skip that work
    if (wx_chunk) {
      for (int q = 0; q < kend; q += 4) {
        float4 w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          w[g] = *reinterpret_cast<const float4*>(st + wx_at(g * U + j, ks * kq + q));
        }
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(xrow + r * rstride + kb + q);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float a = zx[g][r];
            a = fmaf(xv.x, w[g].x, a);
            a = fmaf(xv.y, w[g].y, a);
            a = fmaf(xv.z, w[g].z, a);
            zx[g][r] = fmaf(xv.w, w[g].w, a);
          }
        }
      }
    } else {
      for (int q = 0; q < kend; q += 4) {
        float w[4][4];  // [k][gate]
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int g = 0; g < 4; ++g) w[kk][g] = st[(ks * kq + q + kk) * 4 * U + g * U + j];
        }
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float4 hv =
              *reinterpret_cast<const float4*>(st + 4 * U * kChunk + wx_at(rg + r * RG, ks * kq + q));
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float a = zh[g][r];
            a = fmaf(hv.x, w[0][g], a);
            a = fmaf(hv.y, w[1][g], a);
            a = fmaf(hv.z, w[2][g], a);
            zh[g][r] = fmaf(hv.w, w[3][g], a);
          }
        }
      }
    }
  }
  __syncthreads();  // every thread is done with the ring: reuse it for the partial sums

  // red[m][ks][r][g*U + j], m = 0 for x Wx^T, 1 for h Wh.
  float* red = ring;
  const int rowf = 4 * U;
  if (active) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int at = (ks * R + rg + r * RG) * rowf + g * U + j;
        red[at] = zx[g][r];
        red[KS * R * rowf + at] = zh[g][r];
      }
    }
  }
  __syncthreads();

  // Cell update for (row r, unit jj): the KS slices in order, then
  // (x Wx^T + bx) + h Wh as the reference adds them.
  for (int i = tid; i < R * U; i += nt) {
    const int r = i / U, jj = i - r * U;
    float hn = 0.0f;
    if (jj < uval) {
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int at = r * rowf + g * U + jj;
        float sx = red[at], sh = red[KS * R * rowf + at];
        for (int s = 1; s < KS; ++s) {
          sx += red[s * R * rowf + at];
          sh += red[(KS + s) * R * rowf + at];
        }
        z[g] = (sx + bxs[g * U + jj]) + sh;
      }
      const float cn = sigmoid_f(z[1]) * cs[i] + sigmoid_f(z[0]) * tanhf(z[2]);
      hn = sigmoid_f(z[3]) * tanhf(cn);
      if (r < rows) {
        const size_t o = (size_t)(row0 + r) * H + u0 + jj;
        p.h2[o] = hn;
        p.c2[o] = cn;
      }
    }
    h2s[i] = hn;
  }
  __syncthreads();

  // This slice's share of the logits: warp per (row, action), lanes over
  // the slice's units (j = lane, lane + 32, ...), then a shuffle tree. With
  // push, straight into this slice's slot in rank 0's shared memory.
  cluster_wait_acquire();  // phase 0: every block of the cluster has started
  float* mine = p.push ? cluster.map_shared_rank(slots, 0) + slice * R * A : slots;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  for (int pr = warp; pr < R * A; pr += nw) {
    const int r = pr / A, a = pr - r * A;
    float acc = 0.0f;
    for (int jj = lane; jj < uval; jj += 32) acc = fmaf(h2s[r * U + jj], wls[a * U + jj], acc);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) mine[pr] = acc;
  }
  cluster_arrive_release();  // phase 1: this slice's partial is written
  if (p.push && slice != 0) return;  // nothing reads this block's shared memory
  cluster_wait_acquire();

  // Rank 0: the slices' partials in rank order, then the bias, into the
  // slot-0 entries; then thread r takes row r's max-subtracted log-softmax.
  if (slice == 0) {
    for (int i = tid; i < R * A; i += nt) {
      float v = slots[i];
      for (int s = 1; s < n_slices; ++s) {
        v += p.push ? slots[s * R * A + i] : cluster.map_shared_rank(slots, s)[i];
      }
      slots[i] = v + bls[i % A];
    }
    __syncthreads();
    if (tid < rows) {
      const float* rw = slots + tid * A;
      float m = rw[0];
      for (int a = 1; a < A; ++a) m = fmaxf(m, rw[a]);
      float sum = 0.0f;
      for (int a = 0; a < A; ++a) sum += expf(rw[a] - m);
      const float lse = m + logf(sum);
      float* out = p.logits + (size_t)(row0 + tid) * A;
      for (int a = 0; a < A; ++a) out[a] = rw[a] - lse;
    }
  }
  if (!p.push) {
    cluster_arrive_release();  // phase 2 (pull): rank 0 has read its peers; they may exit
    cluster_wait_acquire();
  }
}

using Kernel = void (*)(const Args, const CUtensorMap, const CUtensorMap, const CUtensorMap);

Kernel kernel_for(int tm) {
  switch (tm) {
    case 4: return fused_act_kernel<4>;
    case 8: return fused_act_kernel<8>;
    default: return nullptr;
  }
}

// Allow up to 227 KB of shared memory and clusters of up to 16 blocks on
// every instance.
cudaError_t set_attributes() {
  for (int tm : {4, 8}) {
    Kernel k = kernel_for(tm);
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Once on each device a launch meets (device_once.cuh).
cudaError_t setup() { return once_per_device<set_attributes>(); }

// cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda).
PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f)
               : nullptr;
  }();
  return fn;
}

// Tensor maps, all 3-D f32 with elements past the tensor read as zeros. A
// map holds an address and a shape only, so it is kept per (pointer, dims,
// box): a tensor updated in place keeps its map, a swapped policy's new
// tensors get new ones.
struct MapEntry {
  const void* ptr;
  cuuint64_t dims[3];
  cuuint32_t box[3];
  CUtensorMap map;
};
MapEntry g_maps[32];
int g_next_map = 0;
std::atomic_flag g_maps_lock = ATOMIC_FLAG_INIT;

bool find_or_encode(CUtensorMap* out, const void* ptr, const cuuint64_t (&dims)[3],
                    const cuuint64_t (&strides)[2], const cuuint32_t (&box)[3], bool swizzle) {
  for (const MapEntry& e : g_maps) {
    if (e.ptr == ptr && e.dims[0] == dims[0] && e.dims[1] == dims[1] && e.dims[2] == dims[2] &&
        e.box[0] == box[0] && e.box[1] == box[1] && e.box[2] == box[2]) {
      *out = e.map;
      return true;
    }
  }
  PFN_cuTensorMapEncodeTiled_v12000 encode = encoder();
  if (encode == nullptr) return false;
  const cuuint32_t ones[3] = {1, 1, 1};
  if (encode(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  MapEntry& e = g_maps[g_next_map];
  e.ptr = ptr;
  for (int i = 0; i < 3; ++i) {
    e.dims[i] = dims[i];
    e.box[i] = box[i];
  }
  e.map = *out;
  g_next_map = (g_next_map + 1) % 32;
  return true;
}

// Dims innermost first, strides in bytes: Wx (4H, H) as [gate][unit][k],
// box {kChunk, U, 4}, swizzled; Wh (H, 4H) as [k][gate][unit], box
// {U, 4, kChunk}; h (B, H) as [1][row][k], box {kChunk, R, 1}, swizzled.
bool weight_maps(CUtensorMap* wx_map, CUtensorMap* wh_map, CUtensorMap* h_map, const void* wx,
                 const void* wh, const void* h, int B, int H, int U, int R) {
  const cuuint64_t hh = (cuuint64_t)H;
  const cuuint32_t k = kChunk, u = (cuuint32_t)U, r = (cuuint32_t)R;
  while (g_maps_lock.test_and_set(std::memory_order_acquire)) {
  }
  const cuuint64_t b = (cuuint64_t)B;
  const bool ok = find_or_encode(wx_map, wx, {hh, hh, 4}, {4 * hh, 4 * hh * hh}, {k, u, 4}, true) &&
                  find_or_encode(wh_map, wh, {hh, 4, hh}, {4 * hh, 16 * hh}, {u, 4, k}, false) &&
                  find_or_encode(h_map, h, {hh, b, 1}, {4 * hh, 4 * hh * b}, {k, r, 1}, true);
  g_maps_lock.clear(std::memory_order_release);
  return ok;
}

cudaLaunchConfig_t make_config(cudaLaunchAttribute* attr, int cluster, int row_tiles, int threads,
                               int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, row_tiles, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Plain C entry, bound with ctypes: every pointer and the stream are void*.
// The launch plan (rows .. push) comes from ops/fused_act.act_launch_plan.
// Returns cudaGetLastError() after the launch (0 = launched); a plan the
// card cannot schedule (cluster too large for its shared memory) comes
// back as the launch's error.
extern "C" int fused_act_launch(const void* obs, const void* wb, const void* bb, const void* wx,
                                const void* bx, const void* wh, const void* wl, const void* bl,
                                const void* h, const void* c, void* logits, void* h2, void* c2,
                                int B, int D, int H, int A, int rows, int units, int cluster,
                                int row_tiles, int tm, int ksplit, int stages, int threads,
                                int smem, int tma, int push, void* stream) {
  Kernel k = kernel_for(tm);
  if (k == nullptr || threads > kMaxThreads || stages < 2 || stages > kMaxStages ||
      smem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = setup();
  if (err != cudaSuccess) return (int)err;
  Args p;
  p.obs = static_cast<const float*>(obs);
  p.wb = static_cast<const float*>(wb);
  p.bb = static_cast<const float*>(bb);
  p.wx = static_cast<const float*>(wx);
  p.bx = static_cast<const float*>(bx);
  p.wh = static_cast<const float*>(wh);
  p.wl = static_cast<const float*>(wl);
  p.bl = static_cast<const float*>(bl);
  p.h = static_cast<const float*>(h);
  p.c = static_cast<const float*>(c);
  p.logits = static_cast<float*>(logits);
  p.h2 = static_cast<float*>(h2);
  p.c2 = static_cast<float*>(c2);
  p.B = B;
  p.D = D;
  p.H = H;
  p.A = A;
  p.rows = rows;
  p.units = units;
  p.ksplit = ksplit;
  p.stages = stages;
  p.tma = tma;
  p.push = push;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      make_config(attr, cluster, row_tiles, threads, smem, static_cast<cudaStream_t>(stream));
  CUtensorMap wx_map = {}, wh_map = {}, h_map = {};  // unread without tma
  if (tma && !weight_maps(&wx_map, &wh_map, &h_map, wx, wh, h, B, H, units, rows)) {
    return (int)cudaErrorInvalidValue;
  }
  err = cudaLaunchKernelEx(&cfg, k, p, wx_map, wh_map, h_map);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of this plan the card can hold at once
// (cudaOccupancyMaxActiveClusters); a negative value is -(CUDA error).
extern "C" int fused_act_max_clusters(int cluster, int tm, int threads, int smem) {
  Kernel k = kernel_for(tm);
  if (k == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t err = setup();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = make_config(attr, cluster, 1, threads, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}
