// LSTM sequence unroll, forward (kernel B1), f32, for sm_90a.
//
// Replaces: tpu_rl/ops/pallas_lstm.py, _pallas_forward (Pallas body
// _make_kernel). For every batch row b and step t = 0..S-1:
//
//   h, c  *= keep[b, t]                          episode-first carry reset
//   z      = xp[b, t] + h @ wh                   xp (B,S,4H), wh (H,4H)
//   i, f, o = sigmoid(z_i, z_f, z_o); g = tanh(z_g)
//   c      = f * c + i * g;  h = o * tanh(c)
//
// and writes hs[b, t] = h, cs[b, t] = c (B,S,H) and the gate activations
// acts[b, t] = [i, f, g, o] (B,S,4H) that the backward (lstm_bwd.cu) reads
// instead of recomputing them. keep is a 0/1 carry mask.
//
// What bounds it on an H100. At the training shape (B=128, S=5, H=64) it
// moves ~1.77 MB (~0.53 us at 3.35 TB/s) and does 21 MFLOP (~0.31 us at
// the 67 TFLOP/s f32 peak): bound by bytes, and in practice by the S steps'
// latency, each of which needs all of the previous step's h. At B=1024,
// S=16, H=1024 it is 137 GFLOP, ~2.05 ms: bound by operations, and wh
// (16 MiB) is read by every row tile at every step.
//
// The design (ops/lstm.lstm_launch_plan chooses every size; lstm_common.cuh
// holds the shared pieces):
//
// 1. A row tile of R rows is one thread-block cluster of C blocks; block q
//    owns U hidden units with all four gate columns of each, so its gate
//    nonlinearities and c/h update are local (its c stays in registers in
//    the resident regime, below). The grid is C x ceil(B/R) blocks, rows being
//    independent (more than one wave of clusters where B needs it). One
//    launch per call.
// 2. Regime "resident": the block's slice of wh (H x 4U floats) is loaded
//    into shared memory once and serves all S steps. The whole tile's h
//    lives in shared memory, double-buffered by step parity; after a step
//    each block pushes its R x U slice of the new h, keep[t+1] applied, into
//    every peer's next buffer over distributed shared memory, and one
//    cluster barrier (arrive.release / wait.acquire) separates the steps.
//    No global round trip, no grid-wide sync.
//    Register tiles: a thread owns TM rows x TU units x 4 gates and runs
//    one plain f32 FMA chain per output, k ascending.
// 3. Regime "streamed" (wh's slice does not fit, e.g. H=1024): at every step
//    the slice streams through a ring of shared-memory stages in 16-deep k
//    chunks by 16-byte cp.async, beside the same k of the tile's h, read
//    from L2 (the step before's hs, written by the cluster's blocks before
//    the barrier, or h0); keep[t] multiplies the product (equal to masking
//    h, keep being 0 or 1). cp.async and not tensor-map copies: one SM takes
//    in 9.3-11.5 B/cycle by 16-byte cp.async and 7.0-7.8 by tensor maps
//    (lab/b3_lab.py intake). The product runs on the tensor cores in split
//    precision (lstm_common.cuh: each operand split into TF32 hi and lo
//    parts; hi*hi by a TF32 mma, the cross terms by one BF16 mma), ~2^-18
//    relative per product. Plain f32 FMAs on the CUDA cores, at this
//    block's 80 x 512 tile, were slower than cuBLAS's per-step products;
//    one TF32 product (2^-11) breaks the 1e-5 bar; three TF32 mmas a
//    product (3xTF32) were slower than two.
//    Warp w owns 8 units with all four gates (one n-tile of 8 columns a
//    gate) for all R rows (R/16 m-tiles); its products go through shared
//    memory to the gates. (Warps of 16 units, at 255 registers, were no
//    faster at the wide shape and slower at (8,5,1024).)

#include "lstm_common.cuh"

namespace lstm {
namespace {

struct FwdArgs {
  const float *xp, *wh, *h0, *c0, *keep;
  float *hs, *cs, *acts;
  Plan p;
};

// ------------------------------------------------------- resident regime
template <int TM, int TU>
__global__ void __launch_bounds__(kResidentThreads, 1) lstm_fwd_resident(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // phase 0: this block has started (waited for before the first push)

  const Plan& p = a.p;
  const int U = p.U, H = p.H, R = p.R, S = p.S;
  const size_t G = 4 * (size_t)H;
  const int C = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int u0 = q * U, uval = min(U, H - u0);
  const int row0 = blockIdx.y * R, rows = min(R, p.B - row0);
  const int KX = U / TU;
  const int x = threadIdx.x % KX, ry = threadIdx.x / KX;
  const int LDR = round4(R);
  const int LDW = 4 * U + 1;

  float* ws = smem;                      // H x LDW: the slice
  float* hbuf = smem + round4(H * LDW);  // 2 x H x LDR, [k][r]: the tile's h

  load_slice(ws, a.wh, H, U, u0, uval);
  // h0 * keep[:, 0], the whole tile, into buffer 0
  for (int i = threadIdx.x; i < R * H; i += blockDim.x) {
    const int r = i / H, k = i - r * H;
    float v = 0.0f;
    if (r < rows) {
      const size_t b = row0 + r;
      v = a.h0[b * H + k] * a.keep[b * S];
    }
    hbuf[k * LDR + r] = v;
  }
  cp_async_wait_pending(0);
  __syncthreads();

  // The thread's carry c, unmasked (keep[t] is applied as step t uses it).
  float c[TM][TU];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TU; ++j) {
      const int r = ry * TM + i, u = x * TU + j;
      c[i][j] = (r < rows && u < uval) ? a.c0[(size_t)(row0 + r) * H + u0 + u] : 0.0f;
    }
  }

  for (int t = 0; t < S; ++t) {
    float acc[4][TM][TU];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TU; ++j) acc[g][i][j] = 0.0f;
      }
    }
    fwd_fma<TM, TU>(acc, hbuf + (t & 1) * H * LDR, LDR, ws, LDW, U, ry, x, H);

    // Gates and the new carry, in registers.
    float hn[TM][TU], kn[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ry * TM + i;
      const bool rv = r < rows;
      const size_t b = row0 + r;
      const float kp = rv ? a.keep[b * S + t] : 0.0f;
      kn[i] = rv && t + 1 < S ? a.keep[b * S + t + 1] : 0.0f;
#pragma unroll
      for (int j = 0; j < TU; ++j) {
        const int u = x * TU + j;
        hn[i][j] = 0.0f;
        if (!rv || u >= uval) continue;
        const size_t bt = b * S + t;
        const float* xr = a.xp + bt * G + u0 + u;
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g] = xr[(size_t)g * H] + acc[g][i][j];
        const float ig = sigmoid_f(z[0]), fg = sigmoid_f(z[1]), gg = tanhf(z[2]),
                    og = sigmoid_f(z[3]);
        const float c2 = fg * (c[i][j] * kp) + ig * gg;
        const float h2 = og * tanhf(c2);
        c[i][j] = c2;
        hn[i][j] = h2;
        a.hs[bt * H + u0 + u] = h2;
        a.cs[bt * H + u0 + u] = c2;
        float* ar = a.acts + bt * G + u0 + u;
        ar[0] = ig;
        ar[H] = fg;
        ar[2 * (size_t)H] = gg;
        ar[3 * (size_t)H] = og;
      }
    }
    if (t + 1 == S) break;

    if (t == 0) cluster_wait_acquire();  // phase 0: every peer has started
    // This slice of h, keep[t+1] applied, into every peer's next buffer.
    float* nb = hbuf + ((t + 1) & 1) * H * LDR;
    for (int pr = 0; pr < C; ++pr) {
      float* dst = cluster.map_shared_rank(nb, pr);
#pragma unroll
      for (int j = 0; j < TU; ++j) {
        const int u = x * TU + j;
        if (u >= uval) continue;
#pragma unroll
        for (int i = 0; i < TM; ++i) dst[(u0 + u) * LDR + ry * TM + i] = hn[i][j] * kn[i];
      }
    }
    cluster_step_barrier();
  }
}

// ------------------------------------------------------- streamed regime
// Ring stage of chunk ch: k rows [ch*kKC, +kKC) of the slice into
// [kKC][LDW], and the same k of the tile's h into [R][kLDK] (from h0 or
// the step before's hs, which the cluster's blocks wrote: read from L2).
// 16-byte copies, one commit group. A thread's slice pieces keep their k
// row (tid % kKC) and take units 4*(tid / kKC) + 4*nq*m of every gate, so
// that no address needs a division.
__device__ __forceinline__ void stage_fwd(const FwdArgs& a, float* st, int ch, const float* hsrc,
                                          size_t hstride, int u0, int uval, int row0, int rows,
                                          int LDW) {
  const int U = a.p.U, H = a.p.H, R = a.p.R;
  const int k0 = ch * kKC, kk = threadIdx.x % kKC, nq = blockDim.x / kKC;
  const size_t G = 4 * (size_t)H;
  const bool krow = k0 + kk < H;
  const float* wrow = a.wh + (size_t)(krow ? k0 + kk : 0) * G + u0;
  float* drow = st + kk * LDW;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    for (int j = 4 * (threadIdx.x / kKC); j < U; j += 4 * nq) {
      const bool ok = krow && j < uval;
      cp_async16(drow + g * U + j, ok ? wrow + (size_t)g * H + j : a.wh, ok);
    }
  }
  float* hst = st + kKC * LDW;
  for (int i = threadIdx.x; i < R * (kKC / 4); i += blockDim.x) {
    const int r = i / (kKC / 4), k = 4 * (i % (kKC / 4));
    const bool ok = r < rows && k0 + k < H;
    cp_async16(hst + r * kLDK + k, ok ? hsrc + (size_t)(row0 + r) * hstride + k0 + k : hsrc, ok);
  }
  cp_async_commit();
}

// MT m-tiles of 16 rows (R = 16*MT); warps of 8 units (U/8 warps).
template <int MT>
__global__ void __launch_bounds__(kStreamedThreads, 1) lstm_fwd_streamed(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // phase 0: this block has started

  const Plan& p = a.p;
  const int U = p.U, H = p.H, R = p.R, S = p.S;
  const size_t G = 4 * (size_t)H;
  const int q = (int)cluster.block_rank();
  const int u0 = q * U, uval = min(U, H - u0);
  const int row0 = blockIdx.y * R, rows = min(R, p.B - row0);
  const int warp = threadIdx.x >> 5, g8 = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  const int LDW = stream_ldw(U);
  const int wsz = kKC * LDW, stage = wsz + R * kLDK;
  const int nchunks = (H + kKC - 1) / kKC, ns = p.stages;

  for (int t = 0; t < S; ++t) {
    // acc[m][gate][.]: rows 16m + g8 (+8), units 8*warp + 2tq (+1)
    float acc[MT][4][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][g][e] = 0.0f;
      }
    }
    const float* hsrc = t == 0 ? a.h0 : a.hs + (size_t)(t - 1) * H;
    const size_t hstride = t == 0 ? (size_t)H : (size_t)S * H;
    __syncthreads();  // the ring's stages are free
    for (int s = 0; s < ns - 1 && s < nchunks; ++s) {
      stage_fwd(a, smem + s * stage, s, hsrc, hstride, u0, uval, row0, rows, LDW);
    }
    for (int ch = 0; ch < nchunks; ++ch) {
      cp_async_wait_pending(min(nchunks, ch + ns - 1) - (ch + 1));
      __syncthreads();  // chunk ch has landed for every thread; chunk ch-1's stage is free
      const int next = ch + ns - 1;
      if (next < nchunks) {
        stage_fwd(a, smem + (next % ns) * stage, next, hsrc, hstride, u0, uval, row0, rows, LDW);
      }
      const float* st = smem + (ch % ns) * stage;
      const float* hst = st + wsz;
#pragma unroll 1
      for (int k8 = 0; k8 < kKC; k8 += 8) {  // k past H: zeros on both sides
        // B fragments of the warp's n-tile of each gate
        BFrag bf[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float* w = st + (k8 + tq) * LDW + g * U + 8 * warp + g8;
          make_b(bf[g], w[0], w[4 * LDW]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          AFrag af;
          load_a(af, hst, 16 * m, k8);
          mma_split_x2(acc[m][0], acc[m][1], af, bf[0], bf[1]);
          mma_split_x2(acc[m][2], acc[m][3], af, bf[2], bf[3]);
        }
      }
    }

    // The pre-activations into shared memory (over the ring), z[r][g*U + u],
    // so that the gates run one (row, unit) pair per thread at a time.
    float* z = smem;
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float* zp = z + (16 * m + g8) * LDW + g * U + 8 * warp + 2 * tq;
        *reinterpret_cast<float2*>(zp) = make_float2(acc[m][g][0], acc[m][g][1]);
        *reinterpret_cast<float2*>(zp + 8 * LDW) = make_float2(acc[m][g][2], acc[m][g][3]);
      }
    }
    __syncthreads();

    // Gates and the new carry, pair i = tid, tid + T, ..: c is read back
    // from cs[t-1] (this thread wrote it) or c0. The arrays do not alias,
    // so that the next pairs' loads may be issued before this one's stores.
    const float* __restrict__ xp = a.xp;
    const float* __restrict__ keep = a.keep;
    const float* __restrict__ cprev = t == 0 ? a.c0 : a.cs + (size_t)(t - 1) * H;
    const size_t cstride = t == 0 ? (size_t)H : (size_t)S * H;
    float* __restrict__ hs = a.hs;
    float* __restrict__ cs = a.cs;
    float* __restrict__ acts = a.acts;
    for (int i = threadIdx.x; i < R * U; i += blockDim.x) {
      const int r = i / U, u = i - r * U;
      if (r >= rows || u >= uval) continue;
      const size_t b = row0 + r, bt = b * S + t, hu = u0 + u;
      const float kp = keep[bt];
      const float* xr = xp + bt * G + hu;
      float zz[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) zz[g] = xr[(size_t)g * H] + kp * z[r * LDW + g * U + u];
      const float ig = sigmoid_f(zz[0]), fg = sigmoid_f(zz[1]), gg = tanhf(zz[2]),
                  og = sigmoid_f(zz[3]);
      const float cp = cprev[b * cstride + hu];
      const float c2 = fg * (cp * kp) + ig * gg;
      const float h2 = og * tanhf(c2);
      hs[bt * H + hu] = h2;
      cs[bt * H + hu] = c2;
      float* ar = acts + bt * G + hu;
      ar[0] = ig;
      ar[H] = fg;
      ar[2 * (size_t)H] = gg;
      ar[3 * (size_t)H] = og;
    }
    if (t + 1 == S) break;
    if (t == 0) cluster_wait_acquire();  // phase 0
    cluster_step_barrier();              // hs[t] of the whole tile is written
  }
}

// ------------------------------------------------------------ launching
using Kernel = void (*)(const FwdArgs);

// Resident: thread tile tm x tu. Streamed: R rows, warps of 8 units (tu).
Kernel kernel_for(int resident, int tm, int tu, int R) {
  if (resident) {
    if (tm == 1 && tu == 1) return lstm_fwd_resident<1, 1>;
    if (tm == 4 && tu == 1) return lstm_fwd_resident<4, 1>;
    return nullptr;
  }
  if (tu != 8) return nullptr;
  switch (R) {
    case 16: return lstm_fwd_streamed<1>;
    case 32: return lstm_fwd_streamed<2>;
    case 48: return lstm_fwd_streamed<3>;
    case 64: return lstm_fwd_streamed<4>;
    case 80: return lstm_fwd_streamed<5>;
    default: return nullptr;
  }
}

cudaError_t set_attributes() {
  for (Kernel k : {kernel_for(1, 1, 1, 0), kernel_for(1, 4, 1, 0)}) {
    cudaError_t e = allow_large(k);
    if (e != cudaSuccess) return e;
  }
  for (int R = 16; R <= 80; R += 16) {
    cudaError_t e = allow_large(kernel_for(0, 16, 8, R));
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Once on each device a launch meets (device_once.cuh).
cudaError_t setup() { return once_per_device<set_attributes>(); }

}  // namespace
}  // namespace lstm

// Plain C entry, bound with ctypes: every pointer and the stream are void*.
// The plan (R .. smem) comes from ops/lstm.lstm_launch_plan. Returns
// cudaGetLastError() after the launch (0 = launched); a plan the card
// cannot schedule comes back as the launch's error.
extern "C" int lstm_fwd_launch(const void* xp, const void* wh, const void* h0, const void* c0,
                               const void* keep, void* hs, void* cs, void* acts, int B, int S,
                               int H, int R, int U, int C, int row_tiles, int tm, int tu,
                               int threads, int resident, int stages, int smem, int push,
                               void* stream) {
  using namespace lstm;
  Kernel k = kernel_for(resident, tm, tu, R);
  if (k == nullptr || smem > kMaxSmem || (!resident && (stages < 2 || stages > 4))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = setup();
  if (err != cudaSuccess) return (int)err;
  FwdArgs a;
  a.xp = static_cast<const float*>(xp);
  a.wh = static_cast<const float*>(wh);
  a.h0 = static_cast<const float*>(h0);
  a.c0 = static_cast<const float*>(c0);
  a.keep = static_cast<const float*>(keep);
  a.hs = static_cast<float*>(hs);
  a.cs = static_cast<float*>(cs);
  a.acts = static_cast<float*>(acts);
  a.p = Plan{B, S, H, R, U, C, row_tiles, stages, push, smem};
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      make_config(attr, C, row_tiles, threads, smem, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, k, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of this plan's B1 the card holds at once
// (cudaOccupancyMaxActiveClusters); a negative value is -(CUDA error).
extern "C" int lstm_fwd_max_clusters(int C, int R, int tm, int tu, int resident, int threads,
                                     int smem) {
  using namespace lstm;
  Kernel k = kernel_for(resident, tm, tu, R);
  if (k == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t err = setup();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = make_config(attr, C, 1, threads, smem, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}
