// LSTM sequence unroll, backward (kernel B2), f32, for sm_90a.
//
// Replaces: tpu_rl/ops/pallas_lstm.py, _pallas_backward (Pallas body
// _bwd_kernel). Analytic backprop in reverse time from the forward's saved
// gate activations acts = [i, f, g, o] (B,S,4H) and cell states cs (B,S,H),
// for t = S-1..0 with carries dh = dc = 0 entering step S-1:
//
//   c_prev = (t > 0 ? cs[t-1] : c0) * keep[t]
//   dh_t   = dhs[t] + dh;  tc = tanh(cs[t])
//   dc_t   = dcs[t] + dc + dh_t * o * (1 - tc^2)
//   dz     = [dc_t*g * i(1-i), dc_t*c_prev * f(1-f), dc_t*i * (1-g^2),
//             dh_t*tc * o(1-o)]                      -> dxp[t]  (B,S,4H)
//   dh     = (dz @ wh^T) * keep[t];  dc = dc_t * f * keep[t]
//
// and writes dxp, dh0 = dh and dc0 = dc after step 0. The weight gradient
// dwh = sum_t (h_prev[t]*keep[t])^T dz[t] is one (H, B*S) x (B*S, 4H)
// product outside the kernel, as in tpu_rl.
//
// What bounds it on an H100: as the forward (~1.97 MB and 21 MFLOP at
// (128,5,64), bytes and step latency; 137 GFLOP at (1024,16,1024),
// operations).
//
// The design: the forward's cluster, unit ownership, regimes and register
// tiles (lstm_fwd.cu, lstm_common.cuh), so that wh is read as the forward
// reads it and never transposed.
//
// 1. Local gradients. At step t a block's dz for its units needs only dh,
//    dc, acts and cs at those units.
// 2. Partial dh, summed in a fixed order. dh = dz @ wh^T needs every gate
//    column: block q computes the partial P_q = dz[:, its 4U columns] @
//    wh[:, its 4U columns]^T for all H units, from its own slice of wh, in
//    windows of 4U units (thread: TM rows x 4*TU units of the window, one
//    FMA chain per output over the block's columns in order). Resident
//    regime: each block pushes P_q's columns of unit slice p into its slot
//    q of block p's shared memory over DSMEM (double-buffered by step
//    parity); after the cluster barrier block p adds its C slots in rank
//    order. No atomics: the sums are the same in every run. Streamed
//    regime (the slots, C x R x U floats, do not fit beside a streamed
//    slice): the partials go through a global scratch buffer in the same
//    layout and are added in the same order, read from L2 (the resident
//    kernel can take that path too, plan.push = 0, for lab/b12_lab.py).
// 3. Streamed regime: per window of 4U units, the window's rows of the
//    slice and the step's dz (read back from dxp) stream through the ring
//    in chunks of 16 gate columns, and the product runs on the tensor cores
//    in split precision, as in lstm_fwd.cu: a warp owns 32 units of the
//    window for all R rows (the window is 4U units: U/8 warps, as B1's).

#include "lstm_common.cuh"

namespace lstm {
namespace {

// The arrays do not alias (restrict: a pair's loads may be issued before
// the previous pair's stores).
struct BwdArgs {
  const float *__restrict__ acts, *__restrict__ cs, *__restrict__ c0, *__restrict__ keep,
      *__restrict__ dhs, *__restrict__ dcs, *__restrict__ wh;
  float *__restrict__ dxp, *__restrict__ dh0, *__restrict__ dc0;
  float* scratch;  // streamed (or !push): 2 x row_tiles x C x H x R partials
  Plan p;
};

// The gate gradients of (row r, hidden unit hu) at step t; writes dxp and
// returns dz, updating the carry dc (dc_t * f * keep[t]).
__device__ __forceinline__ void gate_grads(const BwdArgs& a, size_t b, int t, int hu, float dh,
                                           float& dc, float (&dz)[4]) {
  const int H = a.p.H, S = a.p.S;
  const size_t G = 4 * (size_t)H, bt = b * S + t;
  const float* ar = a.acts + bt * G + hu;
  const float ig = ar[0], fg = ar[H], gg = ar[2 * (size_t)H], og = ar[3 * (size_t)H];
  const float kp = a.keep[bt];
  const float cp = t > 0 ? a.cs[(bt - 1) * H + hu] : a.c0[b * H + hu];
  const float cp_used = cp * kp;
  const float dh_t = a.dhs[bt * H + hu] + dh;
  const float tc = tanhf(a.cs[bt * H + hu]);
  const float d_o = dh_t * tc;
  const float dc_t = a.dcs[bt * H + hu] + dc + dh_t * og * (1.0f - tc * tc);
  dz[0] = dc_t * gg * ig * (1.0f - ig);
  dz[1] = dc_t * cp_used * fg * (1.0f - fg);
  dz[2] = dc_t * ig * (1.0f - gg * gg);
  dz[3] = d_o * og * (1.0f - og);
  float* out = a.dxp + bt * G + hu;
#pragma unroll
  for (int g = 0; g < 4; ++g) out[(size_t)g * H] = dz[g];
  dc = dc_t * fg * kp;
}

// Slot s of parity par in the global scratch: this tile's partial of
// block s, [k][r].
__device__ __forceinline__ float* scratch_slot(const BwdArgs& a, int par, int s) {
  const Plan& p = a.p;
  return a.scratch + (((size_t)par * p.row_tiles + blockIdx.y) * p.C + s) * p.H * p.R;
}

// ------------------------------------------------------- resident regime
template <int TM, int TU>
__global__ void __launch_bounds__(kResidentThreads, 1) lstm_bwd_resident(const BwdArgs a) {
  constexpr int TK = 4 * TU;  // window units per thread
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // phase 0: this block has started

  const Plan& p = a.p;
  const int U = p.U, H = p.H, R = p.R, S = p.S, C = p.C;
  const int q = (int)cluster.block_rank();
  const int u0 = q * U, uval = min(U, H - u0);
  const int row0 = blockIdx.y * R, rows = min(R, p.B - row0);
  const int KX = U / TU;
  const int x = threadIdx.x % KX, ry = threadIdx.x / KX;
  const int LDR = round4(R);
  const int LDW = 4 * U + 1;

  const int HP = (H + 4 * U - 1) / (4 * U) * (4 * U);  // H up to whole windows
  float* ws = smem;                                     // HP x LDW: the slice
  float* dzs = smem + round4(HP * LDW);                 // 4U x LDR, [c][r]
  float* slots = dzs + 4 * U * LDR;                     // 2 x C x U x LDR (push)

  load_slice(ws, a.wh, H, U, u0, uval);
  cp_async_wait_pending(0);
  __syncthreads();

  // dh entering step tk-1: this block's units of sum_s P_s from step tk,
  // in rank order, times keep[tk].
  auto carry_dh = [&](float (&dh)[TM][TU], int tk) {
    const int par = tk & 1;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ry * TM + i;
      const float kp = r < rows ? a.keep[(size_t)(row0 + r) * S + tk] : 0.0f;
#pragma unroll
      for (int j = 0; j < TU; ++j) {
        const int u = x * TU + j;
        float v = 0.0f;
        if (u < uval) {
          for (int s = 0; s < C; ++s) {
            const float ps = p.push ? slots[((par * C + s) * U + u) * LDR + r]
                                    : __ldcg(scratch_slot(a, par, s) + (size_t)(u0 + u) * R + r);
            v = s == 0 ? ps : v + ps;
          }
        }
        dh[i][j] = v * kp;
      }
    }
  };

  float dc[TM][TU], dh[TM][TU];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TU; ++j) dc[i][j] = dh[i][j] = 0.0f;
  }

  for (int t = S - 1; t >= 0; --t) {
    if (t < S - 1) carry_dh(dh, t + 1);

    // 1. Gate gradients of the thread's (row, unit) pairs, into dz's tile.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ry * TM + i;
#pragma unroll
      for (int j = 0; j < TU; ++j) {
        const int u = x * TU + j;
        float dz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (r < rows && u < uval) gate_grads(a, row0 + r, t, u0 + u, dh[i][j], dc[i][j], dz);
#pragma unroll
        for (int g = 0; g < 4; ++g) dzs[(g * U + u) * LDR + r] = dz[g];
      }
    }
    __syncthreads();  // dz is complete
    if (t == S - 1) cluster_wait_acquire();  // phase 0: every peer has started

    // 2. The partial dh over this block's columns, window by window: the
    // thread's units w0 + x + KX*j (rows of the odd-length slice rows:
    // distinct banks; past H: dropped).
    const int par = t & 1;
    for (int w0 = 0; w0 < H; w0 += 4 * U) {
      float acc[TM][TK];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TK; ++j) acc[i][j] = 0.0f;
      }
      bwd_fma<TM, TK>(acc, dzs, LDR, ws + (w0 + x) * LDW, KX * LDW, ry, 4 * U);
      // Unit k's column of P_q into slot q of k's owner.
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const int k = w0 + x + KX * j;
        if (k >= H) continue;
        const int owner = k / U, uu = k - owner * U;
        float* dst = p.push ? cluster.map_shared_rank(slots, owner) + ((par * C + q) * U + uu) * LDR
                            : scratch_slot(a, par, q) + (size_t)k * R;
        dst += ry * TM;
#pragma unroll
        for (int i = 0; i < TM; ++i) dst[i] = acc[i][j];
      }
    }
    cluster_step_barrier();
  }

  // dh0 and dc0.
  carry_dh(dh, 0);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ry * TM + i;
#pragma unroll
    for (int j = 0; j < TU; ++j) {
      const int u = x * TU + j;
      if (r < rows && u < uval) {
        const size_t o = (size_t)(row0 + r) * H + u0 + u;
        a.dh0[o] = dh[i][j];
        a.dc0[o] = dc[i][j];
      }
    }
  }
}

// ------------------------------------------------------- streamed regime
// Ring stage of chunk ch of window w0: gate columns [ch*kKC, +kKC) of the
// block (one gate's: U is a multiple of kKC) of the window's 4U rows of the
// slice, [4U][kLDK], and the same columns of the step's dz from dxp,
// [R][kLDK]. 16-byte copies from L2, one commit group.
__device__ __forceinline__ void stage_bwd(const BwdArgs& a, float* st, int w0, int ch, int t,
                                          int u0, int uval, int row0, int rows) {
  const int U = a.p.U, H = a.p.H, R = a.p.R, S = a.p.S, KW = 4 * U;
  const int c0 = ch * kKC, g = c0 / U, j0 = c0 - g * U;
  const size_t G = 4 * (size_t)H, col = (size_t)g * H + u0 + j0;
  for (int i = threadIdx.x; i < KW * (kKC / 4); i += blockDim.x) {
    const int kk = i / (kKC / 4), c = 4 * (i % (kKC / 4));
    const bool ok = w0 + kk < H && j0 + c < uval;
    cp_async16(st + kk * kLDK + c, ok ? a.wh + (size_t)(w0 + kk) * G + col + c : a.wh, ok);
  }
  float* dst = st + KW * kLDK;
  for (int i = threadIdx.x; i < R * (kKC / 4); i += blockDim.x) {
    const int r = i / (kKC / 4), c = 4 * (i % (kKC / 4));
    const bool ok = r < rows && j0 + c < uval;
    cp_async16(dst + r * kLDK + c, ok ? a.dxp + ((size_t)(row0 + r) * S + t) * G + col + c : a.dxp,
               ok);
  }
  cp_async_commit();
}

// MT m-tiles of 16 rows; NT n-tiles (32 window units) a warp.
template <int MT>
__global__ void __launch_bounds__(kStreamedThreads, 1) lstm_bwd_streamed(const BwdArgs a) {
  constexpr int NT = 4;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // phase 0: this block has started

  const Plan& p = a.p;
  const int U = p.U, H = p.H, R = p.R, S = p.S, C = p.C, KW = 4 * U;
  const int q = (int)cluster.block_rank();
  const int u0 = q * U, uval = min(U, H - u0);
  const int row0 = blockIdx.y * R, rows = min(R, p.B - row0);
  const int warp = threadIdx.x >> 5, g8 = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  const int stage = (KW + R) * kLDK;
  const int nchunks = KW / kKC, ns = p.stages;

  for (int t = S - 1; t >= 0; --t) {
    // 1. Gate gradients of (row, unit) pairs i = tid, tid + T, ..; the
    // carry dc lives in dc0, where this thread keeps its own entries until
    // step 0 writes the result.
    const float* __restrict__ slots = scratch_slot(a, (t + 1) & 1, 0);
    const size_t slot_stride = (size_t)H * R;
    for (int i = threadIdx.x; i < R * U; i += blockDim.x) {
      const int r = i / U, u = i - r * U;
      if (r >= rows || u >= uval) continue;
      const size_t b = row0 + r, o = b * H + u0 + u;
      float dh = 0.0f;
      if (t < S - 1) {
        const float* ps = slots + (size_t)(u0 + u) * R + r;
        dh = __ldcg(ps);
        for (int s = 1; s < C; ++s) dh += __ldcg(ps + s * slot_stride);
        dh *= a.keep[b * S + t + 1];
      }
      float dc = t < S - 1 ? a.dc0[o] : 0.0f, dz[4];
      gate_grads(a, b, t, u0 + u, dh, dc, dz);
      a.dc0[o] = dc;
    }
    __syncthreads();  // dz is in dxp
    if (t == S - 1) cluster_wait_acquire();  // phase 0

    // 2. The partial dh over this block's columns: windows of 4U units,
    // warp w on units w0 + 8*NT*w .. (NT n-tiles) for all R rows.
    for (int w0 = 0; w0 < H; w0 += KW) {
      float acc[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
        }
      }
      __syncthreads();  // the ring's stages are free
      for (int s = 0; s < ns - 1 && s < nchunks; ++s) {
        stage_bwd(a, smem + s * stage, w0, s, t, u0, uval, row0, rows);
      }
      for (int ch = 0; ch < nchunks; ++ch) {
        cp_async_wait_pending(min(nchunks, ch + ns - 1) - (ch + 1));
        __syncthreads();
        const int next = ch + ns - 1;
        if (next < nchunks) stage_bwd(a, smem + (next % ns) * stage, w0, next, t, u0, uval, row0, rows);
        const float* st = smem + (ch % ns) * stage;
        const float* dzt = st + KW * kLDK;
#pragma unroll 1
        for (int k8 = 0; k8 < kKC; k8 += 8) {
          BFrag bf[NT];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float* w = st + (8 * NT * warp + 8 * n + g8) * kLDK + k8 + tq;
            make_b(bf[n], w[0], w[4]);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            AFrag af;
            load_a(af, dzt, 16 * m, k8);
#pragma unroll
            for (int n = 0; n < NT; n += 2) mma_split_x2(acc[m][n], acc[m][n + 1], af, bf[n], bf[n + 1]);
          }
        }
      }
      // The partials into this block's slots of the scratch, [k][r].
      float* slot = scratch_slot(a, t & 1, q);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = w0 + 8 * NT * warp + 8 * n + 2 * tq + e;
          if (k >= H) continue;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            slot[(size_t)k * R + 16 * m + g8] = acc[m][n][e];
            slot[(size_t)k * R + 16 * m + g8 + 8] = acc[m][n][2 + e];
          }
        }
      }
    }
    cluster_step_barrier();
  }

  // dh0 (dc0 is in place).
  for (int i = threadIdx.x; i < R * U; i += blockDim.x) {
    const int r = i / U, u = i - r * U;
    if (r >= rows || u >= uval) continue;
    const size_t b = row0 + r;
    float dh = 0.0f;
    for (int s = 0; s < C; ++s) {
      const float ps = __ldcg(scratch_slot(a, 0, s) + (size_t)(u0 + u) * R + r);
      dh = s == 0 ? ps : dh + ps;
    }
    a.dh0[b * H + u0 + u] = dh * a.keep[b * S];
  }
}

// ------------------------------------------------------------ launching
using Kernel = void (*)(const BwdArgs);

// Resident: thread tile tm x tu. Streamed: R rows, warps of 8 units (tu), as B1's.
Kernel kernel_for(int resident, int tm, int tu, int R) {
  if (resident) {
    if (tm == 1 && tu == 1) return lstm_bwd_resident<1, 1>;
    if (tm == 4 && tu == 1) return lstm_bwd_resident<4, 1>;
    return nullptr;
  }
  if (tu != 8) return nullptr;
  switch (R) {
    case 16: return lstm_bwd_streamed<1>;
    case 32: return lstm_bwd_streamed<2>;
    case 48: return lstm_bwd_streamed<3>;
    case 64: return lstm_bwd_streamed<4>;
    case 80: return lstm_bwd_streamed<5>;
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

// Plain C entry, bound with ctypes: every pointer and the stream are void*;
// `scratch` (streamed regime, or push = 0; else unread) holds 2 x
// row_tiles x C x H x R floats. The plan comes from
// ops/lstm.lstm_launch_plan. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int lstm_bwd_launch(const void* acts, const void* cs, const void* c0,
                               const void* keep, const void* dhs, const void* dcs,
                               const void* wh, void* dxp, void* dh0, void* dc0, void* scratch,
                               int B, int S, int H, int R, int U, int C, int row_tiles, int tm,
                               int tu, int threads, int resident, int stages, int smem, int push,
                               void* stream) {
  using namespace lstm;
  Kernel k = kernel_for(resident, tm, tu, R);
  if (k == nullptr || smem > kMaxSmem || (!resident && (stages < 2 || stages > 4 || push))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = setup();
  if (err != cudaSuccess) return (int)err;
  BwdArgs a;
  a.acts = static_cast<const float*>(acts);
  a.cs = static_cast<const float*>(cs);
  a.c0 = static_cast<const float*>(c0);
  a.keep = static_cast<const float*>(keep);
  a.dhs = static_cast<const float*>(dhs);
  a.dcs = static_cast<const float*>(dcs);
  a.wh = static_cast<const float*>(wh);
  a.dxp = static_cast<float*>(dxp);
  a.dh0 = static_cast<float*>(dh0);
  a.dc0 = static_cast<float*>(dc0);
  a.scratch = static_cast<float*>(scratch);
  a.p = Plan{B, S, H, R, U, C, row_tiles, stages, push, smem};
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      make_config(attr, C, row_tiles, threads, smem, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, k, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
