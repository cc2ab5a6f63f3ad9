// Flash attention, backward (kernel B4), causal and segment-masked, float32
// in, f32 arithmetic on the CUDA cores, for sm_90a. (bf16 inputs take the
// tensor-core kernels, flash_attn_tc_bwd.cu.)
//
// Replaces: the backward of tpu_rl/parallel/sequence.py, flash_attention_tpu
// (the custom VJP of JAX's Pallas TPU flash-attention kernel). From the
// forward's q, k, v (B,T,H,D), seg (B,T), o (B,T,H,D) and row log-sum-exp
// lse (B,H,T), and the output cotangent do (B,T,H,D), with the visibility
// mask of the forward (j <= i, same segment):
//
//   delta_i = sum_d do[i,d] * o[i,d]                           (f32)
//   p_ij    = visible ? exp(scale * q_i . k_j - lse_i) : 0      (explicit 0)
//   dv_j    = sum_i p_ij do_i
//   ds_ij   = p_ij * (do_i . v_j - delta_i) * scale
//   dq_i    = sum_j ds_ij k_j          dk_j = sum_i ds_ij q_i
//
// as tpu_rl's own flash backward (_ring_vjp_bwd) recomputes it. dq, dk, dv
// come back contiguous.
//
// What bounds it on an H100. At (2,2048,8,64) f32 it reads q, k, v, o, do,
// lse and seg and writes dq, dk, dv: ~68 MB, ~0.02 ms at 3.35 TB/s. Under
// the causal mask it does 5*B*H*T^2*D = 21 GFLOP (five products of half the
// scores), ~0.32 ms at the 67 TFLOP/s f32 peak: bound by operations.
//
// What this first design does about it. Simple and exact, plain f32 FMAs on
// the CUDA cores, as the forward. Three launches and no atomics, so the sums
// run in a fixed order and the result is the same every run:
// 1. flash_bwd_delta: one warp per (b, t, h) row reduces do . o;
// 2. flash_bwd_dkdv: one block per (key tile, h, b) holds K and V and the
//    f32 dk and dv accumulators of its 64 keys, and walks the query tiles
//    from the diagonal on, recomputing pᵀ and dsᵀ (keys as rows) into shared
//    memory for the two products;
// 3. flash_bwd_dq: one block per (query tile, h, b) holds Q, dO, lse and
//    delta and the f32 dq accumulator, and walks the key tiles up to the
//    diagonal, recomputing p and ds.
// The dkdv block holds six 64-row tiles (100 KB at D=64), the dq block five
// (83 KB): dynamic shared memory, two blocks per SM.

#include "flash_attn.cuh"

namespace {

using namespace flash;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
                float* __restrict__ delta,
                int T_len, int H, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const float* orow = o + row * D;
  const float* drow = dout + row * D;
  float sum = 0.0f;
  for (int d = lane; d < D; d += 32) sum = fmaf(drow[d], orow[d], sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const long long bt = row / H;  // row = (b*T + t)*H + h
    const int h = (int)(row - bt * H);
    const long long b = bt / T_len;
    const int t = (int)(bt - b * T_len);
    delta[(b * H + h) * T_len + t] = sum;
  }
}

// Per-row statistics of one query tile; rows past T get 0 (they are masked).
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           const float* __restrict__ lse_bh,
                                           const float* __restrict__ delta_bh, int t0,
                                           int T_len) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool in = t0 + r < T_len;
    lse_s[r] = in ? lse_bh[t0 + r] : 0.0f;
    delta_s[r] = in ? delta_bh[t0 + r] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ seg,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const float* __restrict__ dout, float* __restrict__ dk, float* __restrict__ dv, int T_len, int H, long long sb, long long st, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                       // kTile x (D+1)
  float* Vs = Ks + kTile * (D + 1);
  float* Qs = Vs + kTile * (D + 1);
  float* dOs = Qs + kTile * (D + 1);
  float* PTs = dOs + kTile * (D + 1);     // kTile x kPitchP, keys as rows
  float* dSTs = PTs + kTile * kPitchP;
  float* lse_s = dSTs + kTile * kPitchP;
  float* delta_s = lse_s + kTile;
  int* seg_k = reinterpret_cast<int*>(delta_s + kTile);
  int* seg_q = seg_k + kTile;

  const int kt = blockIdx.x;  // the keys with the most query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = kt * kTile;
  const int n_tiles = (T_len + kTile - 1) / kTile;
  const long long base = (long long)b * sb + (long long)h * D;
  const long long dense_base = ((long long)b * T_len * H + h) * D;  // do, dk, dv
  const long long dense_st = (long long)H * D;
  const int* seg_b = seg + (long long)b * T_len;
  const float* lse_bh = lse + ((long long)b * H + h) * T_len;
  const float* delta_bh = delta + ((long long)b * H + h) * T_len;

  load_tile<D>(Ks, k + base, st, k0, T_len);
  load_tile<D>(Vs, v + base, st, k0, T_len);
  load_seg(seg_k, seg_b, k0, T_len);

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  for (int qt = kt; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    load_tile<D>(Qs, q + base, st, q0, T_len);
    load_tile<D>(dOs, dout + dense_base, dense_st, q0, T_len);
    load_seg(seg_q, seg_b, q0, T_len);
    load_stats(lse_s, delta_s, lse_bh, delta_bh, q0, T_len);
    __syncthreads();

    // Keys as rows (ty + 16i), queries as columns (tx + 16j).
    float sT[4][4], dpT[4][4];
    dot_nt<D>(sT, Ks, Qs, ty, tx);
    dot_nt<D>(dpT, Vs, dOs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + c, k0 + r, T_len, seg_q[c], seg_k[r])
                            ? expf(sT[i][j] * scale - lse_s[c])
                            : 0.0f;
        PTs[r * kPitchP + c] = p;
        dSTs[r * kPitchP + c] = p * (dpT[i][j] - delta_s[c]) * scale;
      }
    }
    __syncthreads();
    dot_nn<D>(dv_acc, PTs, dOs, ty, tx);
    dot_nn<D>(dk_acc, dSTs, Qs, ty, tx);
    __syncthreads();  // before the next query tile overwrites the tiles
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= T_len) continue;
    const long long off = dense_base + (long long)t * dense_st;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dk[off + tx + 16 * j] = dk_acc[i][j];
      dv[off + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ seg,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const float* __restrict__ dout, float* __restrict__ dq,
             int T_len, int H, long long sb, long long st, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // kTile x (D+1)
  float* dOs = Qs + kTile * (D + 1);
  float* Ks = dOs + kTile * (D + 1);
  float* Vs = Ks + kTile * (D + 1);
  float* dSs = Vs + kTile * (D + 1);      // kTile x kPitchP, queries as rows
  float* lse_s = dSs + kTile * kPitchP;
  float* delta_s = lse_s + kTile;
  int* seg_q = reinterpret_cast<int*>(delta_s + kTile);
  int* seg_k = seg_q + kTile;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * kTile;
  const long long base = (long long)b * sb + (long long)h * D;
  const long long dense_base = ((long long)b * T_len * H + h) * D;
  const long long dense_st = (long long)H * D;
  const int* seg_b = seg + (long long)b * T_len;

  load_tile<D>(Qs, q + base, st, q0, T_len);
  load_tile<D>(dOs, dout + dense_base, dense_st, q0, T_len);
  load_seg(seg_q, seg_b, q0, T_len);
  load_stats(lse_s, delta_s, lse + ((long long)b * H + h) * T_len,
             delta + ((long long)b * H + h) * T_len, q0, T_len);

  float dq_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dq_acc[i][j] = 0.0f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    load_tile<D>(Ks, k + base, st, k0, T_len);
    load_tile<D>(Vs, v + base, st, k0, T_len);
    load_seg(seg_k, seg_b, k0, T_len);
    __syncthreads();

    // Queries as rows (ty + 16i), keys as columns (tx + 16j).
    float s[4][4], dp[4][4];
    dot_nt<D>(s, Qs, Ks, ty, tx);
    dot_nt<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, T_len, seg_q[r], seg_k[c])
                            ? expf(s[i][j] * scale - lse_s[r])
                            : 0.0f;
        dSs[r * kPitchP + c] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();
    dot_nn<D>(dq_acc, dSs, Ks, ty, tx);
    __syncthreads();  // before the next key tile overwrites Ks, Vs, dSs
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T_len) continue;
    const long long off = dense_base + (long long)t * dense_st;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dq[off + tx + 16 * j] = dq_acc[i][j];
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* seg, const void* o,
           const void* lse, const void* dout, void* delta, void* dq, void* dk, void* dv, int B,
           int T_len, int H, long long sb, long long st, float scale, cudaStream_t stream) {
  const long long rows = (long long)B * T_len * H;
  const int warps = kThreads / 32;
  flash_bwd_delta<D><<<(unsigned)((rows + warps - 1) / warps), kThreads, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), static_cast<float*>(delta), T_len,
      H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_tiles = (T_len + kTile - 1) / kTile;
  const dim3 grid(n_tiles, H, B);
  const size_t stats = sizeof(float) * 2 * kTile + sizeof(int) * 2 * kTile;
  const size_t smem_dkdv =
      sizeof(float) * (4 * (size_t)kTile * (D + 1) + 2 * (size_t)kTile * kPitchP) + stats;
  err = allow_smem(flash_bwd_dkdv<D>, smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv<D><<<grid, kThreads, smem_dkdv, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(dout), static_cast<float*>(dk),
      static_cast<float*>(dv), T_len, H, sb, st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_dq =
      sizeof(float) * (4 * (size_t)kTile * (D + 1) + (size_t)kTile * kPitchP) + stats;
  err = allow_smem(flash_bwd_dq<D>, smem_dq);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq<D><<<grid, kThreads, smem_dq, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(dout), static_cast<float*>(dq), T_len,
      H, sb, st, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes: every pointer and the stream are void*.
// q, k, v (float32) share the element strides sb and st; seg, o, lse, do,
// the f32 scratch delta (B,H,T) and the outputs dq, dk, dv are contiguous.
// Launches the three kernels in order on ``stream``. Returns the first
// launch error (0 = all launched), or cudaErrorInvalidValue for an unbuilt
// head width.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v,
                                     const void* seg, const void* o, const void* lse,
                                     const void* dout, void* delta, void* dq, void* dk, void* dv,
                                     int B, int T_len, int H, int D, long long sb, long long st,
                                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, seg, o, lse, dout, delta, dq, dk, dv, B, T_len, H, sb, st,
                        scale, s);
    case 64:
      return launch<64>(q, k, v, seg, o, lse, dout, delta, dq, dk, dv, B, T_len, H, sb, st,
                        scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
