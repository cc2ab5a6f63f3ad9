// Flash attention, backward (kernel B4), causal and segment-masked, bf16 in,
// on Hopper's tensor cores (mma.sync bf16, f32 accumulation), for sm_90a.
//
// Replaces: the backward of tpu_rl/parallel/sequence.py:608,
// flash_attention_tpu (the custom VJP of JAX's library Pallas TPU
// flash-attention kernel, sequence.py:641-666). From the forward's q, k, v
// (B,T,H,D), seg (B,T), o and row log-sum-exp lse (B,H,T), and the output
// cotangent do, with the forward's mask (j <= i, same segment):
//
//   delta_i = sum_d do[i,d] * o[i,d]                           (f32)
//   p_ij    = visible ? exp(scale * q_i . k_j - lse_i) : 0      (explicit 0)
//   dv_j    = sum_i p_ij do_i
//   ds_ij   = p_ij * (do_i . v_j - delta_i) * scale
//   dq_i    = sum_j ds_ij k_j          dk_j = sum_i ds_ij q_i
//
// dq, dk, dv come back contiguous bf16. float32 inputs take the CUDA-core
// kernels of flash_attn_bwd.cu.
//
// What bounds it on an H100. At (16,2048,8,64) with one seam per row it
// reads q, k, v, o, do, lse and seg and writes dq, dk, dv: ~270 MB, ~0.08 ms
// at 3.35 TB/s; its five products over the ~24M kept pairs per head are
// ~122 GFLOP, ~0.12 ms at the 989 TFLOP/s bf16 peak: bound by operations.
//
// What the design does about it. Three launches and no atomics, so the sums
// run in one order and the result is the same every run:
// 1. flash_tc_bwd_delta: D/8 lanes per (b, t, h) row reduce do . o;
// 2. flash_tc_bwd_dkdv: one block per (key tile, h, b). Each warp owns 16
//    keys and holds their f32 dk and dv in registers; the block walks the
//    query tiles from the diagonal on and recomputes S^T = K Q^T and
//    dP^T = V dO^T, then P^T and dS^T in registers, which feed
//    dV += P^T dO and dK += dS^T Q as A operands;
// 3. flash_tc_bwd_dq: one block per (query tile, h, b), each warp 16 query
//    rows with their Q and dO fragments and f32 dq in registers, walks the
//    key tiles up to the diagonal, recomputes S and dP, and takes
//    dQ += dS K.
// Every product is mma.sync.m16n8k16 bf16 with f32 accumulation
// (flash_attn_tc.cuh). P and dS enter their products as hi/lo bf16 pairs
// (two MMAs each) for ~17 bits, where the TPU kernel rounds them to bf16
// once (flash_attention.py's dv, dk and dq products): the port's bar is per
// element. So the two kernels run 10 products where one rounding of P and dS
// with the dq recompute would take 7. The Q/dO (dk/dv kernel) and K/V (dq
// kernel) tiles, with their segment ids, lse and delta, arrive by cp.async
// into a two-stage ring while the current tile is computed. Tiles are
// skipped by the forward's rule (next_meeting, on the wrapper's per-tile
// segment-id ranges): the dk/dv walk stops at the last query tile whose
// range meets the key tile's. Both grids start with the tiles that visit
// the most, in the wrapper's order.

#include "flash_attn_tc.cuh"

namespace {

using namespace flash_tc;

// Columns of the score tile a warp takes at a time, queries in dk/dv and
// keys in dq: S, dP and the f32 accumulators then stay in registers at
// three blocks per SM.
constexpr int kColsKV = 16;
constexpr int kColsQ = 32;

// delta of one (b, t, h) row per D/8 lanes, 16 bytes of o and of do a lane.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_tc_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                   float* __restrict__ delta, int T_len, int H, long long rows) {
  constexpr int kLanes = D / 8;
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / kLanes;
  const int part = threadIdx.x % kLanes;
  float sum = 0.0f;
  if (row < rows) {
    const uint4 a = reinterpret_cast<const uint4*>(o + row * D)[part];
    const uint4 d = reinterpret_cast<const uint4*>(dout + row * D)[part];
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(d2[i]);
      sum = fmaf(x.x, y.x, sum);
      sum = fmaf(x.y, y.y, sum);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
  if (row < rows && part == 0) {
    const long long bt = row / H;  // row = (b*T + t)*H + h
    const int h = (int)(row - bt * H);
    const long long b = bt / T_len;
    const int t = (int)(bt - b * T_len);
    delta[(b * H + h) * T_len + t] = sum;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 3)
flash_tc_bwd_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ seg,
                  const int* __restrict__ tile_min, const int* __restrict__ tile_max,
                  const int* __restrict__ order, const float* __restrict__ lse,
                  const float* __restrict__ delta, const bf16* __restrict__ dout,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int T_len, int H, int n_tiles,
                  long long sb, long long st, float scale, float scale_log2) {
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // kTile x P
  bf16* Vs = Ks + kTile * P;                     // kTile x P
  bf16* Qs = Vs + kTile * P;                     // 2 stages x kTile x P
  bf16* dOs = Qs + 2 * kTile * P;                // 2 stages x kTile x P
  int* seg_q = reinterpret_cast<int*>(dOs + 2 * kTile * P);  // 2 stages x kTile
  float* lse_s = reinterpret_cast<float*>(seg_q + 2 * kTile);
  float* delta_s = lse_s + 2 * kTile;

  const int item = order[blockIdx.x];
  const int b = item / n_tiles, kt = item - b * n_tiles;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int k0 = kt * kTile;
  const long long base = (long long)b * sb + (long long)h * D;
  const long long dense_base = (long long)b * T_len * H * D + (long long)h * D;  // do, dk, dv
  const long long dense_st = (long long)H * D;
  const int* seg_b = seg + (long long)b * T_len;
  const float* lse_bh = lse + ((long long)b * H + h) * T_len;
  const float* delta_bh = delta + ((long long)b * H + h) * T_len;
  const int* tmin = tile_min + (long long)b * n_tiles;
  const int* tmax = tile_max + (long long)b * n_tiles;
  const int kmin = tmin[kt], kmax = tmax[kt];

  // This thread's two key rows (rows of S^T) and their segment ids.
  const int j0 = k0 + warp * 16 + g, j1 = j0 + 8;
  const int sk0 = j0 < T_len ? seg_b[j0] : 0;
  const int sk1 = j1 < T_len ? seg_b[j1] : 0;

  int qt = kt;  // a tile meets itself
  copy_tile<D>(Ks, k + base, st, k0, T_len);
  copy_tile<D>(Vs, v + base, st, k0, T_len);
  copy_tile<D>(Qs, q + base, st, qt * kTile, T_len);
  copy_tile<D>(dOs, dout + dense_base, dense_st, qt * kTile, T_len);
  copy_vec(seg_q, seg_b, qt * kTile, T_len);
  copy_vec(lse_s, lse_bh, qt * kTile, T_len);
  copy_vec(delta_s, delta_bh, qt * kTile, T_len);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;

  uint32_t ka[D / 16][4], va[D / 16][4];  // this warp's 16 rows of K and V
  for (int stage = 0, first = 1; qt < n_tiles; stage ^= 1, first = 0) {
    cp_async_wait_all();
    __syncthreads();  // tile qt is in; every warp is done with the other stage
    if (first) {
      load_a<D>(ka, Ks, warp * 16, lane);
      load_a<D>(va, Vs, warp * 16, lane);
    }
    const int next = next_meeting(tmin, tmax, qt + 1, n_tiles, kmin, kmax);
    if (next < n_tiles) {
      const int s1 = stage ^ 1, t1 = next * kTile;
      copy_tile<D>(Qs + s1 * kTile * P, q + base, st, t1, T_len);
      copy_tile<D>(dOs + s1 * kTile * P, dout + dense_base, dense_st, t1, T_len);
      copy_vec(seg_q + s1 * kTile, seg_b, t1, T_len);
      copy_vec(lse_s + s1 * kTile, lse_bh, t1, T_len);
      copy_vec(delta_s + s1 * kTile, delta_bh, t1, T_len);
    }
    cp_async_commit();

    const bf16* Qt = Qs + stage * kTile * P;
    const bf16* dOt = dOs + stage * kTile * P;
    const int* sq = seg_q + stage * kTile;
    const float* ls = lse_s + stage * kTile;
    const float* dl = delta_s + stage * kTile;
    const int q0 = qt * kTile;
    const bool all_in = interior(qt, kt, tmin[qt], tmax[qt], kmin, kmax, T_len);

    // Keys as rows (this warp's 16), the tile's queries as columns, kColsKV
    // at a time: S^T and dP^T, then P^T and dS^T, then their share of dV
    // and dK.
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kColsKV) {
      float s[kColsKV / 8][4], dp[kColsKV / 8][4];
      gemm_nt<D, kColsKV>(s, ka, Qt, c0, lane);
      gemm_nt<D, kColsKV>(dp, va, dOt, c0, lane);
#pragma unroll
      for (int n = 0; n < kColsKV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + n * 8 + 2 * c + (e & 1);
          const bool vis = all_in || (e < 2 ? visible(q0 + col, j0, T_len, sq[col], sk0)
                                            : visible(q0 + col, j1, T_len, sq[col], sk1));
          const float p = vis ? exp2f(fmaf(s[n][e], scale_log2, -ls[col] * kLog2e)) : 0.0f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dl[col]) * scale;
        }
      gemm_nn_split<D, kColsKV>(dv_acc, s, dOt, c0, lane);
      gemm_nn_split<D, kColsKV>(dk_acc, dp, Qt, c0, lane);
    }
    qt = next;
  }

  bf16* dk0 = dk + dense_base + (long long)j0 * dense_st + 2 * c;
  bf16* dv0 = dv + dense_base + (long long)j0 * dense_st + 2 * c;
  const long long down = 8 * dense_st;  // row j1
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (j0 < T_len) {
      *reinterpret_cast<__nv_bfloat162*>(dk0 + 8 * j) = __floats2bfloat162_rn(dk_acc[j][0], dk_acc[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv0 + 8 * j) = __floats2bfloat162_rn(dv_acc[j][0], dv_acc[j][1]);
    }
    if (j1 < T_len) {
      *reinterpret_cast<__nv_bfloat162*>(dk0 + down + 8 * j) =
          __floats2bfloat162_rn(dk_acc[j][2], dk_acc[j][3]);
      *reinterpret_cast<__nv_bfloat162*>(dv0 + down + 8 * j) =
          __floats2bfloat162_rn(dv_acc[j][2], dv_acc[j][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 3)
flash_tc_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ seg,
                const int* __restrict__ tile_min, const int* __restrict__ tile_max,
                const int* __restrict__ order, const float* __restrict__ lse,
                const float* __restrict__ delta, const bf16* __restrict__ dout,
                bf16* __restrict__ dq, int T_len, int H, int n_tiles, long long sb,
                long long st, float scale, float scale_log2) {
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // kTile x P
  bf16* dOs = Qs + kTile * P;                    // kTile x P
  bf16* Ks = dOs + kTile * P;                    // 2 stages x kTile x P
  bf16* Vs = Ks + 2 * kTile * P;                 // 2 stages x kTile x P
  int* seg_k = reinterpret_cast<int*>(Vs + 2 * kTile * P);  // 2 stages x kTile

  const int item = order[blockIdx.x];
  const int b = item / n_tiles, qt = item - b * n_tiles;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int q0 = qt * kTile;
  const long long base = (long long)b * sb + (long long)h * D;
  const long long dense_base = (long long)b * T_len * H * D + (long long)h * D;  // do, dq
  const long long dense_st = (long long)H * D;
  const int* seg_b = seg + (long long)b * T_len;
  const int* tmin = tile_min + (long long)b * n_tiles;
  const int* tmax = tile_max + (long long)b * n_tiles;
  const int qmin = tmin[qt], qmax = tmax[qt];

  // This thread's two query rows: segment ids, lse in log2 units, delta.
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float* lse_bh = lse + ((long long)b * H + h) * T_len;
  const float* delta_bh = delta + ((long long)b * H + h) * T_len;
  const int sq0 = r0 < T_len ? seg_b[r0] : 0, sq1 = r1 < T_len ? seg_b[r1] : 0;
  const float lz0 = r0 < T_len ? lse_bh[r0] * kLog2e : 0.0f;
  const float lz1 = r1 < T_len ? lse_bh[r1] * kLog2e : 0.0f;
  const float dl0 = r0 < T_len ? delta_bh[r0] : 0.0f;
  const float dl1 = r1 < T_len ? delta_bh[r1] : 0.0f;

  int kt = next_meeting(tmin, tmax, 0, qt + 1, qmin, qmax);  // <= qt
  copy_tile<D>(Qs, q + base, st, q0, T_len);
  copy_tile<D>(dOs, dout + dense_base, dense_st, q0, T_len);
  copy_tile<D>(Ks, k + base, st, kt * kTile, T_len);
  copy_tile<D>(Vs, v + base, st, kt * kTile, T_len);
  copy_vec(seg_k, seg_b, kt * kTile, T_len);
  cp_async_commit();

  uint32_t qf[D / 16][4], df[D / 16][4];
  float dq_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.0f;

  for (int stage = 0, first = 1; kt <= qt; stage ^= 1, first = 0) {
    cp_async_wait_all();
    __syncthreads();  // tile kt is in; every warp is done with the other stage
    if (first) {
      load_a<D>(qf, Qs, warp * 16, lane);
      load_a<D>(df, dOs, warp * 16, lane);
    }
    const int next = next_meeting(tmin, tmax, kt + 1, qt + 1, qmin, qmax);
    if (next <= qt) {
      const int s1 = stage ^ 1;
      copy_tile<D>(Ks + s1 * kTile * P, k + base, st, next * kTile, T_len);
      copy_tile<D>(Vs + s1 * kTile * P, v + base, st, next * kTile, T_len);
      copy_vec(seg_k + s1 * kTile, seg_b, next * kTile, T_len);
    }
    cp_async_commit();

    const bf16* Kt = Ks + stage * kTile * P;
    const bf16* Vt = Vs + stage * kTile * P;
    const int* sk = seg_k + stage * kTile;
    const int k0 = kt * kTile;

    const bool all_in = interior(qt, kt, qmin, qmax, tmin[kt], tmax[kt], T_len);

    // This warp's 16 queries as rows, the tile's keys as columns, kColsQ at
    // a time: S and dP, then dS, then its share of dQ.
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kColsQ) {
      float s[kColsQ / 8][4], dp[kColsQ / 8][4];
      gemm_nt<D, kColsQ>(s, qf, Kt, c0, lane);
      gemm_nt<D, kColsQ>(dp, df, Vt, c0, lane);
#pragma unroll
      for (int n = 0; n < kColsQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + n * 8 + 2 * c + (e & 1);
          const bool lower = e >= 2;
          const bool vis = all_in || (lower ? visible(r1, k0 + col, T_len, sq1, sk[col])
                                            : visible(r0, k0 + col, T_len, sq0, sk[col]));
          const float p = vis ? exp2f(fmaf(s[n][e], scale_log2, -(lower ? lz1 : lz0))) : 0.0f;
          dp[n][e] = p * (dp[n][e] - (lower ? dl1 : dl0)) * scale;
        }
      gemm_nn_split<D, kColsQ>(dq_acc, dp, Kt, c0, lane);
    }
    kt = next;
  }

  bf16* dq0 = dq + dense_base + (long long)r0 * dense_st + 2 * c;
  const long long down = 8 * dense_st;  // row r1
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < T_len)
      *reinterpret_cast<__nv_bfloat162*>(dq0 + 8 * j) = __floats2bfloat162_rn(dq_acc[j][0], dq_acc[j][1]);
    if (r1 < T_len)
      *reinterpret_cast<__nv_bfloat162*>(dq0 + down + 8 * j) =
          __floats2bfloat162_rn(dq_acc[j][2], dq_acc[j][3]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* seg, const void* tile_min,
           const void* tile_max, const void* order_q, const void* order_k, const void* o,
           const void* lse, const void* dout, void* delta, void* dq, void* dk, void* dv, int B,
           int T_len, int H, long long sb, long long st, float scale, cudaStream_t stream) {
  const long long rows = (long long)B * T_len * H;
  const long long rows_per_block = kThreads / (D / 8);
  flash_tc_bwd_delta<D><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), kThreads, 0,
                          stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(delta),
      T_len, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_tiles = (T_len + kTile - 1) / kTile;
  const dim3 grid((unsigned)B * n_tiles, H);
  const float scale_log2 = scale * kLog2e;
  const size_t tiles = sizeof(bf16) * 6 * kTile * (D + 8);
  const size_t smem_dkdv = tiles + sizeof(int) * 6 * kTile;  // + seg, lse, delta x 2 stages
  err = allow_smem(flash_tc_bwd_dkdv<D>, smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  flash_tc_bwd_dkdv<D><<<grid, kThreads, smem_dkdv, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const int*>(tile_min),
      static_cast<const int*>(tile_max), static_cast<const int*>(order_k),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dk), static_cast<bf16*>(dv), T_len, H,
      n_tiles, sb, st, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_dq = tiles + sizeof(int) * 2 * kTile;  // + seg x 2 stages
  err = allow_smem(flash_tc_bwd_dq<D>, smem_dq);
  if (err != cudaSuccess) return (int)err;
  flash_tc_bwd_dq<D><<<grid, kThreads, smem_dq, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const int*>(tile_min),
      static_cast<const int*>(tile_max), static_cast<const int*>(order_q),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), T_len, H, n_tiles, sb, st, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes: every pointer and the stream are void*.
// q, k, v (bf16) share the element strides sb and st; seg, o, lse, do, the
// f32 scratch delta (B,H,T) and the outputs dq, dk, dv are contiguous.
// tile_min/tile_max are the forward's per-tile segment-id ranges; order_q
// lists the query tiles (dq kernel) and order_k the key tiles (dk/dv
// kernel) in launch order. Launches the three kernels in order on
// ``stream``. Returns the first launch error (0 = all launched), or
// cudaErrorInvalidValue for a head width it was not built for.
extern "C" int flash_attn_tc_bwd_launch(const void* q, const void* k, const void* v,
                                        const void* seg, const void* tile_min,
                                        const void* tile_max, const void* order_q,
                                        const void* order_k, const void* o, const void* lse,
                                        const void* dout, void* delta, void* dq, void* dk,
                                        void* dv, int B, int T_len, int H, int D, long long sb,
                                        long long st, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, seg, tile_min, tile_max, order_q, order_k, o, lse, dout, delta,
                        dq, dk, dv, B, T_len, H, sb, st, scale, s);
    case 64:
      return launch<64>(q, k, v, seg, tile_min, tile_max, order_q, order_k, o, lse, dout, delta,
                        dq, dk, dv, B, T_len, H, sb, st, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
