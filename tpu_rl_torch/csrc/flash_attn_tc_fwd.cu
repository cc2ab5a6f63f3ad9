// Flash attention, forward (kernel B4), causal and segment-masked, bf16 in,
// on Hopper's tensor cores (mma.sync bf16, f32 accumulation), for sm_90a.
//
// Replaces: tpu_rl/parallel/sequence.py:608, flash_attention_tpu: JAX's
// library Pallas TPU flash-attention kernel (jax/experimental/pallas/ops/tpu/
// flash_attention.py), called at sequence.py:641-666 with SegmentIds and
// causal=True. For every batch row b, head h and query row i:
//
//   s_j   = scale * q[b,i,h,:] . k[b,j,h,:]     for j <= i and seg[b,j] == seg[b,i]
//   o     = sum_j softmax(s)_j * v[b,j,h,:]      every other j is masked
//   lse   = log sum_j exp(s_j)                   (B,H,T) f32, for the backward
//
// q, k, v are (B,T,H,D) in tpu_rl's layout, read in place as strided views
// (q = qkv[:, :, 0], rows 3*H*D apart) that share their strides; rows must
// start on 16 bytes (the wrapper checks). o is (B,T,H,D) contiguous bf16.
// float32 inputs take the split-TF32 kernel of flash_attn_f32_fwd.cu.
//
// What bounds it on an H100. At the main path's (16,2048,8,64) with one seam
// per row it moves ~135 MB (q, k, v, o, seg, lse), ~0.04 ms at 3.35 TB/s;
// its two products over the ~24M (query, key) pairs per head that the mask
// keeps are ~49 GFLOP, ~0.05 ms at the 989 TFLOP/s bf16 peak: bound by
// operations, both within a few percent.
//
// What the design does about it.
// - Tensor cores: S = Q K^T and O += P V run as mma.sync.m16n8k16 bf16 with
//   f32 accumulation (flash_attn_tc.cuh). One block of four warps per (query
//   tile of 64 rows, head, batch row); each warp owns 16 query rows, keeps
//   its Q fragments in registers, and its 16 x 64 scores, online softmax
//   (running max and sum per row, in f32) and 16 x D output in registers.
//   P goes from the score accumulator straight into the next product's A
//   operand. (A wgmma version that waits on each product before the
//   softmax measured slower; overlapping the two is ROADMAP queue D.)
// - Precision: P enters the product as a hi/lo pair of bf16, two MMAs into
//   one accumulator (flash_attn_tc.cuh), so o keeps ~17 bits of each weight:
//   3 products where one rounding of P would take 2. The TPU kernel rounds P
//   to bf16 once (p.astype(v.dtype)); the port's bar is per element and
//   tighter.
// - Asynchronous copies: K and V tiles (and their segment ids) arrive by
//   cp.async into a two-stage ring; the next visited tile loads while the
//   current one is computed, one __syncthreads per tile.
// - Tile skipping: the wrapper passes each 64-row tile's segment-id range;
//   a key tile is visited only if it is causal for the query tile and its
//   range meets the query tile's (next_meeting). Inside a visited tile the
//   element mask is exact, with an explicit 0 weight; tiles wholly inside
//   one segment and below the diagonal skip the mask.
// - Order: the grid walks the query tiles in the wrapper's order, the most
//   visited key tiles first, so the short tiles fill the tail.

#include "flash_attn_tc.cuh"

namespace {

using namespace flash_tc;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_tc_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ seg,
                    const int* __restrict__ tile_min, const int* __restrict__ tile_max,
                    const int* __restrict__ order, bf16* __restrict__ o, float* __restrict__ lse,
                    int T_len, int H, int n_tiles, long long sb, long long st, float scale_log2) {
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // kTile x P
  bf16* Ks = Qs + kTile * P;                     // 2 stages x kTile x P
  bf16* Vs = Ks + 2 * kTile * P;                 // 2 stages x kTile x P
  int* seg_k = reinterpret_cast<int*>(Vs + 2 * kTile * P);  // 2 stages x kTile

  const int item = order[blockIdx.x];
  const int b = item / n_tiles, qt = item - b * n_tiles;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int q0 = qt * kTile;
  const long long base = (long long)b * sb + (long long)h * D;
  const int* seg_b = seg + (long long)b * T_len;
  const int* tmin = tile_min + (long long)b * n_tiles;
  const int* tmax = tile_max + (long long)b * n_tiles;
  const int qmin = tmin[qt], qmax = tmax[qt];

  // This thread's two query rows and their segment ids.
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const int sq0 = r0 < T_len ? seg_b[r0] : 0;
  const int sq1 = r1 < T_len ? seg_b[r1] : 0;

  int kt = next_meeting(tmin, tmax, 0, qt + 1, qmin, qmax);  // <= qt: a tile meets itself
  copy_tile<D>(Qs, q + base, st, q0, T_len);
  copy_tile<D>(Ks, k + base, st, kt * kTile, T_len);
  copy_tile<D>(Vs, v + base, st, kt * kTile, T_len);
  copy_vec(seg_k, seg_b, kt * kTile, T_len);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;  // m in log2 units
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int stage = 0, first = 1; kt <= qt; stage ^= 1, first = 0) {
    cp_async_wait_all();
    __syncthreads();  // tile kt is in; every warp is done with the other stage
    if (first) load_a<D>(qf, Qs, warp * 16, lane);
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

    float s[8][4];
    gemm_nt<D, kTile>(s, qf, Kt, 0, lane);

    // Online softmax in log2 units. The row max of the raw scores over this
    // tile (the four lanes of a quad share a row; scale > 0, so the max of
    // the scaled scores is the scaled max), the rescale of what came before,
    // then the tile's weights exp2(scale_log2 * s - m) in one FMA each.
    const bool all_in = interior(qt, kt, qmin, qmax, tmin[kt], tmax[kt], T_len);
    if (!all_in) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * c + (e & 1);
          const bool vis = e < 2 ? visible(r0, k0 + col, T_len, sq0, sk[col])
                                 : visible(r1, k0 + col, T_len, sq1, sk[col]);
          if (!vis) s[n][e] = kNegInf;
        }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    // a row with nothing visible yet keeps m at kNegInf * scale_log2 or
    // below, and its rescale factor exp2(m - mn) is 0 or 1 on a zero sum
    const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.0f, ps1 = 0.0f;
    if (all_in) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = exp2f(fmaf(s[n][e], scale_log2, e < 2 ? -mn0 : -mn1));
    } else {
      // a masked entry gets an explicit 0: with nothing visible yet the
      // running max is as low as the masked scores, where exp2 would give 1
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = s[n][e] <= 0.5f * kNegInf
                        ? 0.0f
                        : exp2f(fmaf(s[n][e], scale_log2, e < 2 ? -mn0 : -mn1));
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + ps0;  // this lane's part of the row sum; the quad adds up at the end
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }
    gemm_nn_split<D, kTile>(acc, s, Vt, 0, lane);
    kt = next;
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  bf16* o0 = o + (((long long)b * T_len + r0) * H + h) * D + 2 * c;
  bf16* o1 = o0 + 8LL * H * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < T_len)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
          __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    if (r1 < T_len)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
          __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  if (c == 0) {
    float* lse_bh = lse + ((long long)b * H + h) * T_len;
    if (r0 < T_len) lse_bh[r0] = (m0 + log2f(l0)) * kLn2;
    if (r1 < T_len) lse_bh[r1] = (m1 + log2f(l1)) * kLn2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* seg, const void* tile_min,
           const void* tile_max, const void* order, void* o, void* lse, int B, int T_len, int H,
           long long sb, long long st, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * 5 * kTile * (D + 8) + sizeof(int) * 2 * kTile;
  cudaError_t err = allow_smem(flash_tc_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (T_len + kTile - 1) / kTile;
  const dim3 grid((unsigned)B * n_tiles, H);
  flash_tc_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(seg), static_cast<const int*>(tile_min),
      static_cast<const int*>(tile_max), static_cast<const int*>(order), static_cast<bf16*>(o),
      static_cast<float*>(lse), T_len, H, n_tiles, sb, st, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes: every pointer and the stream are void*.
// q, k, v (bf16) share the element strides sb (batch) and st (time); seg
// (B,T) int32, o (B,T,H,D) bf16 and lse (B,H,T) f32 are contiguous.
// tile_min/tile_max (B, ceil(T/64)) int32 are the segment-id range of each
// 64-row tile; order (B * ceil(T/64)) int32 lists the query tiles (b * n +
// tile) in launch order. Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for a head width it was not built for.
extern "C" int flash_attn_tc_fwd_launch(const void* q, const void* k, const void* v,
                                        const void* seg, const void* tile_min,
                                        const void* tile_max, const void* order, void* o,
                                        void* lse, int B, int T_len, int H, int D, long long sb,
                                        long long st, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, seg, tile_min, tile_max, order, o, lse, B, T_len, H, sb, st,
                        scale, s);
    case 64:
      return launch<64>(q, k, v, seg, tile_min, tile_max, order, o, lse, B, T_len, H, sb, st,
                        scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
