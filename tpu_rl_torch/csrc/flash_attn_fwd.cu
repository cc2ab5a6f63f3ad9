// Flash attention, forward (kernel B4), causal and segment-masked, float32
// in, f32 arithmetic on the CUDA cores, for sm_90a. (bf16 inputs take the
// tensor-core kernel, flash_attn_tc_fwd.cu: TF32 products would miss the
// f32 path's 2e-5 bar.)
//
// Replaces: tpu_rl/parallel/sequence.py, flash_attention_tpu (the Pallas TPU
// flash-attention kernel that ships with JAX, called with SegmentIds and
// causal=True). For every batch row b, head h and query row i:
//
//   s_j   = scale * q[b,i,h,:] . k[b,j,h,:]     for j <= i and seg[b,j] == seg[b,i]
//   o     = sum_j softmax(s)_j * v[b,j,h,:]      every other j is masked
//   lse   = log sum_j exp(s_j)                   (B,H,T) f32, for the backward
//
// q, k, v are (B,T,H,D) in tpu_rl's layout, read in place: they may be
// strided views (q = qkv[:, :, 0] has rows 3*H*D apart), with d dense and
// heads D apart; the three share their strides. o is (B,T,H,D) contiguous.
//
// What bounds it on an H100. At (2,2048,8,64) f32 it moves ~34 MB (q, k, v,
// o, seg, lse), ~0.01 ms at 3.35 TB/s, and does 2*B*H*T^2*D = 8.6 GFLOP
// under the causal mask (two products of half the T x T scores), ~0.13 ms
// at the 67 TFLOP/s f32 peak: bound by operations.
//
// What this first design does about it. It is simple and exact rather than
// fast: plain f32 FMAs on the CUDA cores, no TMA, no pipelining. One block
// per (query tile of 64 rows, h, b); the block walks the key/value tiles up
// to the diagonal and skips the tiles that causality masks entirely. Q, the
// current K and V tiles and the tile's probabilities sit in shared memory as
// f32 (67 KB at D=64, so dynamic shared memory). Each thread owns 4 x 4
// scores and 4 x D/16 outputs and keeps an online softmax (running max m and
// normaliser l per row, reduced across the sixteen threads of a row with
// warp shuffles) and an f32 output accumulator. Masked entries get an
// explicit 0 weight. The query tiles with the most key tiles start first.

#include "flash_attn.cuh"

namespace {

using namespace flash;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg,
                 float* __restrict__ o, float* __restrict__ lse, int T_len, int H, long long sb,
                 long long st, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // kTile x (D+1)
  float* Ks = Qs + kTile * (D + 1);       // kTile x (D+1)
  float* Vs = Ks + kTile * (D + 1);       // kTile x (D+1)
  float* Ps = Vs + kTile * (D + 1);       // kTile x kPitchP
  int* seg_q = reinterpret_cast<int*>(Ps + kTile * kPitchP);
  int* seg_k = seg_q + kTile;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * kTile;
  const long long base = (long long)b * sb + (long long)h * D;
  const int* seg_b = seg + (long long)b * T_len;

  load_tile<D>(Qs, q + base, st, q0, T_len);
  load_seg(seg_q, seg_b, q0, T_len);

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    load_tile<D>(Ks, k + base, st, k0, T_len);
    load_tile<D>(Vs, v + base, st, k0, T_len);
    load_seg(seg_k, seg_b, k0, T_len);
    __syncthreads();

    float s[4][4];
    dot_nt<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        s[i][j] = visible(q0 + r, k0 + c, T_len, seg_q[r], seg_k[c]) ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      // the sixteen threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] <= 0.5f * kNegInf ? 0.0f : expf(s[i][j] - m_new);
        Ps[r * kPitchP + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      m[i] = m_new;
      l[i] = l[i] * alpha + row_sum;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    dot_nn<D>(acc, Ps, Vs, ty, tx);
    __syncthreads();  // before the next tile overwrites Ks, Vs, Ps
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T_len) continue;
    const float li = fmaxf(l[i], 1e-30f);
    float* orow = o + (((long long)b * T_len + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) orow[tx + 16 * j] = acc[i][j] / li;
    if (tx == 0) lse[((long long)b * H + h) * T_len + t] = m[i] + logf(li);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* seg, void* o, void* lse,
           int B, int T_len, int H, long long sb, long long st, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (3 * (size_t)kTile * (D + 1) + (size_t)kTile * kPitchP) +
      sizeof(int) * 2 * kTile;
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + kTile - 1) / kTile, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<float*>(o), static_cast<float*>(lse), T_len, H,
      sb, st, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes: every pointer and the stream are void*.
// q, k, v (float32) share the element strides sb (batch) and st (time); seg
// (B,T) int32, o (B,T,H,D) and lse (B,H,T) f32 are contiguous. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head width it was not built for.
extern "C" int flash_attn_fwd_launch(const void* q, const void* k, const void* v,
                                     const void* seg, void* o, void* lse, int B, int T_len,
                                     int H, int D, long long sb, long long st, float scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, seg, o, lse, B, T_len, H, sb, st, scale, s);
    case 64: return launch<64>(q, k, v, seg, o, lse, B, T_len, H, sb, st, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
