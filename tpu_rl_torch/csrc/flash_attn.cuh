// Tiles, loads and the two tile products shared by the float32 forward
// (flash_attn_fwd.cu) and backward (flash_attn_bwd.cu) kernels of B4, the
// causal, segment-masked flash attention, on the CUDA cores. (bf16 inputs
// take the tensor-core kernels, flash_attn_tc.cuh.)
//
// A block runs kThreads = 256 threads as a 16 x 16 grid (ty, tx). Every
// tile is kTile = 64 rows; the thread owns rows ty + 16*i (i < 4) and
// columns tx + 16*j of a 64-wide product, so a warp (two values of ty, all
// sixteen of tx) reads two addresses of its row operand (a broadcast) and
// sixteen neighbouring rows or columns of the other. Tiles live in shared
// memory as f32 with a row pitch of D + 1 (or kTile + 1) floats: rows ty and
// ty + 1 then fall into different banks, and so do the sixteen rows tx.
// All arithmetic is plain f32 FMAs.

#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace flash {

constexpr int kTile = 64;        // rows of a query tile and of a key/value tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kPitchP = kTile + 1;
constexpr float kNegInf = -1e30f;  // tpu_rl's finite -inf (_NEG_INF)

// Rows t0 .. t0 + kTile - 1 of one (batch row, head) of x into a kTile x
// (D + 1) tile. ``base`` points at (b, t = 0, h, d = 0); rows are ``st``
// elements apart and d is dense. Rows at or past T are zeros, so that a
// masked entry's 0 weight never meets a NaN left in shared memory.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ base, long long st,
                                          int t0, int T_len) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e - (e / D) * D;
    const int t = t0 + r;
    dst[r * (D + 1) + c] = t < T_len ? base[(long long)t * st + c] : 0.0f;
  }
}

// Segment ids of rows t0 .. t0 + kTile - 1; rows past T get INT_MIN.
__device__ __forceinline__ void load_seg(int* dst, const int* __restrict__ seg_b, int t0,
                                         int T_len) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    dst[r] = t0 + r < T_len ? seg_b[t0 + r] : INT_MIN;
  }
}

// Query row qi sees key row kj: causal by index, same segment, qi inside T.
__device__ __forceinline__ bool visible(int qi, int kj, int T_len, int seg_q, int seg_k) {
  return qi < T_len && kj <= qi && seg_q == seg_k;
}

// acc[i][j] = sum_d A[ty + 16i][d] * B[tx + 16j][d]  (A Bᵀ of two kTile x D tiles)
template <int D>
__device__ __forceinline__ void dot_nt(float (&acc)[4][4], const float* A, const float* B,
                                       int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r P[ty + 16i][r] * X[r][tx + 16j]  (P X, P kTile x kTile
// with pitch kPitchP, X kTile x D with pitch D + 1)
template <int D>
__device__ __forceinline__ void dot_nn(float (&acc)[4][D / 16], const float* P, const float* X,
                                       int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    float p[4], x[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * kPitchP + r];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) x[j] = X[r * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(p[i], x[j], acc[i][j]);
  }
}

// Raise a kernel instance's dynamic shared-memory limit to ``smem`` bytes:
// a launch above 48 KB is refused without it.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace flash
