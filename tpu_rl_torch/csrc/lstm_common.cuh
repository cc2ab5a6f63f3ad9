// Pieces shared by the LSTM unroll kernels B1 (lstm_fwd.cu) and B2
// (lstm_bwd.cu), f32, for sm_90a: the launch plan's sizes, asynchronous
// copies, the cluster barrier, and the two register-tiled products.
//
// Both kernels split a row tile's hidden units across a thread-block
// cluster: block q of the cluster owns units [q*U, q*U + U) with all four
// of their gate columns, wh[:, g*H + q*U + j] for g = 0..3, j < U: "the
// block's slice" (4U columns). Resident regime: thread (ry, x) of a block,
// x = tid % (U/TU) fastest, owns rows ry*TM .. ry*TM + TM-1 of the tile
// and units x*TU .. x*TU + TU-1 of the slice (CUDA-core FMAs). Streamed
// regime: warps own units and m-tiles of 16 rows (tensor-core mmas).
// ops/lstm.lstm_launch_plan chooses every size.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "device_once.cuh"

namespace lstm {

namespace cg = cooperative_groups;

constexpr int kMaxSmem = 232448;       // bytes a block may use on sm_90
constexpr int kResidentThreads = 512;  // resident regime: at most (128 registers a thread)
constexpr int kStreamedThreads = 512;  // streamed regime: 16 warps of 8 units (128 registers)
constexpr int kKC = 16;                // streamed regime: k (B1) or gate columns (B2) per stage
constexpr int kLDK = kKC + 4;          // streamed: row length of a [row][k] stage tile

// The launch plan (ops/lstm.LstmPlan), as the C entries receive it.
struct Plan {
  int B, S, H;
  int R;          // rows per tile
  int U;          // hidden units per block
  int C;          // blocks per cluster (unit slices)
  int row_tiles;  // clusters in the grid
  int stages;     // streamed regime: ring depth
  int push;       // resident B2: partial dh over DSMEM (else through the global scratch)
  int smem;       // dynamic shared memory, bytes
};

__device__ __forceinline__ float sigmoid_f(float z) { return 1.0f / (1.0f + expf(-z)); }

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Streamed regime: row length of a [k][4U] stage tile of the slice, 4U
// padded to 8 mod 32 floats, so that the mma's B fragments (lanes g + 8 t
// apart) fall on 32 banks.
__host__ __device__ __forceinline__ int stream_ldw(int U) { return 4 * U + ((8 - 4 * U) % 32 + 32) % 32; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, asynchronously, through L1; zeros when !valid.
// Only for data no block of the launch writes (wh).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// 16 bytes global -> shared, asynchronously, from L2 (not L1, which may
// hold lines of data another block of the cluster wrote since); zeros when
// !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n committed groups are pending (0 <= n <= 3).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
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

// The end of a step: every block of the cluster has written (to its peers'
// shared memory or to global memory) what the next step reads, and sees
// what its peers wrote. It also separates the threads of a block.
__device__ __forceinline__ void cluster_step_barrier() {
  cluster_arrive_release();
  cluster_wait_acquire();
}

// TM consecutive floats of shared memory (16-byte aligned when TM % 4 == 0).
template <int TM>
__device__ __forceinline__ void load_rows(float (&v)[TM], const float* p) {
  if constexpr (TM % 4 == 0) {
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i) v[i] = p[i];
  }
}

// B1's product: acc[g][i][j] += sum_k a[k*lda + ry*TM + i] * w[k*ldw + g*U +
// x*TU + j] over k = 0..n-1, one FMA chain per output in ascending k. a is
// h, rows innermost ([k][r]); w is the slice, gate columns innermost.
template <int TM, int TU>
__device__ __forceinline__ void fwd_fma(float (&acc)[4][TM][TU], const float* a, int lda,
                                        const float* w, int ldw, int U, int ry, int x, int n) {
  const float* ap = a + ry * TM;
  const float* wp = w + x * TU;
  constexpr int kUnroll = TM * TU >= 16 ? 1 : 4;  // large tiles: registers first
#pragma unroll kUnroll
  for (int k = 0; k < n; ++k) {
    float av[TM], wv[4][TU];
    load_rows<TM>(av, ap + k * lda);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int j = 0; j < TU; ++j) wv[g][j] = wp[k * ldw + g * U + j];
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TU; ++j) acc[g][i][j] = fmaf(av[i], wv[g][j], acc[g][i][j]);
      }
    }
  }
}

// B2's product: acc[i][j] += sum_c a[c*lda + ry*TM + i] * w[c + j*wj] over
// c = 0..n-1, one FMA chain per output in ascending c. a is dz, rows
// innermost ([c][r]); w + j*wj is the slice's row (gate columns innermost)
// of the thread's j-th unit of the window.
template <int TM, int TK>
__device__ __forceinline__ void bwd_fma(float (&acc)[TM][TK], const float* a, int lda,
                                        const float* w, int wj, int ry, int n) {
  const float* ap = a + ry * TM;
  constexpr int kUnroll = TM * TK >= 32 ? 1 : 4;
#pragma unroll kUnroll
  for (int c = 0; c < n; ++c) {
    float av[TM], wv[TK];
    load_rows<TM>(av, ap + c * lda);
#pragma unroll
    for (int j = 0; j < TK; ++j) wv[j] = w[c + j * wj];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TK; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }
}

// Split-precision products on the tensor cores (streamed regime). A float
// x is split into hi, x rounded to TF32 (10 mantissa bits, to nearest, ties
// away from zero), and lo = x - hi (exact, |lo| <= 2^-11 |x|); a product
// a*b is hi*hi + (hi*lo + lo*hi). hi*hi is an m16n8k8 TF32 mma (exact
// products); the two cross terms are one m16n8k16 BF16 mma whose 16-deep k
// holds (a_hi, a_lo) against (b_lo, b_hi) for the same 8 k, each value
// rounded to bf16 the same way: 2^-8 of terms below 2^-11 is ~2^-18 of
// the product, where one TF32 product keeps ~2^-11. Integer adds, masks and
// byte permutes only: the conversion instructions (cvt.rna.tf32,
// cvt.rn.bf16x2) run at a fraction of the ALU rate, and at ~100 a warp per
// 8-deep step they held the kernel back. Rounding, not cutting: cut values
// bias every cross term the same way, and over H terms that drifts past
// the 1e-5 bar.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, float& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = x - __uint_as_float(hi);
}

// Two floats as bf16x2, each rounded (to nearest, ties away from zero):
// lo_k in the low half.
__device__ __forceinline__ uint32_t pack_bf16(uint32_t lo_k, uint32_t hi_k) {
  return __byte_perm(lo_k + 0x8000u, hi_k + 0x8000u, 0x7632);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment for both mmas: the TF32 one's hi parts (a0..a3 of its
// layout: rows g, g+8 at k t, then at k t+4) and the BF16 one's (rows g,
// g+8; its k slots 2t, 2t+1 hold hi at k t, t+4, and slots 2t+8, 2t+9 hold
// lo at the same k).
struct AFrag {
  uint32_t hi[4], x[4];
};

// The B fragment of one 8-column tile: the TF32 mma's hi values at k t,
// t+4 and the BF16 one's (lo against A's hi slots, hi against A's lo).
struct BFrag {
  uint32_t hi[2], x[2];
};

__device__ __forceinline__ void make_a(AFrag& f, const float (&v)[4]) {
  float lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(v[e], f.hi[e], lo[e]);
  f.x[0] = pack_bf16(f.hi[0], f.hi[2]);
  f.x[1] = pack_bf16(f.hi[1], f.hi[3]);
  f.x[2] = pack_bf16(__float_as_uint(lo[0]), __float_as_uint(lo[2]));
  f.x[3] = pack_bf16(__float_as_uint(lo[1]), __float_as_uint(lo[3]));
}

__device__ __forceinline__ void make_b(BFrag& f, float b0, float b1) {
  float lo0, lo1;
  split_tf32(b0, f.hi[0], lo0);
  split_tf32(b1, f.hi[1], lo1);
  f.x[0] = pack_bf16(__float_as_uint(lo0), __float_as_uint(lo1));
  f.x[1] = pack_bf16(f.hi[0], f.hi[1]);
}

// c0 += a @ b0 and c1 += a @ b1 for two 16x8 tiles sharing the A fragment,
// over one 8-deep k step: the cross terms, then hi*hi, summed by the tensor
// core into fresh zero fragments, then added to c by the CUDA cores (round
// to nearest: the tensor core's own f32 sums do not, and across the H/8
// steps of a product into one sum their error grows past the 1e-5 bar).
// The two tiles' mmas alternate, so that neither waits on its own
// previous one.
__device__ __forceinline__ void mma_split_x2(float (&c0)[4], float (&c1)[4], const AFrag& a,
                                             const BFrag& b0, const BFrag& b1) {
  float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(d0, a.x, b0.x[0], b0.x[1]);
  mma_bf16(d1, a.x, b1.x[0], b1.x[1]);
  mma_tf32(d0, a.hi, b0.hi[0], b0.hi[1]);
  mma_tf32(d1, a.hi, b1.hi[0], b1.hi[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    c0[e] += d0[e];
    c1[e] += d1[e];
  }
}

// The A fragment of m-tile rows [r0, r0+16) and k [k0, k0+8) of a
// [row][kLDK] stage tile: lane (g = lane/4, t = lane%4) holds rows r0+g,
// r0+g+8 at k k0+t, k0+t+4 (kLDK = 20: the 32 lanes' words fall on 32
// banks).
__device__ __forceinline__ void load_a(AFrag& f, const float* tile, int r0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (r0 + g) * kLDK + k0 + t;
  const float v[4] = {p[0], p[8 * kLDK], p[4], p[8 * kLDK + 4]};
  make_a(f, v);
}

// The block's slice of wh, resident: ws[k*(4U+1) + g*U + j] = wh[k, g*H +
// u0 + j] for k < H, zeros for j >= uval (rows past H, up to B2's last
// window, stay unwritten: their products are dropped). The odd row length
// puts the rows of one column on distinct banks (B2 reads down a column).
// One group of 4-byte copies, committed.
__device__ __forceinline__ void load_slice(float* ws, const float* wh, int H, int U, int u0,
                                           int uval) {
  const int n = H * 4 * U;
  const size_t G = 4 * (size_t)H;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = i / (4 * U), col = i - k * 4 * U;
    const int g = col / U, j = col - g * U;
    const bool ok = j < uval;
    cp_async4(ws + k * (4 * U + 1) + col, ok ? wh + k * G + (size_t)g * H + u0 + j : wh, ok);
  }
  cp_async_commit();
}

// One launch attribute: the cluster's size along x.
inline cudaLaunchConfig_t make_config(cudaLaunchAttribute* attr, int cluster, int row_tiles,
                                      int threads, int smem, cudaStream_t stream) {
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

template <typename K>
cudaError_t allow_large(K kernel) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

}  // namespace lstm
