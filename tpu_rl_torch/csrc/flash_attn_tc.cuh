// Tensor-core building blocks of kernel B4's bf16 path, the causal,
// segment-masked flash attention (flash_attn_tc_fwd.cu, flash_attn_tc_bwd.cu):
// mma.sync.m16n8k16 bf16 products with f32 accumulation, ldmatrix fragment
// loads, cp.async tile copies, the hi/lo bf16 split and the tile-skip rule.
//
// Layout. A block runs kThreads = 128 threads, four warps; warp w owns rows
// 16w .. 16w + 15 of the block's 64-row tile (query rows in the forward and
// the dq kernel, key rows in the dk/dv kernel). Tiles sit in shared memory as
// bf16 rows of D elements with a pitch of D + 8: the eight 16-byte row pieces
// that one ldmatrix phase reads then fall into eight different bank groups,
// at D = 32 and at D = 64.
//
// Fragments (PTX ISA, mma.m16n8k16 .bf16): lane l = 4g + c holds
//   A (16 x 16): a0 = A[g][2c, 2c+1]  a1 = A[g+8][2c, 2c+1]
//                a2 = A[g][2c+8, 2c+9]  a3 = A[g+8][2c+8, 2c+9]
//   B (16 x 8):  b0 = B[2c, 2c+1][g]  b1 = B[2c+8, 2c+9][g]
//   C (16 x 8):  c0, c1 = C[g][2c, 2c+1]  c2, c3 = C[g+8][2c, 2c+1]
// so the accumulator of a 16 x 64 product (eight n-tiles of 8 columns) is,
// two n-tiles at a time, the A operand of the next product without a trip
// through shared memory (FlashAttention-2's register reuse).
//
// The hi/lo split. The probabilities P and the score gradients dS are f32;
// the tensor cores take bf16. Rounding them once would give each element a
// relative error of up to 2^-9, far above B4's per-element bar on outputs
// that cancel to near zero. So each goes in as a pair, hi = bf16(x) and
// lo = bf16(x - hi), with two products into one f32 accumulator: ~17 bits
// of x, the idea of 3xTF32. q, k, v and do are bf16 already, so the score
// products S = Q K^T and dP = dO V^T are exact in f32 and need no split.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash_tc {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;           // rows of a query tile and of a key tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;   // tpu_rl's finite -inf (_NEG_INF)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// acc (16 x 8 f32) += A (16 x 16 bf16) * B (16 x 8 bf16). Registers only, so
// not volatile: the compiler may schedule it against the (volatile) loads.
__device__ __forceinline__ void mma(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Two f32 values (neighbouring columns) as hi = bf16(x) and lo = bf16(x - hi),
// each a bf16x2 register with the lower column in the low half.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Accumulator n-tiles t0 (columns 0-7) and t1 (8-15) of a 16 x 16 block as the
// hi and lo A fragments of the next product.
__device__ __forceinline__ void split_a(const float (&t0)[4], const float (&t1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(t0[0], t0[1], hi[0], lo[0]);
  split2(t0[2], t0[3], hi[1], lo[1]);
  split2(t1[0], t1[1], hi[2], lo[2]);
  split2(t1[2], t1[3], hi[3], lo[3]);
}

// Lane l's ldmatrix address (row, column) inside a 16 x 16 block. A
// fragments from a [m][k] tile: rows l % 16, columns 8 (l / 16).
__device__ __forceinline__ int a_row(int lane) { return lane % 16; }
__device__ __forceinline__ int a_col(int lane) { return 8 * (lane / 16); }
// Non-transposed B fragments of two n-tiles from a [n][k] tile: the n rows
// l % 8 + 8 (l / 16), the k columns 8 ((l / 8) % 2); registers come back as
// b0, b1 of n-tile 0 and b0, b1 of n-tile 1.
__device__ __forceinline__ int bn_row(int lane) { return lane % 8 + 8 * (lane / 16); }
__device__ __forceinline__ int bn_col(int lane) { return 8 * ((lane / 8) % 2); }
// Transposed B fragments of two n-tiles from a [k][n] tile: the k rows
// l % 8 + 8 ((l / 8) % 2), the n columns 8 (l / 16); the same registers.
__device__ __forceinline__ int bt_row(int lane) { return lane % 8 + 8 * ((lane / 8) % 2); }
__device__ __forceinline__ int bt_col(int lane) { return 8 * (lane / 16); }

// A fragments of rows m0 .. m0 + 15 of a [64][D + 8] tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* X, int m0, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(a[kk], X + (m0 + a_row(lane)) * (D + 8) + kk * 16 + a_col(lane));
}

// s (16 x N, N/8 n-tiles) = A (16 x D) X[n0 .. n0 + N)^T, X a [64][D + 8]
// tile: one score product (S = Q K^T, dP = dO V^T, or their transposes)
// over N of the tile's rows.
template <int D, int N>
__device__ __forceinline__ void gemm_nt(float (&s)[N / 8][4], const uint32_t (&a)[D / 16][4],
                                        const bf16* X, int n0, int lane) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, X + (n0 + np * 16 + bn_row(lane)) * (D + 8) + kk * 16 + bn_col(lane));
      mma(s[2 * np], a[kk], b[0], b[1]);
      mma(s[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x D) += P X[k0 .. k0 + K) with P (16 x K, K/8 n-tiles, f32) fed
// as its hi and lo bf16 parts and X a [64][D + 8] tile: O += P V,
// dV += P^T dO, dK += dS^T Q, dQ += dS K. Four products per 16 x 16 x 16
// step where one rounding of P would take two.
template <int D, int K>
__device__ __forceinline__ void gemm_nn_split(float (&acc)[D / 8][4], const float (&p)[K / 8][4],
                                              const bf16* X, int k0, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t hi[4], lo[4];
    split_a(p[2 * kk], p[2 * kk + 1], hi, lo);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, X + (k0 + kk * 16 + bt_row(lane)) * (D + 8) + dp * 16 + bt_col(lane));
      mma(acc[2 * dp], hi, b[0], b[1]);
      mma(acc[2 * dp], lo, b[0], b[1]);
      mma(acc[2 * dp + 1], hi, b[2], b[3]);
      mma(acc[2 * dp + 1], lo, b[2], b[3]);
    }
  }
}

// Rows t0 .. t0 + 63 of a (T, D) bf16 slice, row r at base + r * st, into a
// kTile x (D + 8) tile; rows at or past T are zeros, so a masked entry's 0
// weight never meets a NaN left in shared memory.
template <int D>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* __restrict__ base, long long st,
                                          int t0, int T_len) {
  constexpr int kChunks = D / 8;  // 16-byte pieces of a row
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const int t = t0 + r;
    const bool in = t < T_len;
    cp_async16(dst + r * (D + 8) + c * 8, base + (in ? (long long)t * st : 0) + c * 8, in);
  }
}

// Entries t0 .. t0 + 63 of a length-T row of 4-byte values (segment ids,
// lse, delta); zeros past T.
__device__ __forceinline__ void copy_vec(void* dst, const void* __restrict__ src, int t0,
                                         int T_len) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int t = t0 + r;
    const bool in = t < T_len;
    cp_async4(static_cast<char*>(dst) + 4 * r,
              static_cast<const char*>(src) + 4 * (in ? (long long)t : 0), in);
  }
}

// The tile-skip rule. tmin/tmax hold the segment-id range of every 64-row
// tile of one batch row. A (query tile, key tile) pair is visited iff it is
// causal (key tile <= query tile) and the two ranges overlap: for any int32
// ids no pair outside it holds a visible (query, key) element, and for the
// monotone ids of segment_ids_from_firsts the rule is tight.
// (tpu_rl_torch.ops.attention.visited_tiles is the same rule in Python.)
// Returns the first tile t in [from, end) whose range meets [lo, hi], or end.
__device__ __forceinline__ int next_meeting(const int* __restrict__ tmin,
                                            const int* __restrict__ tmax, int from, int end,
                                            int lo, int hi) {
  for (int t = from; t < end; ++t)
    if (tmax[t] >= lo && tmin[t] <= hi) return t;
  return end;
}

// Every element of the pair is visible: the key tile lies strictly below the
// diagonal, both tiles hold one and the same segment id, and the query tile
// ends inside T. Such a tile needs no element mask.
__device__ __forceinline__ bool interior(int qt, int kt, int qmin, int qmax, int kmin, int kmax,
                                         int T_len) {
  return kt < qt && qmin == qmax && kmin == kmax && qmin == kmin && (qt + 1) * kTile <= T_len;
}

// Query row qi sees key row kj: causal by index, same segment, qi inside T.
__device__ __forceinline__ bool visible(int qi, int kj, int T_len, int seg_q, int seg_k) {
  return qi < T_len && kj <= qi && seg_q == seg_k;
}

// Raise a kernel's dynamic shared-memory limit to ``smem`` bytes: a launch
// above 48 KB is refused without it.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace flash_tc
