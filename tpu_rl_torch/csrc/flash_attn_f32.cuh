// Tensor-core building blocks of kernel B4's float32 path, the causal,
// segment-masked flash attention (flash_attn_f32_fwd.cu, flash_attn_f32_bwd.cu):
// split-precision TF32 products on mma.sync (3xTF32), f32 tile copies by
// cp.async, and the bf16 path's tile-skip rule and copy helpers
// (flash_attn_tc.cuh), which do not depend on the element type.
//
// Layout. A block runs kThreads = 128 threads, four warps; warp w owns rows
// 16w .. 16w + 15 of the block's 64-row tile (query rows in the forward and
// the dq kernel, key rows in the dk/dv kernel). Tiles sit in shared memory as
// f32 rows of D elements with a pitch of D + 4 floats. The fragment loads
// below read either (row g, column c) or (row 2c [+1], column g) for the
// lane l = 4g + c; with the pitch at 4 mod 32 banks both patterns fall on 32
// different banks, at D = 32 and at D = 64, and each row starts on 16 bytes
// for cp.async.
//
// Fragments (PTX ISA, mma.m16n8k8 .tf32): lane l = 4g + c holds
//   A (16 x 8): a0 = A[g][c]  a1 = A[g+8][c]  a2 = A[g][c+4]  a3 = A[g+8][c+4]
//   B (8 x 8):  b0 = B[c][g]  b1 = B[c+4][g]
//   C (16 x 8): c0, c1 = C[g][2c, 2c+1]  c2, c3 = C[g+8][2c, 2c+1]
// The accumulator of a score product feeds the next product (O += P V,
// dV += P^T dO, ...) as its A operand without a trip through shared memory:
// the 8-deep k step's slots c and c+4 are taken as keys 2c and 2c+1 (c0/c2
// and c1/c3 of the accumulator), and the B operand is read at the same keys.
//
// Split precision (3xTF32). A TF32 operand keeps 10 of f32's 23 mantissa
// bits, so one TF32 product misses B4's f32 bar by 15-63x (the CPU
// emulation in tests/test_torch_attention.py). Every f32 operand x is
// split into hi, x rounded to TF32 (to nearest, ties away from zero, by
// integer add and mask, as B1/B2's split_tf32 in lstm_common.cuh), and
// lo = x - hi (exact); a product a*b is lo_a*hi_b + hi_a*lo_b + hi_a*hi_b,
// three m16n8k8 TF32 mmas into one accumulator, the small terms first
// (lo*lo, ~2^-22 of the product, is dropped; the card reads lo's top 19
// bits). The emulation, with every mma's sum cut toward zero, uses at most
// 12% of the f32 bar (2e-5 on o and lse, 1e-4 on the gradients). B1/B2's
// other scheme, the cross terms as one bf16 m16n8k16 mma, uses up to 14%
// and saves one mma in three, but adds two bf16 packs per operand pair on
// the ALUs, which already split every B operand as it is loaded (six ALU
// operations a lane for every three mmas); it was not built here.

#pragma once

#include "flash_attn_tc.cuh"

namespace flash_f32 {

using flash_tc::allow_smem;
using flash_tc::copy_vec;
using flash_tc::cp_async16;
using flash_tc::cp_async_commit;
using flash_tc::cp_async_wait_all;
using flash_tc::interior;
using flash_tc::kFull;
using flash_tc::kLn2;
using flash_tc::kLog2e;
using flash_tc::kNegInf;
using flash_tc::kThreads;
using flash_tc::kTile;
using flash_tc::next_meeting;
using flash_tc::visible;

// Row pitch (floats) of a shared-memory tile of D-wide rows.
template <int D>
constexpr int kPitch = D + 4;

// x as hi (TF32 bits: rounded to nearest, ties away from zero, low 13 bits
// zero) and lo = x - hi (exact), both as mma operand registers.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c (16 x 8 f32) += A (16 x 8 tf32) * B (8 x 8 tf32). Registers only, so not
// volatile: the compiler may interleave independent mmas and loads.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split into its TF32 hi and lo parts.
struct AFrag {
  uint32_t hi[4], lo[4];
};

// A B fragment of one 8-column n-tile: b0, b1 as hi and lo.
struct BFrag {
  uint32_t hi[2], lo[2];
};

// c[n] += A B[n] for the N n-tiles of one 8-deep k step in split precision:
// all lo*hi mmas, then all hi*lo, then all hi*hi, so that no mma waits on
// the one before it.
template <int N>
__device__ __forceinline__ void mma3(float (&c)[N][4], const AFrag& a, const BFrag (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma(c[n], a.lo, b[n].hi[0], b[n].hi[1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(c[n], a.hi, b[n].lo[0], b[n].lo[1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(c[n], a.hi, b[n].hi[0], b[n].hi[1]);
}

// The A fragment of rows m0 .. m0 + 15, columns k0 .. k0 + 7 of a
// [64][pitch] tile (Q, dO, K or V as the left operand of a score product).
template <int D>
__device__ __forceinline__ void load_a(AFrag& f, const float* X, int m0, int k0, int lane) {
  const float* p = X + (m0 + lane / 4) * kPitch<D> + k0 + lane % 4;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * kPitch<D>], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * kPitch<D> + 4], f.hi[3], f.lo[3]);
}

// Accumulator n-tile t (16 x 8, f32) as the A fragment of the next product,
// its slots c and c+4 at columns 2c and 2c+1.
__device__ __forceinline__ void acc_as_a(AFrag& f, const float (&t)[4]) {
  split(t[0], f.hi[0], f.lo[0]);
  split(t[2], f.hi[1], f.lo[1]);
  split(t[1], f.hi[2], f.lo[2]);
  split(t[3], f.hi[3], f.lo[3]);
}

// s (16 x N, N/8 n-tiles) = A[m0 .. m0 + 16) X[n0 .. n0 + N)^T over D, A and X
// [64][pitch] tiles: one score product (S = Q K^T, dP = dO V^T, or their
// transposes). The sum over D runs in the tensor core, from zero.
template <int D, int N>
__device__ __forceinline__ void gemm_nt(float (&s)[N / 8][4], const float* A, int m0,
                                        const float* X, int n0, int lane) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
  const float* xb = X + (n0 + lane / 4) * kPitch<D> + lane % 4;  // row n0 + g, column c
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    AFrag a;
    load_a<D>(a, A, m0, 8 * kk, lane);
    BFrag b[N / 8];
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const float* p = xb + 8 * n * kPitch<D> + 8 * kk;
      split(p[0], b[n].hi[0], b[n].lo[0]);
      split(p[4], b[n].hi[1], b[n].lo[1]);
    }
    mma3<N / 8>(s, a, b);
  }
}

// f (16 x D) += P X[k0 .. k0 + K) with P (16 x K, K/8 accumulator n-tiles,
// f32) and X a [64][pitch] tile: O += P V, dV += P^T dO, dK += dS^T Q,
// dQ += dS K over K rows of X. The caller passes a fresh (zero) f and adds
// it to its running sum in f32, so that the tensor core sums at most K
// terms (its sums are not rounded to nearest).
template <int D, int K>
__device__ __forceinline__ void gemm_nn(float (&f)[D / 8][4], const float (&p)[K / 8][4],
                                        const float* X, int k0, int lane) {
  const float* xb = X + (k0 + 2 * (lane % 4)) * kPitch<D> + lane / 4;  // row k0 + 2c, column g
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    AFrag a;
    acc_as_a(a, p[kk]);
    BFrag b[D / 8];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float* q = xb + 8 * kk * kPitch<D> + 8 * n;
      split(q[0], b[n].hi[0], b[n].lo[0]);
      split(q[kPitch<D>], b[n].hi[1], b[n].lo[1]);
    }
    mma3<D / 8>(f, a, b);
  }
}

// Rows t0 .. t0 + 63 of a (T, D) f32 slice, row r at base + r * st, into a
// kTile x pitch tile by 16-byte cp.async; rows at or past T are zeros, so a
// masked entry's 0 weight never meets a NaN left in shared memory.
template <int D>
__device__ __forceinline__ void copy_tile(float* dst, const float* __restrict__ base,
                                          long long st, int t0, int T_len) {
  constexpr int kChunks = D / 4;  // 16-byte pieces of a row
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const int t = t0 + r;
    const bool in = t < T_len;
    cp_async16(dst + r * kPitch<D> + c * 4, base + (in ? (long long)t * st : 0) + c * 4, in);
  }
}

}  // namespace flash_f32
