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
// What bounds it on an H100. At the training shape (B=128, S=5, H=64) it
// moves ~1.97 MB (acts and dxp 655 KB each, cs, dhs and dcs 164 KB each,
// wh 64 KB, c0, keep, dh0, dc0), ~0.59 us at 3.35 TB/s, and does
// 2*B*S*4H*H = 21 MFLOP in the carry product, ~0.31 us at 67 TFLOP/s:
// bound by bytes. At B=1024, S=16, H=1024: 137 GFLOP, bound by operations.
//
// What this first design does about it. The same scheme as the forward:
// one block owns kRows rows for all S steps, the reverse time loop runs
// inside it, and the carries dh, dc and the step's dz live in shared memory
// rows innermost, with a __syncthreads() between the elementwise gate
// gradients and the carry product. The product reads wh^T (4H, H), which
// the wrapper transposes once per call, so that the threads of a warp,
// which own neighbouring output columns j, read neighbouring addresses
// wt[col*H + j] (reading wh itself there would put them 4H floats apart).
// The product's reduction is 4H long; when H < 256 threads it is split
// over 256/H slices of the 4H columns, whose partial sums meet in shared
// memory, so that every thread works. Plain f32 FMAs, no fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;       // batch rows per block (ragged last tile masked)
constexpr int kThreads = 256;  // 8 warps
static_assert(kRows == 8, "the product reads a column of dz_s as two float4");

__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const float* __restrict__ acts, const float* __restrict__ cs,
                const float* __restrict__ c0, const float* __restrict__ keep,
                const float* __restrict__ dhs, const float* __restrict__ dcs,
                const float* __restrict__ wt, float* __restrict__ dxp,
                float* __restrict__ dh0, float* __restrict__ dc0, int B, int S, int H,
                int nsplit) {
  extern __shared__ float4 smem4[];
  float* dz_s = reinterpret_cast<float*>(smem4);  // 4H x kRows
  float* dh_s = dz_s + (size_t)4 * H * kRows;      // H x kRows, carry dh
  float* dc_s = dh_s + (size_t)H * kRows;          // H x kRows, carry dc
  float* red_s = dc_s + (size_t)H * kRows;         // nsplit x H x kRows (nsplit > 1)

  const int G = 4 * H;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  const int tid = threadIdx.x;
  const int chunk = (G + nsplit - 1) / nsplit;  // columns of one slice

  for (int e = tid; e < kRows * H; e += kThreads) {
    dh_s[e] = 0.0f;
    dc_s[e] = 0.0f;
  }
  __syncthreads();

  for (int t = S - 1; t >= 0; --t) {
    // 1. Gate gradients: thread owns element (r, j).
    for (int e = tid; e < kRows * H; e += kThreads) {
      const int r = e / H, j = e - r * H;
      const int s = j * kRows + r;
      float dzi = 0.0f, dzf = 0.0f, dzg = 0.0f, dzo = 0.0f;
      if (r < rows) {
        const size_t b = row0 + r;
        const size_t bt = b * S + t;
        const float* a = acts + bt * G;
        const float i = a[j], f = a[H + j], g = a[2 * H + j], o = a[3 * H + j];
        const float kp = keep[bt];
        const float cp = t > 0 ? cs[(bt - 1) * H + j] : c0[b * H + j];
        const float cp_used = cp * kp;
        const float dh_t = dhs[bt * H + j] + dh_s[s];
        const float tc = tanhf(cs[bt * H + j]);
        const float d_o = dh_t * tc;
        const float dc_t = dcs[bt * H + j] + dc_s[s] + dh_t * o * (1.0f - tc * tc);
        dzi = dc_t * g * i * (1.0f - i);
        dzf = dc_t * cp_used * f * (1.0f - f);
        dzg = dc_t * i * (1.0f - g * g);
        dzo = d_o * o * (1.0f - o);
        float* out = dxp + bt * G;
        out[j] = dzi;
        out[H + j] = dzf;
        out[2 * H + j] = dzg;
        out[3 * H + j] = dzo;
        dc_s[s] = dc_t * f * kp;
      }
      dz_s[j * kRows + r] = dzi;
      dz_s[(H + j) * kRows + r] = dzf;
      dz_s[(2 * H + j) * kRows + r] = dzg;
      dz_s[(3 * H + j) * kRows + r] = dzo;
    }
    __syncthreads();

    // 2. dh = (dz @ wh^T) * keep[t]: unit u owns column j of slice sl.
    for (int u = tid; u < nsplit * H; u += kThreads) {
      const int sl = u / H, j = u - sl * H;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      const int c_end = min(G, (sl + 1) * chunk);
#pragma unroll 4
      for (int col = sl * chunk; col < c_end; ++col) {
        const float w = wt[(size_t)col * H + j];
        const float4 lo = reinterpret_cast<const float4*>(dz_s)[2 * col];
        const float4 hi = reinterpret_cast<const float4*>(dz_s)[2 * col + 1];
        acc[0] = fmaf(lo.x, w, acc[0]);
        acc[1] = fmaf(lo.y, w, acc[1]);
        acc[2] = fmaf(lo.z, w, acc[2]);
        acc[3] = fmaf(lo.w, w, acc[3]);
        acc[4] = fmaf(hi.x, w, acc[4]);
        acc[5] = fmaf(hi.y, w, acc[5]);
        acc[6] = fmaf(hi.z, w, acc[6]);
        acc[7] = fmaf(hi.w, w, acc[7]);
      }
      float* dst = nsplit == 1 ? dh_s : red_s + (size_t)sl * H * kRows;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float kp = r < rows ? keep[(size_t)(row0 + r) * S + t] : 0.0f;
        dst[j * kRows + r] = nsplit == 1 ? acc[r] * kp : acc[r];
      }
    }
    __syncthreads();
    if (nsplit > 1) {
      // 3. Sum the slices' partial products.
      for (int e = tid; e < kRows * H; e += kThreads) {
        const int r = e % kRows;
        float sum = 0.0f;
        for (int sl = 0; sl < nsplit; ++sl) sum += red_s[(size_t)sl * H * kRows + e];
        const float kp = r < rows ? keep[(size_t)(row0 + r) * S + t] : 0.0f;
        dh_s[e] = sum * kp;
      }
      __syncthreads();
    }
  }

  for (int e = tid; e < kRows * H; e += kThreads) {
    const int r = e / H, j = e - r * H;
    if (r < rows) {
      const size_t b = row0 + r;
      dh0[b * H + j] = dh_s[j * kRows + r];
      dc0[b * H + j] = dc_s[j * kRows + r];
    }
  }
}

}  // namespace

// Plain C entry, bound with ctypes: every pointer and the stream are void*;
// `wt` is wh transposed, (4H, H) row-major. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int lstm_bwd_launch(const void* acts, const void* cs, const void* c0,
                               const void* keep, const void* dhs, const void* dcs,
                               const void* wt, void* dxp, void* dh0, void* dc0, int B,
                               int S, int H, void* stream) {
  const int nsplit = H >= kThreads ? 1 : kThreads / H;
  const size_t floats =
      (size_t)kRows * H * (6 + (nsplit > 1 ? (size_t)nsplit : 0));
  const size_t smem = sizeof(float) * floats;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acts), static_cast<const float*>(cs),
      static_cast<const float*>(c0), static_cast<const float*>(keep),
      static_cast<const float*>(dhs), static_cast<const float*>(dcs),
      static_cast<const float*>(wt), static_cast<float*>(dxp), static_cast<float*>(dh0),
      static_cast<float*>(dc0), B, S, H, nsplit);
  return (int)cudaGetLastError();
}
