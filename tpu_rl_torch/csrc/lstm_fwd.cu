// LSTM sequence unroll, forward (kernel B1), f32, for sm_90a.
//
// Replaces: tpu_rl/ops/pallas_lstm.py, _pallas_forward (Pallas body
// _make_kernel). For every batch row b and step t = 0..S-1:
//
//   h, c  *= keep[b, t]                          episode-first carry reset
//   z      = xp[b, t] + h @ wh                   xp (B,S,4H), wh (H,4H)
//   i, f, o = sigmoid(z_i, z_f, z_o); g = tanh(z_g)
//   c      = f * c + i * g;  h = o * tanh(c)
//
// and writes hs[b, t] = h, cs[b, t] = c (B,S,H) and the gate activations
// acts[b, t] = [i, f, g, o] (B,S,4H) that the backward (lstm_bwd.cu) reads
// instead of recomputing them.
//
// What bounds it on an H100. At the training shape (B=128, S=5, H=64) it
// moves ~1.77 MB (xp and acts 655 KB each, hs and cs 164 KB each, wh 64 KB,
// h0, c0, keep), ~0.53 us at 3.35 TB/s, and does 2*B*S*H*4H = 21 MFLOP,
// ~0.31 us at the 67 TFLOP/s f32 peak: bound by bytes. At B=1024, S=16,
// H=1024 it is 137 GFLOP, ~2.05 ms: bound by operations.
//
// What this first design does about it. It is simple and exact rather than
// fast. The recurrence is sequential in t and independent across rows, so
// one block owns a tile of kRows rows for all S steps and the time loop runs
// inside the block. The tile's carry h and c and the step's pre-activations
// z live in shared memory, rows innermost ([column][row]), so that one
// 16-byte load gives four rows of h[k]; a __syncthreads() separates the
// product (which reads every column of h) from the gate update (which
// writes it). In the product each thread owns a gate column of z and keeps
// kRows partial sums in registers; a warp's loads of wh[k*4H + col] are on
// neighbouring addresses, and each loaded value serves kRows rows. wh
// streams through L1/L2 (64 KB at H=64, 16 MB at H=1024); it is not staged
// in shared memory. Sums are plain f32 FMAs, sigmoid is 1/(1+expf(-x)), no
// fast-math: parity with the reference is held at 1e-5. The cost: only
// ceil(B/kRows) SMs work (16 of 132 at B=128), each walks its H-long
// reductions serially, and a step's latency is paid S times in sequence.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;       // batch rows per block (ragged last tile masked)
constexpr int kThreads = 256;  // 8 warps
static_assert(kRows == 8, "the product reads a column of h_s as two float4");

__device__ __forceinline__ float sigmoid_f(float z) { return 1.0f / (1.0f + expf(-z)); }

__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ wh,
                const float* __restrict__ h0, const float* __restrict__ c0,
                const float* __restrict__ keep, float* __restrict__ hs,
                float* __restrict__ cs, float* __restrict__ acts, int B, int S, int H) {
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned rows of h_s
  float* h_s = reinterpret_cast<float*>(smem4);  // H x kRows, keep applied
  float* c_s = h_s + (size_t)H * kRows;           // H x kRows, keep applied
  float* z_s = c_s + (size_t)H * kRows;           // 4H x kRows

  const int G = 4 * H;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  const int tid = threadIdx.x;

  // The carry entering step 0, times keep[:, 0]. Rows past B are zeros.
  for (int e = tid; e < kRows * H; e += kThreads) {
    const int r = e / H, j = e - r * H;
    float hv = 0.0f, cv = 0.0f;
    if (r < rows) {
      const size_t b = row0 + r;
      const float kp = keep[b * S];
      hv = h0[b * H + j] * kp;
      cv = c0[b * H + j] * kp;
    }
    h_s[j * kRows + r] = hv;
    c_s[j * kRows + r] = cv;
  }
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    // 1. z = xp[t] + h @ wh: thread owns gate column col for the tile's rows.
    for (int col = tid; col < G; col += kThreads) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      const float* wcol = wh + col;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float w = wcol[(size_t)k * G];
        const float4 lo = reinterpret_cast<const float4*>(h_s)[2 * k];
        const float4 hi = reinterpret_cast<const float4*>(h_s)[2 * k + 1];
        acc[0] = fmaf(lo.x, w, acc[0]);
        acc[1] = fmaf(lo.y, w, acc[1]);
        acc[2] = fmaf(lo.z, w, acc[2]);
        acc[3] = fmaf(lo.w, w, acc[3]);
        acc[4] = fmaf(hi.x, w, acc[4]);
        acc[5] = fmaf(hi.y, w, acc[5]);
        acc[6] = fmaf(hi.z, w, acc[6]);
        acc[7] = fmaf(hi.w, w, acc[7]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float x = r < rows ? xp[((size_t)(row0 + r) * S + t) * G + col] : 0.0f;
        z_s[col * kRows + r] = x + acc[r];
      }
    }
    __syncthreads();

    // 2. Gates and the new carry: thread owns element (r, j).
    for (int e = tid; e < kRows * H; e += kThreads) {
      const int r = e / H, j = e - r * H;
      const float i = sigmoid_f(z_s[j * kRows + r]);
      const float f = sigmoid_f(z_s[(H + j) * kRows + r]);
      const float g = tanhf(z_s[(2 * H + j) * kRows + r]);
      const float o = sigmoid_f(z_s[(3 * H + j) * kRows + r]);
      const float c2 = f * c_s[j * kRows + r] + i * g;
      const float h2 = o * tanhf(c2);
      float keep_next = 0.0f;
      if (r < rows) {
        const size_t b = row0 + r;
        const size_t bt = b * S + t;
        hs[bt * H + j] = h2;
        cs[bt * H + j] = c2;
        float* a = acts + bt * G;
        a[j] = i;
        a[H + j] = f;
        a[2 * H + j] = g;
        a[3 * H + j] = o;
        keep_next = t + 1 < S ? keep[b * S + t + 1] : 1.0f;
      }
      // The carry the next step reads, with its keep already applied.
      h_s[j * kRows + r] = h2 * keep_next;
      c_s[j * kRows + r] = c2 * keep_next;
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C entry, bound with ctypes: every pointer and the stream are void*.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int lstm_fwd_launch(const void* xp, const void* wh, const void* h0,
                               const void* c0, const void* keep, void* hs, void* cs,
                               void* acts, int B, int S, int H, void* stream) {
  const size_t smem = sizeof(float) * (size_t)kRows * 6 * (size_t)H;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  lstm_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xp), static_cast<const float*>(wh),
      static_cast<const float*>(h0), static_cast<const float*>(c0),
      static_cast<const float*>(keep), static_cast<float*>(hs), static_cast<float*>(cs),
      static_cast<float*>(acts), B, S, H);
  return (int)cudaGetLastError();
}
