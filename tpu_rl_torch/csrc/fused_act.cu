// Fused act step of the discrete LSTM actor-critic, f32, for sm_90a.
//
// Replaces: tpu_rl/ops/pallas_act.py, _act_kernel (the Pallas TPU kernel
// behind fused_act_step / make_fused_act). It computes, per row of the batch,
//
//   x      = relu(obs @ Wb^T + bb)                      torso
//   z      = x @ Wx^T + bx + h @ Wh                     LSTM pre-activations
//   c2     = sig(f) * c + sig(i) * tanh(g)              gates i, f, g, o
//   h2     = sig(o) * tanh(c2)
//   logits = log_softmax(h2 @ Wl^T + bl)                policy head
//
// and writes logits (B,A), h2 (B,H), c2 (B,H). The value head is skipped;
// sampling and the carry reset stay outside, shared with the unfused path.
// Weights are read in the layouts of the port's state_dict, so nothing is
// transposed per call: Wb (H,D), Wx (4H,H) and Wl (A,H) are torch Linear
// weights (out, in); Wh (H,4H) is the recurrent kernel in flax's (in, out).
//
// What bounds it on an H100. At the serving shape (B=256, D=4, H=256, A=2)
// the weights are ~526k floats (2.1 MB, ~0.63 us at 3.35 TB/s) and the three
// products ~269 MFLOP (~4 us at the 67 TFLOP/s f32 CUDA-core peak): the
// work is bound by operations; at an 8-row bucket it is bound by the weight
// bytes (~0.6 us). Launch latency is of the same order.
//
// What this first design does about it. It is simple and exact rather than
// fast. One block owns a tile of kRows rows and the whole act step for them,
// so the three dependent products never leave the SM: the tile's obs, x, h
// and h2 live in shared memory, the weights stream through L2. Every thread
// owns output columns and keeps 4 gates x kRows partial sums in registers,
// so each weight value it loads is used kRows times and no cross-thread
// reduction is needed in the LSTM product. Sums are plain f32 FMAs (no TF32)
// because parity with the reference is held at 1e-5. The cost of this
// design: only ceil(B/kRows) SMs work, each streams all the weights, and
// each thread walks the H-long reduction serially. A warp's Wh loads are
// coalesced (lanes j, j+1 are adjacent in a row of Wh), but its Wx loads
// are not: lane j reads wx[(g*H + j)*H + k], so neighbouring lanes are H
// floats apart and each k costs 32 sectors per gate. At serving sizes the
// kernel runs far above its bound and flat in the row count (PERF.md has
// the times); which of the two, the serial chain or the scattered Wx
// reads, dominates has not been profiled. Reading Wx transposed or through
// shared memory, splitting 4H across blocks or a cluster, and wgmma/TMA
// are left to a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;          // batch rows per block (ragged last tile masked)
constexpr int kThreads = 256;     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sigmoid_f(float z) { return 1.0f / (1.0f + expf(-z)); }

// relu that lets NaN through, like jnp.maximum / torch.relu.
__device__ __forceinline__ float relu_f(float v) { return v < 0.0f ? 0.0f : v; }

__global__ void __launch_bounds__(kThreads)
fused_act_kernel(const float* __restrict__ obs, const float* __restrict__ wb,
                 const float* __restrict__ bb, const float* __restrict__ wx,
                 const float* __restrict__ bx, const float* __restrict__ wh,
                 const float* __restrict__ wl, const float* __restrict__ bl,
                 const float* __restrict__ h, const float* __restrict__ c,
                 float* __restrict__ logits, float* __restrict__ h2,
                 float* __restrict__ c2, int B, int D, int H, int A) {
  extern __shared__ float smem[];
  float* obs_s = smem;               // kRows x D
  float* x_s = obs_s + kRows * D;    // kRows x H
  float* h_s = x_s + kRows * H;      // kRows x H
  float* h2_s = h_s + kRows * H;     // kRows x H
  float* raw_s = h2_s + kRows * H;   // kRows x A

  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t G = 4 * (size_t)H;  // width of the gate block

  // Stage the tile's obs and h. Rows past B are zeros and are never stored.
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D;
    obs_s[i] = r < rows ? obs[(size_t)(row0 + r) * D + (i - r * D)] : 0.0f;
  }
  for (int i = tid; i < kRows * H; i += kThreads) {
    const int r = i / H;
    h_s[i] = r < rows ? h[(size_t)(row0 + r) * H + (i - r * H)] : 0.0f;
  }
  __syncthreads();

  // 1. Torso: thread j owns column j of x.
  for (int j = tid; j < H; j += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    const float* wrow = wb + (size_t)j * D;
    for (int k = 0; k < D; ++k) {
      const float w = wrow[k];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(obs_s[r * D + k], w, acc[r]);
    }
    const float b = bb[j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) x_s[r * H + j] = relu_f(acc[r] + b);
  }
  __syncthreads();

  // 2. LSTM cell: thread j owns column j of all four gates.
  for (int j = tid; j < H; j += kThreads) {
    float zx[4][kRows];  // x @ Wx^T
    float zh[4][kRows];  // h @ Wh
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) zx[g][r] = zh[g][r] = 0.0f;
    }
#pragma unroll 2
    for (int k = 0; k < H; ++k) {
      float wxg[4], whg[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        wxg[g] = wx[((size_t)g * H + j) * H + k];
        whg[g] = wh[(size_t)k * G + (size_t)g * H + j];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xv = x_s[r * H + k];
        const float hv = h_s[r * H + k];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          zx[g][r] = fmaf(xv, wxg[g], zx[g][r]);
          zh[g][r] = fmaf(hv, whg[g], zh[g][r]);
        }
      }
    }
    const float bi = bx[j], bf = bx[H + j], bg = bx[2 * H + j], bo = bx[3 * H + j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      // (x @ Wx^T + bx) + h @ Wh, the reference's order of the three terms.
      const float zi = (zx[0][r] + bi) + zh[0][r];
      const float zf = (zx[1][r] + bf) + zh[1][r];
      const float zg = (zx[2][r] + bg) + zh[2][r];
      const float zo = (zx[3][r] + bo) + zh[3][r];
      const float cv = r < rows ? c[(size_t)(row0 + r) * H + j] : 0.0f;
      const float cn = sigmoid_f(zf) * cv + sigmoid_f(zi) * tanhf(zg);
      const float hn = sigmoid_f(zo) * tanhf(cn);
      h2_s[r * H + j] = hn;
      if (r < rows) {
        h2[(size_t)(row0 + r) * H + j] = hn;
        c2[(size_t)(row0 + r) * H + j] = cn;
      }
    }
  }
  __syncthreads();

  // 3. Policy head: warp a owns action a, lanes split the H-long dot product.
  for (int a = warp; a < A; a += kWarps) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    const float* wrow = wl + (size_t)a * H;
    for (int k = lane; k < H; k += 32) {
      const float w = wrow[k];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(h2_s[r * H + k], w, acc[r]);
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += __shfl_xor_sync(kFull, acc[r], off);
    }
    if (lane == 0) {
      const float b = bl[a];
#pragma unroll
      for (int r = 0; r < kRows; ++r) raw_s[r * A + a] = acc[r] + b;
    }
  }
  __syncthreads();

  // 4. Row-wise log-softmax with max subtraction: thread r owns row r.
  if (tid < rows) {
    const float* raw = raw_s + tid * A;
    float m = raw[0];
    for (int a = 1; a < A; ++a) m = fmaxf(m, raw[a]);
    float s = 0.0f;
    for (int a = 0; a < A; ++a) s += expf(raw[a] - m);
    const float lse = m + logf(s);
    float* out = logits + (size_t)(row0 + tid) * A;
    for (int a = 0; a < A; ++a) out[a] = raw[a] - lse;
  }
}

}  // namespace

// Plain C entry, bound with ctypes: every pointer and the stream are void*.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_act_launch(const void* obs, const void* wb, const void* bb,
                                const void* wx, const void* bx, const void* wh,
                                const void* wl, const void* bl, const void* h,
                                const void* c, void* logits, void* h2, void* c2,
                                int B, int D, int H, int A, void* stream) {
  const size_t smem = sizeof(float) * (size_t)kRows * ((size_t)D + 3 * (size_t)H + A);
  cudaError_t err = cudaFuncSetAttribute(
      fused_act_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  fused_act_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(obs), static_cast<const float*>(wb),
      static_cast<const float*>(bb), static_cast<const float*>(wx),
      static_cast<const float*>(bx), static_cast<const float*>(wh),
      static_cast<const float*>(wl), static_cast<const float*>(bl),
      static_cast<const float*>(h), static_cast<const float*>(c),
      static_cast<float*>(logits), static_cast<float*>(h2), static_cast<float*>(c2),
      B, D, H, A);
  return (int)cudaGetLastError();
}
