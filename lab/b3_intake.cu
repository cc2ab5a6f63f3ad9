// Per-SM copy intake on the card, by copy path: one block per SM streams
// 8 KB chunks from global into a ring of shared-memory stages and waits for
// each, as the fused act kernel's weight ring does. Modes: 0 a 3-D
// tensor-map box {32, 16, 4} of a (4H, H) matrix (the kernel's Wx tile),
// 1 a {16, 4, 32} box of an (H, 4H) matrix (its Wh tile), 2 one 1-D bulk
// copy of 8 contiguous KB, 3 eight 1 KB bulk copies, 4 16-byte cp.async by
// all threads, 5 a Wx box and 8 KB of cp.async together (16 KB a chunk).
// Driven by `python3 lab/b3_lab.py intake`.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ uint32_t sa(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__global__ void bench(const __grid_constant__ CUtensorMap wx, const __grid_constant__ CUtensorMap wh,
                      const float* src, int mode, int nchunks, int stages, int chunk_bytes, int H,
                      long long* out) {
  extern __shared__ __align__(16) float raw[];
  float* ring = raw + ((1024 - (sa(raw) & 1023)) & 1023) / 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + stages * chunk_bytes / 4);
  const int tid = threadIdx.x;
  if (tid < stages) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(sa(&bars[tid])));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
  long long t0 = clock64();
  const int U = 16;
  auto issue = [&](int c) {
    float* dst = ring + (c % stages) * chunk_bytes / 4;
    uint64_t* bar = &bars[c % stages];
    if (mode == 5) {  // TMA Wx box and cp.async 16 B of as many bytes, on one barrier + group
      if (tid == 0) {
        int k0 = (c * 32) % H, u0 = (blockIdx.x * U) % H;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(sa(bar)), "r"(8192));
        asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];"
                     ::"r"(sa(dst)), "l"((uint64_t)&wx), "r"(k0), "r"(u0), "r"(0), "r"(sa(bar)) : "memory");
      }
      const float* s = src + ((size_t)blockIdx.x * nchunks + c) * 2048;
      for (int i = tid; i < 512; i += blockDim.x)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(sa(dst + 2048 + 4 * i)), "l"(s + 4 * i) : "memory");
      asm volatile("cp.async.commit_group;" ::: "memory");
      return;
    }
    if (mode <= 3) {
      if (tid == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(sa(bar)), "r"(chunk_bytes));
        if (mode == 0) {
          int k0 = (c * 32) % H, u0 = (blockIdx.x * U) % H;
          asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];"
                       ::"r"(sa(dst)), "l"((uint64_t)&wx), "r"(k0), "r"(u0), "r"(0), "r"(sa(bar)) : "memory");
        } else if (mode == 1) {
          int k0 = (c * 32) % H, u0 = (blockIdx.x * U) % H;
          asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];"
                       ::"r"(sa(dst)), "l"((uint64_t)&wh), "r"(u0), "r"(0), "r"(k0), "r"(sa(bar)) : "memory");
        } else {
          const float* s = src + ((size_t)blockIdx.x * nchunks + c) * (chunk_bytes / 4);
          int pieces = mode == 2 ? 1 : 8;
          for (int i = 0; i < pieces; ++i)
            asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                         ::"r"(sa(dst + i * chunk_bytes / 4 / pieces)), "l"(s + i * chunk_bytes / 4 / pieces), "r"(chunk_bytes / pieces), "r"(sa(bar)) : "memory");
        }
      }
    } else {
      const float* s = src + ((size_t)blockIdx.x * nchunks + c) * (chunk_bytes / 4);
      for (int i = tid; i < chunk_bytes / 16; i += blockDim.x)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(sa(dst + 4 * i)), "l"(s + 4 * i) : "memory");
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
  };
  for (int c = 0; c < stages - 1 && c < nchunks; ++c) issue(c);
  float acc = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    if (mode == 5) {
      asm volatile("{\n .reg .pred p;\nW_%=:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n @!p bra W_%=;\n}"
                   ::"r"(sa(&bars[c % stages])), "r"((c / stages) & 1) : "memory");
    }
    if (mode <= 3) {
      asm volatile("{\n .reg .pred p;\nW_%=:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n @!p bra W_%=;\n}"
                   ::"r"(sa(&bars[c % stages])), "r"((c / stages) & 1) : "memory");
    } else {
      int n = min(stages - 2, nchunks - 1 - c);
      if (n >= 6) asm volatile("cp.async.wait_group 6;" ::: "memory");
      else if (n == 5) asm volatile("cp.async.wait_group 5;" ::: "memory");
      else if (n == 4) asm volatile("cp.async.wait_group 4;" ::: "memory");
      else if (n == 3) asm volatile("cp.async.wait_group 3;" ::: "memory");
      else if (n == 2) asm volatile("cp.async.wait_group 2;" ::: "memory");
      else if (n == 1) asm volatile("cp.async.wait_group 1;" ::: "memory");
      else asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    acc += ring[(c % stages) * chunk_bytes / 4 + tid];
    if (c + stages - 1 < nchunks) issue(c + stages - 1);
  }
  long long t1 = clock64();
  if (tid == 0) { out[blockIdx.x * 2] = t1 - t0; out[blockIdx.x * 2 + 1] = (long long)acc; }
}

static PFN_cuTensorMapEncodeTiled_v12000 enc() {
  void* f = nullptr; cudaDriverEntryPointQueryResult q;
  cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
  return (PFN_cuTensorMapEncodeTiled_v12000)f;
}

extern "C" int run(const void* wxp, const void* whp, const void* src, int H, int mode, int blocks, int nchunks,
                   int stages, int chunk_bytes, void* out, void* stream) {
  CUtensorMap wx = {}, wh = {};
  cuuint64_t h = H; cuuint32_t ones[3] = {1, 1, 1};
  { cuuint64_t d[3] = {h, h, 4}, s[2] = {h * 4, h * h * 4}; cuuint32_t b[3] = {32, 16, 4};
    if (enc()(&wx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)wxp, d, s, b, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)) return 901; }
  { cuuint64_t d[3] = {h, 4, h}, s[2] = {h * 4, h * 16}; cuuint32_t b[3] = {16, 4, 32};
    if (enc()(&wh, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)whp, d, s, b, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)) return 902; }
  int smem = stages * chunk_bytes + 1024 + 64;
  cudaFuncSetAttribute(bench, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  bench<<<blocks, 256, smem, (cudaStream_t)stream>>>(wx, wh, (const float*)src, mode, nchunks, stages, chunk_bytes, H,
                                                    (long long*)out);
  return (int)cudaGetLastError();
}
