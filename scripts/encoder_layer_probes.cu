// Two probes of an H100 behind the design of the encoder-layer kernel
// (diffusestylegesture_torch/csrc/encoder_layer.cu):
//   1. L2 -> shared memory: blocks of 256 threads each copy 16 KB, 64 KB or
//      256 KB of an L2-resident buffer into shared memory, with cp.async (16
//      bytes a thread, three 32 KB groups in flight) or with cp.async.bulk
//      pieces of 256 B, 1 KB or 4 KB; printed as the time of one launch
//      (back-to-back launches, so launch cost included) and its rate.
//   2. The kernel's product loop alone: warp_mma over 64 k-columns of a
//      16-row A and a 128-row (16-tile) weight chunk, both already in shared
//      memory, in float32 (3xTF32) and bf16 modes, with and without a block
//      barrier per chunk; printed as SM cycles per chunk.
// Build and run from the repository root on a machine with the card:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o /tmp/encoder_layer_probes scripts/encoder_layer_probes.cu && /tmp/encoder_layer_probes
#include "../diffusestylegesture_torch/csrc/encoder_layer.cu"

#include <cstdio>

namespace {

// ---- probe 1: L2 -> shared memory ------------------------------------------------

constexpr int kProbeSmem = 96 * 1024;  // copies wrap around this much shared memory

__global__ void copy_cp_async(const float* src, size_t span, int bytes, float* sink) {
  extern __shared__ __align__(16) float sm[];
  const float* base = src + (static_cast<size_t>(blockIdx.x) * (bytes / 4)) % span;
  constexpr int kGroup = 32 * 1024;
  const int group = bytes < kGroup ? bytes : kGroup;
  for (int c = 0; c < bytes / group; ++c) {
    float* dst = sm + (c % 3) * (group / 4);
    const float* s = base + static_cast<size_t>(c) * (group / 4);
    for (int i = threadIdx.x; i < group / 16; i += kThreads) cp_async16(dst + 4 * i, s + 4 * i, true);
    cp_async_commit();
    cp_async_wait<2>();
  }
  cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x == 0) sink[blockIdx.x] = sm[5];
}

__global__ void copy_bulk(const float* src, size_t span, int bytes, int piece, float* sink) {
  extern __shared__ __align__(16) float sm[];
  __shared__ __align__(8) uint64_t bar;
  const float* base = src + (static_cast<size_t>(blockIdx.x) * (bytes / 4)) % span;
  const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
                 : "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    for (int p = threadIdx.x; p < bytes / piece; p += 32) {
      const uint32_t d =
          static_cast<uint32_t>(__cvta_generic_to_shared(sm)) + (p * piece) % kProbeSmem;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(d),
          "l"(reinterpret_cast<const char*>(base) + static_cast<size_t>(p) * piece), "r"(piece),
          "r"(b)
          : "memory");
    }
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; "
        "selp.u32 %0, 1, 0, p; }\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
  }
  if (threadIdx.x == 0) sink[blockIdx.x] = sm[5];
}

void probe_copies() {
  const size_t span = 4u << 20;  // floats: a 16 MB buffer, L2-resident
  float *src, *sink;
  cudaMalloc(&src, span * 4);
  cudaMalloc(&sink, 4096 * 4);
  cudaMemset(src, 0, span * 4);
  cudaFuncSetAttribute(copy_cp_async, cudaFuncAttributeMaxDynamicSharedMemorySize, kProbeSmem);
  cudaFuncSetAttribute(copy_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize, kProbeSmem);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const char* names[] = {"cp.async 16 B", "bulk 256 B", "bulk 1 KB", "bulk 4 KB"};
  for (int bytes : {16 << 10, 64 << 10, 256 << 10}) {
    for (int blocks : {1, 48, 132}) {
      for (int v = 0; v < 4; ++v) {
        auto run = [&]() {
          if (v == 0) {
            copy_cp_async<<<blocks, kThreads, kProbeSmem>>>(src, span, bytes, sink);
          } else {
            copy_bulk<<<blocks, kThreads, kProbeSmem>>>(src, span, bytes, 256 << (2 * (v - 1)),
                                                       sink);
          }
        };
        for (int i = 0; i < 3; ++i) run();
        constexpr int kIters = 50;
        cudaEventRecord(e0);
        for (int i = 0; i < kIters; ++i) run();
        cudaEventRecord(e1);
        cudaEventSynchronize(e1);
        float ms;
        cudaEventElapsedTime(&ms, e0, e1);
        const double us = ms * 1e3 / kIters;
        printf("copy %3d KB a block, %3d blocks, %-13s: %6.2f us a launch, %6.1f GB/s a block (%s)\n",
               bytes >> 10, blocks, names[v], us, bytes / us / 1e3,
               cudaGetErrorString(cudaGetLastError()));
      }
    }
  }
  cudaFree(src);
  cudaFree(sink);
}

// ---- probe 2: the product loop alone ----------------------------------------------

template <bool BF16, bool Sync>
__global__ void __launch_bounds__(kThreads) mma_chunks(float* out, long long* cycles, int iters) {
  extern __shared__ __align__(16) float sm[];
  float* A = sm;                        // [16][kstride(256)]
  float* B = sm + kRows * kstride(256);  // [128][kStageStride]
  for (int i = threadIdx.x; i < kRows * kstride(256) + kPanelRows * kStageStride; i += kThreads) {
    sm[i] = (i % 13) * 0.01f;
  }
  __syncthreads();
  const Split sp(kPanelRows / 8, kKc / 16);
  float acc[kNtMax][4] = {};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (Sync) __syncthreads();
    warp_mma<BF16, false>(acc, sp, A + (it & 3) * kKc, kstride(256), B, kStageStride, kKc);
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.0f;
  for (int j = 0; j < kNtMax; ++j)
    for (int i = 0; i < 4; ++i) s += acc[j][i];
  out[blockIdx.x * kThreads + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <bool BF16, bool Sync>
void probe_mma(const char* name) {
  constexpr int kIters = 256, kBlocks = 48;
  float* out;
  long long* cycles;
  cudaMalloc(&out, kBlocks * kThreads * 4);
  cudaMalloc(&cycles, kBlocks * 8);
  const int smem = (kRows * kstride(256) + kPanelRows * kStageStride) * 4;
  cudaFuncSetAttribute(mma_chunks<BF16, Sync>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  for (int i = 0; i < 2; ++i) mma_chunks<BF16, Sync><<<kBlocks, kThreads, smem>>>(out, cycles, kIters);
  long long c[kBlocks];
  cudaMemcpy(c, cycles, sizeof(c), cudaMemcpyDeviceToHost);
  printf("product loop, %-14s: %7.1f SM cycles per 16 x 128 x 64 chunk (%s)\n", name,
         static_cast<double>(c[0]) / kIters, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
  cudaFree(cycles);
}

}  // namespace

int main() {
  probe_copies();
  probe_mma<false, false>("f32");
  probe_mma<false, true>("f32 + barrier");
  probe_mma<true, false>("bf16");
  probe_mma<true, true>("bf16 + barrier");
  return 0;
}
