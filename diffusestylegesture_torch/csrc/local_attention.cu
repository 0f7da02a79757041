// Windowed causal local attention for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel
// `diffusestylegesture_tpu/ops/local_attention_pallas.py::local_attention_pallas`
// (kernel body `_kernel`). Semantics, on packed (B*H, N, D) q/k/v:
//   * the sequence is cut into N/w windows of w tokens; each query window
//     attends to 2w keys, [previous window | own window];
//   * keys are masked causally on global positions (query pos < key pos);
//   * window 0's "previous" keys and values are -1.0; only the user mask
//     (pad positions count as False) removes them, and with no mask they
//     ARE attended (reference quirk, `local_attention_pallas.py:95-98`);
//   * row b*H + h of the packed axis takes batch element b's (B, N) mask;
//   * scale D^-0.5, masking with -FLT_MAX (never -inf, so a fully masked row
//     gives the uniform average as JAX does, not NaN), softmax in float32.
//
// What bounds it on an H100: nothing but launch latency at the shapes the
// denoiser uses (B*H = 8..16, N = 88, w = 11, D = 32): q/k/v/out are
// ~0.36 MB per batch element (~0.1 us at 3.35 TB/s) and the work is ~2
// MFLOP. The design therefore keeps everything of one window in shared
// memory and does the whole window in one block, with one block per
// (batch*head, window): no score tensor reaches device memory, q/k/v are
// read once per window (k/v twice: once as own, once as the next window's
// previous), and there are B*H*N/w = 64 blocks at batch 1 to spread over
// the SMs. The (w x 2w) products are far below a tensor-core tile, so this
// first version uses plain FMA.
#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
local_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const unsigned char* __restrict__ mask,
                       float* __restrict__ out, int n, int w, int d, int heads, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * w;  // first query position of this window
  const int w2 = 2 * w;
  const int kd = d + 1;           // padded k row: conflict-free column reads
  float* qs = smem;               // [w][d]
  float* ks = qs + w * d;         // [2w][d+1]
  float* vs = ks + w2 * kd;       // [2w][d]
  float* ss = vs + w2 * d;        // [w][2w] scores, then probabilities
  const size_t base = static_cast<size_t>(bh) * n * d;

  // unrolled so that each thread has several independent loads in flight
#pragma unroll 4
  for (int idx = threadIdx.x; idx < w * d; idx += blockDim.x) {
    qs[idx] = q[base + static_cast<size_t>(q0) * d + idx];
  }
#pragma unroll 4
  for (int idx = threadIdx.x; idx < w2 * d; idx += blockDim.x) {
    const int j = idx / d, c = idx - j * d;
    const int pos = q0 - w + j;  // global key position; < 0 is window 0's pad
    float kv = -1.0f, vv = -1.0f;
    if (pos >= 0) {
      kv = k[base + static_cast<size_t>(pos) * d + c];
      vv = v[base + static_cast<size_t>(pos) * d + c];
    }
    ks[j * kd + c] = kv;
    vs[j * d + c] = vv;
  }
  __syncthreads();

  const unsigned char* mrow = mask ? mask + static_cast<size_t>(bh / heads) * n : nullptr;
  for (int idx = threadIdx.x; idx < w * w2; idx += blockDim.x) {
    const int i = idx / w2, j = idx - i * w2;
    float acc = 0.0f;
    for (int c = 0; c < d; ++c) acc = fmaf(qs[i * d + c], ks[j * kd + c], acc);
    float s = acc * scale;
    if (i + w < j) s = -FLT_MAX;  // query pos < key pos
    if (mrow) {
      const int pos = q0 - w + j;
      if (pos < 0 || !mrow[pos]) s = -FLT_MAX;
    }
    ss[idx] = s;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < w; i += blockDim.x >> 5) {
    float* row = ss + i * w2;
    float m = -FLT_MAX;
    for (int j = lane; j < w2; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < w2; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < w2; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < w * d; idx += blockDim.x) {
    const int i = idx / d, c = idx - i * d;
    float acc = 0.0f;
    for (int j = 0; j < w2; ++j) acc = fmaf(ss[i * w2 + j], vs[j * d + c], acc);
    out[base + static_cast<size_t>(q0 + i) * d + c] = acc;
  }
}

}  // namespace

extern "C" size_t dsg_local_attention_smem_bytes(int w, int d) {
  return sizeof(float) * (static_cast<size_t>(w) * d + 2 * w * (d + 1) + 2 * w * d + 2 * w * w);
}

// q, k, v, out: (bh, n, d) float32, contiguous. mask: (bh / heads, n) uint8 or
// null. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dsg_local_attention(const float* q, const float* k, const float* v,
                                   const unsigned char* mask, float* out, int bh, int n,
                                   int w, int d, int heads, float scale,
                                   cudaStream_t stream) {
  const size_t smem = dsg_local_attention_smem_bytes(w, d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        local_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(bh, n / w);
  local_attention_kernel<<<grid, kThreads, smem, stream>>>(q, k, v, mask, out, n, w, d,
                                                          heads, scale);
  return static_cast<int>(cudaGetLastError());
}
