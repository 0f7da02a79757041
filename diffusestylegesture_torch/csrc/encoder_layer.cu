// One post-norm transformer encoder layer (torch 1.9 nn.TransformerEncoderLayer,
// inference) for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel
// `diffusestylegesture_tpu/ops/encoder_layer_pallas.py::encoder_layer_pallas`
// (kernel body `_layer_kernel`, stacked by `fused_trunk_apply`). Semantics:
//   qkv = x Win^T + bin                       (packed D -> 3D projection)
//   a   = softmax(q_h k_h^T * hd^-0.5) v_h    (H heads over the T valid keys)
//   y   = LN1(x + a Wout^T + bout)            (eps 1e-5)
//   out = LN2(y + act(y W1^T + b1) W2^T + b2)
// with act chosen at run time (erf GELU, tanh GELU or ReLU) from the model's
// config: the Pallas kernel hard-codes erf GELU whatever the config says; this
// one does not. The Pallas kernel pads T to a multiple of 8 and masks the
// padded keys; here the attention loops run over exactly T keys, which is the
// same result. Weights are taken as torch stores them, nn.Linear (out, in),
// with no transpose per call.
//
// What bounds it on an H100: at the denoiser's shapes (B*T = 89..178 rows,
// D = 256, H = 4, F = 1024) one layer is ~150 MFLOP at batch 1 against
// ~3.2 MB of weights: ~2.2 us of float32 FMA peak (67 TFLOP/s) against ~1 us
// of HBM traffic, so operations bound it. In practice the few rows leave most
// SMs idle, and each block's time goes to shared-memory traffic and to the
// latency of its global loads, not to arithmetic. The whole layer does not fit
// one block's shared memory (the f32 QKV alone is 89 x 768 x 4 B, ~273 KB,
// above the 227 KB limit), so the layer is seven grids on one stream, issued
// by one host call, with intermediates in one device workspace that stays in
// the 50 MB L2:
//   1. GEMM       qkv = x Win^T + bin
//   2. attention  one block per (batch, head, 8-query tile); K_h, V_h and the
//                 score tile live in shared memory
//   3. GEMM       partial sums of a Wout^T, split over K
//   4. LayerNorm  y = LN1(x + bout + sum of partials), one warp per row
//   5. GEMM       h = act(y W1^T + b1)
//   6. GEMM       partial sums of h W2^T, split over K
//   7. LayerNorm  out = LN2(y + b2 + sum of partials)
// The GEMMs use 32 x 32 output tiles so that even 89 rows give 48-120 blocks,
// with 4 x 2 outputs per thread read from float4 shared-memory loads and the
// next k-tile's global loads in flight during the products. The two GEMMs
// whose rows feed a LayerNorm split K across blocks (the LayerNorm sums the
// partials in a fixed order, so results are deterministic). Plain FMA
// throughout; tensor cores (wgmma, bf16 operands) are later work.
#include <cfloat>
#include <cuda_runtime.h>
#include <math.h>

namespace {

enum Activation { kNone = 0, kGeluErf = 1, kGeluTanh = 2, kRelu = 3 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kGeluErf:
      return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
    case kGeluTanh:
      return 0.5f * x * (1.0f + tanhf(0.79788456080286536f * (x + 0.044715f * x * x * x)));
    case kRelu:
      return fmaxf(x, 0.0f);
    default:
      return x;
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- GEMM: Y[z][M,N] = X[M, Kz] W[N, Kz]^T (+ bias, act when not split) ---------
// 32 x 32 output tile, 128 threads, each 4 rows x 2 columns. Both tiles are
// stored k-contiguous (rows padded to 36 floats), so a thread reads its 4 X
// values and 2 W values for 4 consecutive k as six float4 loads: with the
// X reads broadcast across the warp, that is ~1 shared-memory wavefront per
// 4 warp FMAs, and the 4 warps keep all four FMA pipes of the SM busy. The
// next k-tile's global loads are issued before the current tile's products.
// Needs K % 4 == 0 and 16-byte aligned X and W rows.
constexpr int kBM = 32, kBN = 32, kBK = 32, kGemmThreads = 128, kRowPad = 4;
constexpr int kStage = kBM * kBK / 4 / kGemmThreads;  // float4 of each tile per thread

__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ X, const float* __restrict__ W,
            const float* __restrict__ bias, float* __restrict__ Y, int M, int N, int K,
            int k_per_split, int act) {
  __shared__ __align__(16) float xs[kBM][kBK + kRowPad];
  __shared__ __align__(16) float ws[kBN][kBK + kRowPad];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // columns tx, tx+16; rows 4ty..4ty+3
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 xr[kStage], wr[kStage];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int idx = threadIdx.x + i * kGemmThreads;
      const int r = idx >> 3, gk = k0 + (idx & 7) * 4;  // 8 lanes read one 128-byte row piece
      xr[i] = (m0 + r < M && gk < k_end)
                  ? *reinterpret_cast<const float4*>(X + static_cast<size_t>(m0 + r) * K + gk)
                  : zero;
      wr[i] = (n0 + r < N && gk < k_end)
                  ? *reinterpret_cast<const float4*>(W + static_cast<size_t>(n0 + r) * K + gk)
                  : zero;
    }
  };

  float acc[4][2] = {};
  load(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int idx = threadIdx.x + i * kGemmThreads;
      *reinterpret_cast<float4*>(&xs[idx >> 3][(idx & 7) * 4]) = xr[i];
      *reinterpret_cast<float4*>(&ws[idx >> 3][(idx & 7) * 4]) = wr[i];
    }
    __syncthreads();
    if (k0 + kBK < k_end) load(k0 + kBK);  // in flight during the products below
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[4], b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(&xs[4 * ty + i][kk]);
      b[0] = *reinterpret_cast<const float4*>(&ws[tx][kk]);
      b[1] = *reinterpret_cast<const float4*>(&ws[tx + 16][kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float s = acc[i][j];
          s = fmaf(a[i].x, b[j].x, s);
          s = fmaf(a[i].y, b[j].y, s);
          s = fmaf(a[i].z, b[j].z, s);
          acc[i][j] = fmaf(a[i].w, b[j].w, s);
        }
      }
    }
    __syncthreads();
  }
  float* out = Y + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = n0 + tx + 16 * j;
      if (r < M && c < N) {
        float v = acc[i][j];
        if (bias) v = activate(v + bias[c], act);
        out[static_cast<size_t>(r) * N + c] = v;
      }
    }
  }
}

// ---- LayerNorm over rows of R + bias + sum of split-K partials -------------------
// One warp per row, two rows per block. All of a row's loads of one split are
// issued together, so a row waits for 1 + splits round trips, not one per value.
constexpr int kLnThreads = 64, kMaxPerLane = 32;  // rows up to 32 x 32 = 1024 wide

__global__ void __launch_bounds__(kLnThreads)
residual_layernorm_kernel(const float* __restrict__ partial, int splits,
                          const float* __restrict__ bias, const float* __restrict__ R,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          float* __restrict__ Y, int M, int N, float eps) {
  const int row = blockIdx.x * (kLnThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t plane = static_cast<size_t>(M) * N;
  const size_t row0 = static_cast<size_t>(row) * N;
  float v[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int n = lane + 32 * i;
    v[i] = n < N ? R[row0 + n] + bias[n] : 0.0f;
  }
  for (int sp = 0; sp < splits; ++sp) {
    const float* p = partial + sp * plane + row0;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int n = lane + 32 * i;
      if (n < N) v[i] += p[n];
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) s += v[i];  // v is 0 past N
  const float mean = warp_sum(s) / N;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    if (lane + 32 * i < N) {
      const float d = v[i] - mean;
      q = fmaf(d, d, q);
    }
  }
  const float inv = 1.0f / sqrtf(warp_sum(q) / N + eps);
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int n = lane + 32 * i;
    if (n < N) Y[static_cast<size_t>(row) * N + n] = (v[i] - mean) * inv * gamma[n] + beta[n];
  }
}

// ---- multi-head softmax attention on the packed qkv rows -------------------------
// One block per (batch, head, 8-query tile): 48 blocks at B = 1. K_h and V_h
// arrive as float4 global loads (hd % 4 == 0) and are stored as scalars.
constexpr int kQTile = 8, kAttnThreads = 256;

__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const float* __restrict__ qkv, float* __restrict__ out, int T, int D, int H,
                 float scale) {
  extern __shared__ float sm[];
  const int hd = D / H, hd4 = hd / 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kQTile;
  const int nq = min(kQTile, T - q0);
  const int kd = hd + 1;         // padded k row
  float* ks = sm;                // [T][hd+1]
  float* vs = ks + T * kd;       // [T][hd]
  float* qs = vs + T * hd;       // [kQTile][hd]
  float* ss = qs + kQTile * hd;  // [kQTile][T]
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const float* base = qkv + static_cast<size_t>(b) * T * row_stride + h * hd;

#pragma unroll 4
  for (int idx = threadIdx.x; idx < T * hd4; idx += kAttnThreads) {
    const int j = idx / hd4, c = (idx - j * hd4) * 4;
    const float4 kv = *reinterpret_cast<const float4*>(base + j * row_stride + D + c);
    const float4 vv = *reinterpret_cast<const float4*>(base + j * row_stride + 2 * D + c);
    float* kr = ks + j * kd + c;
    float* vr = vs + j * hd + c;
    kr[0] = kv.x; kr[1] = kv.y; kr[2] = kv.z; kr[3] = kv.w;
    vr[0] = vv.x; vr[1] = vv.y; vr[2] = vv.z; vr[3] = vv.w;
  }
  for (int idx = threadIdx.x; idx < nq * hd; idx += kAttnThreads) {
    const int i = idx / hd, c = idx - i * hd;
    qs[idx] = base[(q0 + i) * row_stride + c];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nq * T; idx += kAttnThreads) {
    const int i = idx / T, j = idx - i * T;
    float acc = 0.0f;
    for (int c = 0; c < hd; ++c) acc = fmaf(qs[i * hd + c], ks[j * kd + c], acc);
    ss[idx] = acc * scale;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < nq; i += kAttnThreads / 32) {
    float* row = ss + i * T;
    float m = -FLT_MAX;
    for (int j = lane; j < T; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < T; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nq * hd; idx += kAttnThreads) {
    const int i = idx / hd, c = idx - i * hd;
    float acc = 0.0f;
    for (int j = 0; j < T; ++j) acc = fmaf(ss[i * T + j], vs[j * hd + c], acc);
    out[(static_cast<size_t>(b) * T + q0 + i) * D + h * hd + c] = acc;
  }
}

size_t attention_smem(int T, int hd) {
  return sizeof(float) * (static_cast<size_t>(T) * (2 * hd + 1) + kQTile * hd + kQTile * T);
}

// Split K so that a GEMM with few output tiles still spreads over ~128 blocks,
// keeping at least 2 k-tiles per block.
int k_splits(int M, int N, int K) {
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  int s = 128 / tiles;
  s = s < K / (2 * kBK) ? s : K / (2 * kBK);
  return s < 1 ? 1 : s;
}

int k_per_split(int K, int splits) {
  const int per = (K + splits - 1) / splits;
  return (per + kBK - 1) / kBK * kBK;
}

// Number of K slices a GEMM launched with `splits` actually writes.
int split_count(int K, int splits) {
  const int per = k_per_split(K, splits);
  return (K + per - 1) / per;
}

cudaError_t gemm(const float* X, const float* W, const float* bias, float* Y, int M, int N, int K,
                 int splits, int act, cudaStream_t stream) {
  const int per = k_per_split(K, splits);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, split_count(K, splits));
  gemm_kernel<<<grid, kGemmThreads, 0, stream>>>(X, W, bias, Y, M, N, K, per, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t dsg_encoder_layer_attention_smem_bytes(int T, int D, int H) {
  return attention_smem(T, D / H);
}

extern "C" int dsg_encoder_layer_max_width() { return 32 * kMaxPerLane; }

// Floats of device workspace one layer needs: qkv, attention output, y, the
// MLP hidden rows and the split-K partials.
extern "C" size_t dsg_encoder_layer_workspace_floats(int B, int T, int D, int F) {
  const size_t M = static_cast<size_t>(B) * T;
  const int s1 = k_splits(B * T, D, D), s2 = k_splits(B * T, D, F);
  const int s = s1 > s2 ? s1 : s2;
  return M * 3 * D + 2 * M * D + M * F + static_cast<size_t>(s) * M * D;
}

// x, out: (B, T, D) float32. Weights in nn.Linear (out, in) layout. act: 0 none,
// 1 erf GELU, 2 tanh GELU, 3 ReLU. `work` holds
// dsg_encoder_layer_workspace_floats(B, T, D, F) floats. Returns the first CUDA
// error of the seven launches (0 on success).
extern "C" int dsg_encoder_layer(const float* x, const float* w_in, const float* b_in,
                                 const float* w_out, const float* b_out, const float* ln1_w,
                                 const float* ln1_b, const float* w1, const float* b1,
                                 const float* w2, const float* b2, const float* ln2_w,
                                 const float* ln2_b, float* work, float* out, int B, int T,
                                 int D, int H, int F, int act, float attn_scale, float eps,
                                 cudaStream_t stream) {
  // the float4 loads need 16-byte aligned rows of x, the weights and the workspace
  const void* ptrs[] = {x, w_in, w_out, w1, w2, work};
  for (const void* p : ptrs) {
    if (reinterpret_cast<size_t>(p) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (D % H || (D / H) % 4 || D % 4 || F % 4 || D > 32 * kMaxPerLane) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int M = B * T;
  float* qkv = work;
  float* attn = qkv + static_cast<size_t>(M) * 3 * D;
  float* y = attn + static_cast<size_t>(M) * D;
  float* hidden = y + static_cast<size_t>(M) * D;
  float* partial = hidden + static_cast<size_t>(M) * F;
  const int ln_blocks = (M + kLnThreads / 32 - 1) / (kLnThreads / 32);
  cudaError_t e;
#define DSG_TRY(call)                         \
  if ((e = (call)) != cudaSuccess) return static_cast<int>(e)

  DSG_TRY(gemm(x, w_in, b_in, qkv, M, 3 * D, D, 1, kNone, stream));

  const size_t smem = attention_smem(T, D / H);
  if (smem > 48 * 1024) {
    DSG_TRY(cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem)));
  }
  attention_kernel<<<dim3(B * H, (T + kQTile - 1) / kQTile), kAttnThreads, smem, stream>>>(
      qkv, attn, T, D, H, attn_scale);
  DSG_TRY(cudaGetLastError());

  const int s1 = k_splits(M, D, D);
  DSG_TRY(gemm(attn, w_out, nullptr, partial, M, D, D, s1, kNone, stream));
  residual_layernorm_kernel<<<ln_blocks, kLnThreads, 0, stream>>>(
      partial, split_count(D, s1), b_out, x, ln1_w, ln1_b, y, M, D, eps);
  DSG_TRY(cudaGetLastError());

  DSG_TRY(gemm(y, w1, b1, hidden, M, F, D, 1, act, stream));

  const int s2 = k_splits(M, D, F);
  DSG_TRY(gemm(hidden, w2, nullptr, partial, M, D, F, s2, kNone, stream));
  residual_layernorm_kernel<<<ln_blocks, kLnThreads, 0, stream>>>(
      partial, split_count(F, s2), b2, y, ln2_w, ln2_b, out, M, D, eps);
  DSG_TRY(cudaGetLastError());
#undef DSG_TRY
  return 0;
}
