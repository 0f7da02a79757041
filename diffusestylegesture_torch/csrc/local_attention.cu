// Windowed causal local attention for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel
// `diffusestylegesture_tpu/ops/local_attention_pallas.py::local_attention_pallas`
// (kernel body `_kernel`). Semantics, on (batch, head, N, D) q/k/v:
//   * the sequence is cut into N/w windows of w tokens; each query window
//     attends to 2w keys, [previous window | own window];
//   * keys are masked causally on global positions (query pos < key pos);
//   * window 0's "previous" keys and values are -1.0; only the user mask
//     (pad positions count as False) removes them, and with no mask they
//     ARE attended (reference quirk, `local_attention_pallas.py:95-98`);
//   * head h of batch element b takes row b of the (batch, N) mask;
//   * scale D^-0.5, masking with -FLT_MAX (never -inf, so a fully masked row
//     gives the uniform average over all 2w keys as JAX does, not NaN),
//     softmax in float32.
//
// What bounds it on an H100: nothing but launch and load latency at the shapes
// the denoisers use (batch*heads = 8..16, N = 88 or 150, w = 11 or 15, D = 32,
// 48 or 64): q/k/v/out are well under 1 MB (~0.1 us at 3.35 TB/s) and the work
// is a few MFLOP. The design therefore spends as few dependent steps as it can
// between the launch and the store:
//   * one block per (window, head, batch), one warp per query row (w warps);
//   * the [previous | own] K and V tiles go to shared memory in 16-byte
//     cp.async copies, row and column taken from the thread index once; the
//     kernel divides nothing (an integer division costs it ~0.1 us): blocks
//     come from a 3-D grid and the copy's geometry from the host. Window 0's
//     pad rows are written from registers.
//     When q, k and v are one tensor (the denoisers' case) one tile is loaded
//     and Q is its own-window rows;
//   * one __syncthreads after the tile load, and none after it: lane j of a
//     warp owns key j (j and j+32 when 2w > 32), computes q_i . k_j with
//     float4 reads (rows padded so that the 16-byte reads do not conflict),
//     masks, and the row's max and sum are two warp reductions. The
//     probabilities stay in registers and reach the value product by
//     __shfl_sync: the warp is cut into groups of D/4 lanes, each lane owns a
//     float4 of output features, group g sums keys g, g + groups, ..., and
//     the groups' sums are added in a fixed tree. Keys past i + w are
//     causally masked for every row and are never computed;
//   * what is left after the load is bound by the SM's shared-memory pipe
//     (every row's warp reads the whole K and V tile) and by latency, so the
//     hot loops read shared memory through 32-bit addresses taken once
//     (ld.shared; the compiler otherwise rebuilds the window's base in the
//     loop) with four steps' loads in flight;
//   * the boolean mask is read as it is (one byte an element), and q/k/v/out
//     are addressed through element strides of the batch, head and position
//     axes, so no copy kernel feeds the kernel or undoes its layout;
//   * launched with cudaLaunchKernelEx and programmatic stream serialization:
//     everything before griddepcontrol.wait overlaps the tail of the kernel
//     before it on the stream. It does not release its own dependents early
//     (griddepcontrol.launch_dependents): back to back, the waiting blocks of
//     the calls behind it took its SMs and doubled its time.
// Fixed reduction order and no atomics: two calls on one input are bitwise equal.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int kMaxWindow = 32;   // warps a block: one per query row
constexpr int kMaxDim = 128;
constexpr int kMaxGridYZ = 65535;  // heads and batch are the grid's y and z
// q, k and v tiles of the largest shape: (w + 2w + 2w) rows of D + 4 floats
constexpr size_t kSmemLimit = sizeof(float) * 5 * kMaxWindow * (kMaxDim + 4);

// Element strides of the batch, head and position axes; the feature axis is unit-stride.
struct Strides {
  long long b, h, n;
};

struct Params {
  const float *q, *k, *v;
  const unsigned char* mask;  // (batch, n), non-zero = attend; or null
  float* out;
  Strides sq, sk, sv, so;
  int n, w, d;
  int alias;  // q, k and v are one tensor: load one tile
  int groups;  // 16-byte path: lane groups of d / 4 lanes that share the value product
  // The tile copy's geometry, from the host so that the kernel divides nothing:
  // copies a row (d / 4 on the 16-byte path, else d), 1 / cols, and the rows
  // and columns a thread advances by a pass of the block's threads.
  int cols, row_step, col_step;
  float inv_cols;
  float scale;
};

// The warp's maximum in one redux.sync: a float's bits, with the magnitude
// flipped when negative, order as a signed integer as the float does.
__device__ __forceinline__ float warp_max(float v) {
  int key = __float_as_int(v);
  key ^= (key >> 31) & 0x7fffffff;
  key = __reduce_max_sync(0xffffffffu, key);
  key ^= (key >> 31) & 0x7fffffff;
  return __int_as_float(key);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
// Wait until the kernels before this one on the stream have completed and their writes are visible.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
// Reads of the tiles through a 32-bit shared-memory address. Volatile: they
// stay behind the barrier that follows the tile load.
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void fma4(float4& acc, const float4& x, const float4& y) {
  acc.x = fmaf(x.x, y.x, acc.x);
  acc.y = fmaf(x.y, y.y, acc.y);
  acc.z = fmaf(x.z, y.z, acc.z);
  acc.w = fmaf(x.w, y.w, acc.w);
}

// Phase marks, compiled in only with -DDSG_PHASES (scripts/local_attention_timing.py
// --phases): lane 0 of each block's last warp (the row with the most keys)
// records the global timer and its SM's cycle counter at mark i;
// dsg_local_attention_phases copies them out.
#ifdef DSG_PHASES
constexpr int kPhaseBlocks = 512, kPhaseMarks = 8;
__device__ unsigned long long g_phases[kPhaseBlocks][kPhaseMarks][2];
__device__ __forceinline__ void mark(int i) {
  const int block = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (threadIdx.x == blockDim.x - 32 && block < kPhaseBlocks) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    g_phases[block][i][0] = t;
    g_phases[block][i][1] = clock64();
  }
}
#else
__device__ __forceinline__ void mark(int) {}
#endif

// Floats between the rows of a tile in shared memory. 16-byte path: a
// multiple of 4 whose quarter is odd, so that the float4 reads of eight lanes
// (eight rows, one column) cover all 32 banks. Scalar path: odd.
__host__ __device__ constexpr int row_stride(int d, bool vec) {
  return vec ? ((d >> 2) & 1 ? d : d + 4) : (d | 1);
}

// Copies rows [0, rows) of a (rows x d) tile whose row r lies at src + (r - pad) * stride
// into dst (row stride kd); rows below `pad` are filled with -1.0 from registers.
// (r, c) is the thread's first row and copy within it.
template <bool VEC>
__device__ __forceinline__ void load_tile(const Params& p, float* dst, const float* src,
                                          long long stride, int rows, int pad, int kd, int r,
                                          int c) {
  while (r < rows) {
    if constexpr (VEC) {
      float* to = dst + r * kd + 4 * c;
      if (r < pad) {
        *reinterpret_cast<float4*>(to) = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
      } else {
        cp_async16(to, src + (r - pad) * stride + 4 * c);
      }
    } else {
      dst[r * kd + c] = r < pad ? -1.0f : __ldg(src + (r - pad) * stride + c);
    }
    r += p.row_step;
    c += p.col_step;
    if (c >= p.cols) {
      c -= p.cols;
      ++r;
    }
  }
}

// NK: keys a lane owns (ceil(2w / 32)); VEC: 16-byte copies, reads and stores
// (d % 4 == 0, 16-byte aligned rows), else scalar ones.
template <int NK, bool VEC>
__global__ void __launch_bounds__(32 * kMaxWindow, 1)
local_attention_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  mark(0);
  const int lane = threadIdx.x & 31;
  const int i = threadIdx.x >> 5;  // this warp's query row within the window
  const int w = p.w, w2 = 2 * w, d = p.d, n = p.n;
  const int kd = row_stride(d, VEC);
  const int q0 = blockIdx.x * w;  // first query position of this window
  const int h = blockIdx.y, b = blockIdx.z;
  const int pad = q0 == 0 ? w : 0;  // window 0: the previous window is the -1.0 pad

  float* ks = smem;                                      // [2w][kd]
  float* vs = p.alias ? ks : ks + w2 * kd;               // [2w][kd]
  float* qs = p.alias ? ks + w * kd : ks + 2 * w2 * kd;  // [w][kd]

  grid_dependency_wait();
  mark(1);
  // first key position whose row is loaded: q0 - w, or 0 for window 0
  const long long k0 = q0 - w + pad;
  // thread t copies (row t / cols, copy t % cols) first: the quotient through
  // the host's reciprocal, exact for t < 1024 and cols <= 128
  const int r0 = __float2int_rz((threadIdx.x + 0.5f) * p.inv_cols);
  const int c0 = threadIdx.x - r0 * p.cols;
  const float* k_src = p.k + b * p.sk.b + h * p.sk.h + k0 * p.sk.n;
  load_tile<VEC>(p, ks, k_src, p.sk.n, w2, pad, kd, r0, c0);
  if (!p.alias) {
    const float* v_src = p.v + b * p.sv.b + h * p.sv.h + k0 * p.sv.n;
    const float* q_src = p.q + b * p.sq.b + h * p.sq.h + q0 * p.sq.n;
    load_tile<VEC>(p, vs, v_src, p.sv.n, w2, pad, kd, r0, c0);
    load_tile<VEC>(p, qs, q_src, p.sq.n, w, 0, kd, r0, c0);
  }
  // this lane's keys: attended unless the user mask or the sequence start removes them
  bool keep[NK];
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    const int j = lane + 32 * t;
    keep[t] = j <= i + w;  // causal: key position q0 - w + j <= query position q0 + i
    if (p.mask != nullptr && keep[t]) {
      const int pos = q0 - w + j;
      keep[t] = pos >= 0 && p.mask[static_cast<long long>(b) * n + pos] != 0;
    }
  }
  if constexpr (VEC) cp_async_wait_all();
  mark(2);
  __syncthreads();
  mark(3);

  // scores of this row against this lane's keys
  const uint32_t ks_a = static_cast<uint32_t>(__cvta_generic_to_shared(ks));
  const uint32_t vs_a = static_cast<uint32_t>(__cvta_generic_to_shared(vs));
  const uint32_t q_a = static_cast<uint32_t>(__cvta_generic_to_shared(qs + i * kd));
  float s[NK];
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    const int j = lane + 32 * t;
    s[t] = -FLT_MAX;
    if (keep[t]) {
      float dot;
      if constexpr (VEC) {
        const uint32_t k_a = ks_a + 4 * j * kd;
        const int d4 = d >> 2;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        int c = 0;
        for (; c + 4 <= d4; c += 4) {  // four steps' loads in flight
          float4 x[4], y[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            x[u] = lds128(q_a + 16 * (c + u));
            y[u] = lds128(k_a + 16 * (c + u));
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) fma4(acc, x[u], y[u]);
        }
        for (; c < d4; ++c) fma4(acc, lds128(q_a + 16 * c), lds128(k_a + 16 * c));
        dot = (acc.x + acc.y) + (acc.z + acc.w);
      } else {
        const float *qrow = qs + i * kd, *krow = ks + j * kd;
        dot = 0.0f;
        for (int c = 0; c < d; ++c) dot = fmaf(qrow[c], krow[c], dot);
      }
      s[t] = dot * p.scale;
    }
  }

  // softmax over the 2w keys: two warp reductions, probabilities stay in registers
  float m = s[0];
#pragma unroll
  for (int t = 1; t < NK; ++t) m = fmaxf(m, s[t]);
  m = warp_max(m);
  float e[NK], sum = 0.0f;
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    e[t] = lane + 32 * t < w2 ? expf(s[t] - m) : 0.0f;
    sum += e[t];
  }
  sum = warp_sum(sum);
  mark(4);

  // values. Keys past i + w weigh 0, except in a fully masked row, which is
  // the average of all 2w.
  const int keys = m == -FLT_MAX ? w2 : i + w + 1;
  float* orow = p.out + b * p.so.b + h * p.so.h + static_cast<long long>(q0 + i) * p.so.n;
  if constexpr (VEC) {
    // The warp is cut into p.groups groups of d/4 lanes: group g sums keys g,
    // g + groups, ... into the float4 of output features its lane owns, the
    // groups' sums are added in a fixed tree, and group 0 stores the row.
    const int d4 = d >> 2, groups = p.groups;
    const int g = __float2int_rz((lane + 0.5f) * p.inv_cols);  // lane / d4
    const int cq = lane - g * d4;
    const uint32_t v_a = vs_a + 16 * cq;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int j0 = 0; j0 < keys; j0 += groups) {
      const int j = j0 + g;  // this lane's key; its probability is in lane j % 32
      float pj = __shfl_sync(0xffffffffu, e[0], j & 31);
      if constexpr (NK == 2) {
        const float hi = __shfl_sync(0xffffffffu, e[1], j & 31);
        pj = j < 32 ? pj : hi;
      }
      // no branch: a lane without a key reads the last row and weighs it 0
      pj = g < groups && j < keys ? pj : 0.0f;
      const float4 x = lds128(v_a + 4 * min(j, w2 - 1) * kd);
      fma4(a, make_float4(pj, pj, pj, pj), x);
    }
    mark(5);
    for (int s = groups >> 1; s > 0; s >>= 1) {
      a.x += __shfl_down_sync(0xffffffffu, a.x, s * d4);
      a.y += __shfl_down_sync(0xffffffffu, a.y, s * d4);
      a.z += __shfl_down_sync(0xffffffffu, a.z, s * d4);
      a.w += __shfl_down_sync(0xffffffffu, a.w, s * d4);
    }
    if (lane < d4) {
      const float inv = 1.0f / sum;
      *reinterpret_cast<float4*>(orow + 4 * lane) =
          make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
    }
  } else {
    // lane c owns output feature c, then c + 32, ...
    for (int c0 = 0; c0 < d; c0 += 32) {
      const int c = c0 + lane;
      float a = 0.0f;
      for (int j = 0; j < keys; ++j) {
        float pj = __shfl_sync(0xffffffffu, e[0], j & 31);
        if constexpr (NK == 2) {
          const float hi = __shfl_sync(0xffffffffu, e[1], j & 31);
          pj = j < 32 ? pj : hi;
        }
        if (c < d) a = fmaf(pj, vs[j * kd + c], a);
      }
      if (c < d) orow[c] = a / sum;
    }
    mark(5);
  }
  mark(6);
}

// The launch alone: the same grid, block, shared memory and launch attributes, no work.
__global__ void __launch_bounds__(32 * kMaxWindow) local_attention_empty_kernel(int) {
  grid_dependency_wait();
}

// Raises `Kernel`'s dynamic shared-memory limit to kSmemLimit on the current
// device, once per device: the attribute belongs to a device, so a process that
// launches on a second card opts in there too. A failed opt-in is not recorded,
// and its error goes back to the wrapper, which raises.
constexpr int kMaxDevices = 64;
template <auto Kernel>
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> lock(mu);
  if (!done[dev].load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemLimit));
    if (e != cudaSuccess) return e;
    done[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

// Launches `Kernel` with Programmatic Dependent Launch on `stream`. The
// kernel's dynamic shared-memory limit is raised first, once per device.
template <auto Kernel, typename... Args>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t stream, Args... args) {
  const cudaError_t allowed = allow_smem<Kernel>();
  if (allowed != cudaSuccess) return allowed;
  if (smem > kSmemLimit) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, Kernel, args...);
}

template <int NK>
cudaError_t launch_vec(bool vec, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                       const Params& p) {
  return vec ? launch<local_attention_kernel<NK, true>>(grid, threads, smem, stream, p)
             : launch<local_attention_kernel<NK, false>>(grid, threads, smem, stream, p);
}

bool shape_ok(int batch, int heads, int n, int w, int d) {
  return batch >= 1 && batch <= kMaxGridYZ && heads >= 1 && heads <= kMaxGridYZ && n >= 1 &&
         w >= 1 && w <= kMaxWindow && n % w == 0 && d >= 1 && d <= kMaxDim;
}

bool aligned16(const void* ptr, const Strides& s) {
  return reinterpret_cast<size_t>(ptr) % 16 == 0 && s.b % 4 == 0 && s.h % 4 == 0 && s.n % 4 == 0;
}

size_t smem_bytes(int w, int d, bool alias, bool vec) {
  return sizeof(float) * (alias ? 2 : 5) * w * row_stride(d, vec);
}

}  // namespace

// Dynamic shared memory (bytes) of one block: the K tile alone when q, k and v
// alias, else the K, V and Q tiles; `vec` selects the 16-byte path's row padding.
extern "C" size_t dsg_local_attention_smem_bytes(int w, int d, int alias, int vec) {
  return smem_bytes(w, d, alias != 0, vec != 0);
}

// q, k, v, out: (batch, heads, n, d) float32 addressed through the element
// strides (batch, head, position) given for each; the feature axis is
// unit-stride. mask: (batch, n) bytes, non-zero = attend, contiguous; or null.
// alias: q, k and v are the same tensor (same pointer and strides). 1 <= w <=
// 32 divides n, 1 <= d <= 128, batch and heads <= 65535. The 16-byte path runs
// when d, every stride and every pointer allow it, else the scalar one.
// Returns the CUDA error of the launch (0 on success).
extern "C" int dsg_local_attention(const float* q, const float* k, const float* v,
                                   const unsigned char* mask, float* out, int batch, int heads,
                                   int n, int w, int d, long long q_sb, long long q_sh,
                                   long long q_sn, long long k_sb, long long k_sh,
                                   long long k_sn, long long v_sb, long long v_sh,
                                   long long v_sn, long long o_sb, long long o_sh,
                                   long long o_sn, int alias, float scale, cudaStream_t stream) {
  if (!shape_ok(batch, heads, n, w, d)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k, v, mask, out, {q_sb, q_sh, q_sn}, {k_sb, k_sh, k_sn}, {v_sb, v_sh, v_sn},
           {o_sb, o_sh, o_sn}, n, w, d, alias != 0, 1, 0, 0, 0, 0.0f, scale};
  const bool vec = d % 4 == 0 && aligned16(q, p.sq) && aligned16(k, p.sk) &&
                   aligned16(v, p.sv) && aligned16(out, p.so);
  if (vec) {
    // the most groups of d / 4 lanes a warp holds, a power of two for the tree sum
    while (2 * p.groups * (d / 4) <= 32) p.groups *= 2;
  }
  p.cols = vec ? d / 4 : d;
  p.row_step = 32 * w / p.cols;
  p.col_step = 32 * w % p.cols;
  p.inv_cols = 1.0f / static_cast<float>(p.cols);
  const size_t smem = smem_bytes(w, d, p.alias, vec);
  const dim3 grid(n / w, heads, batch);
  const cudaError_t e = 2 * w <= 32 ? launch_vec<1>(vec, grid, 32 * w, smem, stream, p)
                                    : launch_vec<2>(vec, grid, 32 * w, smem, stream, p);
  return static_cast<int>(e);
}

// Launches an empty kernel the way dsg_local_attention launches its own for
// these shapes (grid, block, shared memory of the aliased 16-byte path, launch
// attributes): the time of the launch itself, for the timing scripts.
extern "C" int dsg_local_attention_empty(int batch, int heads, int n, int w, int d,
                                         cudaStream_t stream) {
  if (!shape_ok(batch, heads, n, w, d)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<local_attention_empty_kernel>(
      dim3(n / w, heads, batch), 32 * w, smem_bytes(w, d, true, d % 4 == 0), stream, 0));
}

// Writes the dimensions of the phase record to `dims` (blocks, marks a block,
// values a mark: global timer ns and SM cycles) and, unless `out` is null,
// copies the last run's record into `out`. Returns the number of values in
// the record, 0 when the library was built without DSG_PHASES or the copy
// failed.
extern "C" int dsg_local_attention_phases(unsigned long long* out, int* dims) {
#ifdef DSG_PHASES
  dims[0] = kPhaseBlocks;
  dims[1] = kPhaseMarks;
  dims[2] = 2;
  if (out != nullptr &&
      cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases)) != cudaSuccess) {
    return 0;
  }
  return static_cast<int>(sizeof(g_phases) / sizeof(unsigned long long));
#else
  (void)out;
  (void)dims;
  return 0;
#endif
}
