// One post-norm transformer encoder layer (torch 1.9 nn.TransformerEncoderLayer,
// inference) for Hopper (sm_90a), on tensor cores, in four grids.
//
// Replaces the Pallas TPU kernel
// `diffusestylegesture_tpu/ops/encoder_layer_pallas.py::encoder_layer_pallas`
// (kernel body `_layer_kernel`, stacked by `fused_trunk_apply`), in both of its
// operand modes. Semantics:
//   qkv = x Win^T + bin                       (packed D -> 3D projection)
//   a   = softmax(q_h k_h^T * hd^-0.5) v_h    (H heads over the T valid keys)
//   y   = LN1(x + a Wout^T + bout)            (eps from the layer, two-pass)
//   out = LN2(y + act(y W1^T + b1) W2^T + b2)
// with act chosen at run time (erf GELU, tanh GELU or ReLU); the Pallas kernel
// hard-codes erf GELU whatever the config says, this one does not. Weights are
// taken as torch stores them, nn.Linear (out, in), f32, with no per-call copy.
//
// Operand modes. f32 (the main path): every product is 3xTF32 on mma.sync
// m16n8k8. Each operand is split into big (its top 19 bits, a tf32 value) and
// small = a - big (exact in f32; the tensor core reads its top 19 bits), and
// big*big, big*small and small*big go to three separate f32 sums, which keeps
// the layer within 1e-4 of a float32 layer (plain TF32 keeps ~3 digits). bf16
// (`mxu_bf16`, the Pallas kernel's `mxu_bf16=True`): mma.sync m16n8k16 with
// exactly the operands the Pallas kernel rounds rounded to bf16 (x, Win, q, k,
// the softmax probabilities, v, the attention output, Wout, y, W1, the
// activated hidden rows, W2) and f32 sums; the score scale is applied after
// the QK^T product. Operands stay f32 in memory and shared memory and are
// rounded when the fragments are built.
//
// What bounds it on an H100: at the denoiser's shapes (B*T = 89..178 rows,
// D = 256, H = 4, F = 1024) one layer is 148 MFLOP at batch 1 against 3.3 MB
// of f32 weights and activations: 1.0 us of HBM traffic at 3.35 TB/s against
// 0.9 us for the three TF32 products at 495 TFLOP/s (0.15 us in bf16), so
// ~1.0 us at B=1 (bytes) and 1.8 us at B=2 (operations). The 8 layers'
// weights stay in the 50 MB L2 across a sampling loop. What bounds it in
// practice (phase marks of scripts/encoder_layer_timing.py): each grid waits
// ~1.3 us after its predecessor ends before griddepcontrol.wait returns, its
// first activation load takes ~1 us, mma.sync runs 3xTF32 at ~1,300 cycles
// per 16 x 128 x 64 product on one SM (a quarter of wgmma's rate), and a
// block that streams weights through shared memory during its products
// stalls on them.
//
// Design:
//   * four grids, each launched with cudaLaunchKernelEx and Programmatic
//     Dependent Launch. A grid issues all its weight loads (cp.async, each
//     64-column chunk of a panel in a place of its own, or a ring of up to 8
//     stages when they do not fit) and its bias and norm vectors before
//     griddepcontrol.wait, so they land while the previous grid runs, and
//     reads activations only after the wait. This chains across layers on a
//     stream. At the denoiser's shapes every grid's weights fit, so no grid
//     loads weights after its wait.
//       1. QKV      qkv = x Win^T + bin; one block per 16 rows x 64 columns
//       2. attn     one block per (batch, head, 16 queries): S = Q K^T,
//                   softmax, O = P V on tensor cores; Q, K, V, P in shared
//                   memory; each warp owns its tiles. Where one head's
//                   keys and values do not fit in shared memory whole
//                   (T > 176 at head dim 128, T > 336 at head dim 64),
//                   the key-tiled grid streams them in tiles of 64 keys
//                   with an online softmax instead; the host picks the
//                   grid from the shape (dsg_encoder_layer_key_tile)
//       3. out+FF1  one 8-block cluster per 16 rows: block r computes the
//                   pre-norm columns [r D/8, (r+1) D/8) of x + a Wout^T + bout;
//                   after one cluster barrier every block reads all 16 rows
//                   through distributed shared memory, normalises them (LN1)
//                   into its A operand and computes its F/8 hidden columns
//                   h = act(y W1^T + b1); block r writes y's rows 2r, 2r+1
//                   and its columns of h
//       4. FF2+LN2  one 8-block cluster per 16 rows: block r multiplies its
//                   F/8 columns of h by the same columns of W2; after one
//                   cluster barrier it sums its 2 rows' partials over the
//                   cluster in rank order, adds b2 + y and normalises (LN2)
//     h and y go through device memory as activations; no split-K partial
//     does.
//   * a warp's products: up to 4 n-tiles at once, k16 steps shared by up to 4
//     warps (k-groups, summed in a fixed order), no predicated mma and no
//     division in the loop.
//   * no atomics: every sum runs in a fixed order, so two calls on the same
//     input give bitwise-equal output.
//   * 16-row m-tiles (mma.sync granularity) waste 7% on 89 rows where wgmma's
//     64-row tiles would waste up to 30%.
//   * the LayerNorms are two-pass (mean, then squared deviations), one warp
//     per row.
//
// Times per layer at B=1 on an H100 80GB HBM3 at 700 W. chip_smoke.py: the
// seven-grid SIMT design that came before (split-K partials through an L2
// workspace read back by two LayerNorm grids, scalar attention loops) took
// 223, then 93.5, then 45.4 us; the first four-grid tensor-core version
// (3xTF32 splits of 9 instructions a value, per-chunk integer divisions, four
// cluster barriers per LayerNorm, W2 streamed after W1 in one MLP grid) 53.9
// us. scripts/encoder_layer_timing.py, in one process: this one 38.1 us (46.3
// at B=2; bf16 mode 31.6 and 39.2), the seven-grid one beside it 47.0 (54.0).
// The key-tiled attention grid (chip_smoke.py phase 13, same card): a layer at
// (6, 197, 512), H=4 takes 0.472 ms against 0.281 ms for the plain layer and
// 4.62 ms against 1.70 at B=64; it reloads each K/V tile per 16-query block
// and does not overlap the copies with the products.
#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

enum Activation { kNone = 0, kGeluErf = 1, kGeluTanh = 2, kRelu = 3 };

constexpr int kThreads = 256;  // 8 warps in every grid
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;        // rows per block: one mma m-tile
constexpr int kCluster = 8;      // blocks per cluster in grids 3 and 4 (portable size)
constexpr int kRowsPerBlock = kRows / kCluster;  // rows each block normalises
constexpr int kKc = 64;          // k-width of one weight stage: 4 k16 steps
constexpr int kMaxStages = 8;    // weight ring depth, as shared memory allows
constexpr int kNtMax = 4;        // n-tiles (of 8 columns) per warp
constexpr int kPanelRows = 128;  // weight rows per panel: 16 n-tiles
constexpr int kQkvCols = 64;     // output columns per block of grid 1
constexpr int kRedFloats = kWarps * kNtMax * 4 * 32;  // k-group partials of a block, 16 KB
constexpr int kMaxWidth = 1024;  // D
constexpr int kMaxVec = kMaxWidth / 128;  // float4 of a row per lane
constexpr size_t kSmemLimit = 227 * 1024;

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Row stride (floats) of a k-contiguous shared tile of n columns: it covers
// round_up(n, kKc) and is 16 mod 32, so the float4 fragment loads of a quarter
// warp (2 rows x 4 lanes) fall on 32 distinct banks.
__host__ __device__ constexpr int kstride(int n) { return round_up(n, kKc) + 16; }
constexpr int kStageStride = kstride(kKc);  // 80
// Row stride of V, read k-major (rows = keys): 4 mod 32 keeps the 16-byte row
// alignment of the copies and limits the fragment loads to 2-way conflicts.
__host__ __device__ constexpr int vstride(int n) { return round_up(n, 32) + 4; }

// Columns of a slice when n columns are split over the cluster (multiple of 8).
__host__ __device__ constexpr int slice(int n) { return round_up((n + kCluster - 1) / kCluster, 8); }

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

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// ---- PTX: asynchronous copies, dependent launch, tensor-core products ----------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");  // src-size 0 zero-fills the 16 bytes
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Waits until at most n (0..kMaxStages-2) of this thread's copy groups are
// still in flight.
static_assert(kMaxStages <= 8, "cp_async_wait_pending covers up to 6 pending groups");
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}
// Waits for all of this block's copies.
__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}
// Wait until the grids this one depends on have completed and their writes are visible.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
// The two halves of a cluster barrier: arrive (releasing this block's shared
// memory writes and reads) and wait (acquiring the other blocks').
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// Let the next grid on the stream launch (its pre-wait prologue) now.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Phase marks, compiled in only with -DDSG_PHASES (scripts/encoder_layer_timing.py
// --phases): thread 0 of each block records the global timer and its SM's
// cycle counter at mark i of grid g; dsg_encoder_layer_phases copies them out.
#ifdef DSG_PHASES
constexpr int kPhaseGrids = 4, kPhaseBlocks = 256, kPhaseMarks = 8;
__device__ unsigned long long g_phases[kPhaseGrids][kPhaseBlocks][kPhaseMarks][2];
__device__ __forceinline__ void mark(int g, int i) {
  const int b = blockIdx.x + gridDim.x * blockIdx.y;
  if (threadIdx.x == 0 && b < kPhaseBlocks) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    g_phases[g][b][i][0] = t;
    g_phases[g][b][i][1] = clock64();
  }
}
#else
__device__ __forceinline__ void mark(int, int) {}
#endif

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}
// 3xTF32 split: big keeps the top 19 bits (a tf32 value), small = v - big is
// exact; the tensor core reads the top 19 bits of small (2 instructions per
// value, where cvt.rna.tf32 alone takes 4).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}
// Not volatile: the products have no side effects, so the compiler may
// interleave independent ones.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- a warp's 16 x 8 tiles ------------------------------------------------------
// Lane (g = lane / 4, t = lane % 4) holds A at rows g and g + 8, columns
// 4t..4t+3 (one float4 each), and the same four k of B column n = 8 tile + g.
// The sum over k does not depend on which k each fragment slot holds, as long
// as A and B agree, so the fragments take these columns in place of the PTX
// layout's: tf32 k8 slots (t, t+4) <- columns (4t, 4t+1), then (4t+2, 4t+3);
// bf16 k16 slot pairs (2t, 2t+1) <- (4t, 4t+1) and (2t+8, 2t+9) <- (4t+2, 4t+3).

// How a block's warps share a 16 x (8 ntiles) product: ng n-groups (a power of
// two) of up to kNtMax tiles each (tile n = ngi + ng j) times kg = kWarps / ng
// k-groups, each taking every kg-th k16 step; kg is at most max_kg. nt is this
// warp's number of tiles. Callers split products of more than kWarps * kNtMax
// tiles.
struct Split {
  int ng, kg, ngi, kgi, nt;
  __device__ Split(int ntiles, int max_kg) {
    int lg = 0;
    while ((kWarps >> lg) > max_kg) ++lg;
    while ((kNtMax << lg) < ntiles && (1 << lg) < kWarps) ++lg;
    ng = 1 << lg;
    kg = kWarps >> lg;
    const int warp = threadIdx.x >> 5;
    ngi = warp & (ng - 1);
    kgi = warp >> lg;
    nt = 0;
#pragma unroll
    for (int j = 0; j < kNtMax; ++j) nt += ngi + ng * j < ntiles;
  }
};

// acc[j] += A[16 x kc] . B[8 n .. 8 n + 8][kc]^T for this warp's NT tiles, over
// its k-group's k16 steps (kgi, kgi + kg, ...; kc is a multiple of 16 kg or the
// steps past it are zero). A is k-contiguous (stride sa); B is n-major
// k-contiguous rows (stride sb), or, with KMajorB, k-major rows of n (stride
// sb). In f32 mode the 3xTF32 products go to three sums, big*big to acc and the
// two small terms to s1 and s2, so that no product waits on another of its
// step; s1 + s2 are added to acc at the end.
template <bool BF16, bool KMajorB, int NT>
__device__ __forceinline__ void warp_mma_n(float (&acc)[kNtMax][4], const Split& sp,
                                           const float* A, int sa, const float* B, int sb,
                                           int kc) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = A + g * sa + 4 * t;
  const float* a1 = a0 + 8 * sa;
  const float* bp[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = sp.ngi + sp.ng * j;
    bp[j] = KMajorB ? B + 4 * t * sb + n * 8 + g : B + (n * 8 + g) * sb + 4 * t;
  }
  float s1[NT][4] = {}, s2[NT][4] = {};
  for (int k = 16 * sp.kgi; k < kc; k += 16 * sp.kg) {
    const float4 lo = ld4(a0 + k), hi = ld4(a1 + k);
    float4 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if constexpr (KMajorB) {
        const float* p = bp[j] + k * sb;
        b[j] = make_float4(p[0], p[sb], p[2 * sb], p[3 * sb]);
      } else {
        b[j] = ld4(bp[j] + k);
      }
    }
    if constexpr (BF16) {
      const uint32_t a[4] = {pack_bf16(lo.x, lo.y), pack_bf16(hi.x, hi.y), pack_bf16(lo.z, lo.w),
                             pack_bf16(hi.z, hi.w)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mma_bf16(acc[j], a, pack_bf16(b[j].x, b[j].y), pack_bf16(b[j].z, b[j].w));
      }
    } else {
      const float av[2][4] = {{lo.x, hi.x, lo.y, hi.y}, {lo.z, hi.z, lo.w, hi.w}};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t abig[4], asmall[4], bb[NT][2], bs[NT][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(av[s][i], abig[i], asmall[i]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          split_tf32(s ? b[j].z : b[j].x, bb[j][0], bs[j][0]);
          split_tf32(s ? b[j].w : b[j].y, bb[j][1], bs[j][1]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(s1[j], asmall, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(s2[j], abig, bs[j][0], bs[j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[j], abig, bb[j][0], bb[j][1]);
      }
    }
  }
  if constexpr (!BF16) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += s1[j][i] + s2[j][i];
  }
}

// warp_mma_n for this warp's tile count; A and B are zero past the data.
template <bool BF16, bool KMajorB>
__device__ __forceinline__ void warp_mma(float (&acc)[kNtMax][4], const Split& sp, const float* A,
                                         int sa, const float* B, int sb, int kc) {
  switch (sp.nt) {
    case 4: warp_mma_n<BF16, KMajorB, 4>(acc, sp, A, sa, B, sb, kc); break;
    case 3: warp_mma_n<BF16, KMajorB, 3>(acc, sp, A, sa, B, sb, kc); break;
    case 2: warp_mma_n<BF16, KMajorB, 2>(acc, sp, A, sa, B, sb, kc); break;
    case 1: warp_mma_n<BF16, KMajorB, 1>(acc, sp, A, sa, B, sb, kc); break;
    default: break;
  }
}

// Adds the other k-groups' accumulators to k-group 0's, in k-group order (so
// the result does not depend on timing). Every thread calls it; returns true
// in the warps that then hold the result.
__device__ bool reduce_k(float (&acc)[kNtMax][4], const Split& sp, float* red) {
  if (sp.kg == 1) return true;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (sp.kgi > 0) {
#pragma unroll
    for (int j = 0; j < kNtMax; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[((warp * kNtMax + j) * 4 + i) * 32 + lane] = acc[j][i];
  }
  __syncthreads();
  if (sp.kgi == 0) {
    for (int q = 1; q < sp.kg; ++q) {
      const int w = warp + q * sp.ng;
#pragma unroll
      for (int j = 0; j < kNtMax; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] += red[((w * kNtMax + j) * 4 + i) * 32 + lane];
    }
  }
  __syncthreads();
  return sp.kgi == 0;
}

// Calls f(row, col, value) for each accumulator value of this warp's tiles (row < 16).
template <typename Fn>
__device__ __forceinline__ void for_each_acc(const float (&acc)[kNtMax][4], const Split& sp,
                                             Fn f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNtMax; ++j) {
    if (j < sp.nt) {
      const int n = sp.ngi + sp.ng * j;
#pragma unroll
      for (int i = 0; i < 4; ++i) f(g + 8 * (i >> 1), n * 8 + 2 * t + (i & 1), acc[j][i]);
    }
  }
}

// ---- copies into shared memory ------------------------------------------------------

// Rows [r0, r0 + nrows) of src (row stride ld) into dst (stride sd), columns
// [0, kfill): zero past `rows` rows and past K columns. Issues the copies only.
__device__ void issue_rows(float* dst, int sd, const float* src, size_t ld, int r0, int rows,
                           int nrows, int K, int kfill) {
  const int q = kfill / 4;
  for (int i = threadIdx.x; i < nrows * q; i += kThreads) {
    const int r = i / q, k = (i % q) * 4;
    const bool ok = r0 + r < rows && k < K;
    cp_async16(dst + r * sd + k, ok ? src + (r0 + r) * ld + k : src, ok);
  }
}

// n (a multiple of 4) floats of src into dst. Issues the copies only.
__device__ void issue_vec(float* dst, const float* src, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads) cp_async16(dst + i, src + i, true);
}

// ---- weight panels: packed in shared memory, or streamed through a ring ---------
// A panel is `rows` (<= kPanelRows) weight rows of `k` k-contiguous values;
// its chunk c is k-columns [64c, 64c + 64) of all its rows.
struct Panel {
  const float* w;  // row 0, column 0
  int ld;          // row stride of w, floats
  int rows;
  int k;
  __device__ int ntiles() const { return (rows + 7) / 8; }
  __device__ int chunks() const { return (k + kKc - 1) / kKc; }
};

// `rows` weight rows (row stride ld) of k values, cut into panels of kPanelRows.
struct Series {
  const float* w;
  int ld, rows, k;
  __device__ int panels() const { return (rows + kPanelRows - 1) / kPanelRows; }
  __device__ int chunks() const { return panels() * ((k + kKc - 1) / kKc); }
  // floats of shared memory one chunk takes
  __device__ int chunk_floats() const { return round_up(min(rows, kPanelRows), 8) * kStageStride; }
  __device__ Panel panel(int i) const {
    return Panel{w + static_cast<size_t>(i) * kPanelRows * ld, ld,
                 min(kPanelRows, rows - i * kPanelRows), k};
  }
};

// The weight chunks of a grid, in the order its products use them (the panels
// of one or two series; chunk g). With stages == 0 every chunk has a place of
// its own in shared memory and all are issued before griddepcontrol.wait;
// otherwise they stream through a ring of `stages` stages (chunk g in stage
// g % stages), stages - 1 ahead. Every chunk is one commit group, issued in
// order.
struct Stream {
  Series s[2];
  int ns, n0, total, stages;
  float* base;
  bool landed;  // every chunk has been issued and has landed (block-uniform)

  __device__ Stream(Series a, Series b, int ns_, float* base_, int stages_)
      : s{a, b}, ns(ns_), n0(a.chunks()), stages(stages_), base(base_), landed(false) {
    total = n0 + (ns > 1 ? b.chunks() : 0);
  }
  // chunks issued before the products start
  __device__ int ahead() const { return stages ? stages - 1 : total; }
  __device__ float* place(int g) const {
    if (stages) return base + (g % stages) * max(s[0].chunk_floats(), s[1].chunk_floats());
    return base + (g < n0 ? g * s[0].chunk_floats()
                          : n0 * s[0].chunk_floats() + (g - n0) * s[1].chunk_floats());
  }
  // Issues chunk g (one commit group, empty past the last chunk).
  __device__ void issue(int g) const {
    if (g < total) {
      const bool first = g < n0;
      const Series& se = first ? s[0] : s[1];
      const int gi = first ? g : g - n0;
      const int per = (se.k + kKc - 1) / kKc;
      const Panel p = se.panel(gi / per);
      const int k0 = (gi % per) * kKc, nrows = p.ntiles() * 8;
      float* st = place(g);
      for (int i = threadIdx.x; i < nrows * (kKc / 4); i += kThreads) {
        const int r = i / (kKc / 4), kk = (i % (kKc / 4)) * 4;
        const bool ok = r < p.rows && k0 + kk < p.k;
        cp_async16(st + r * kStageStride + kk,
                   ok ? p.w + static_cast<size_t>(r) * p.ld + k0 + kk : p.w, ok);
      }
    }
    cp_async_commit();
  }
  // Issued before griddepcontrol.wait: the weights do not depend on the previous grid.
  __device__ void prefetch() const {
    for (int g = 0; g < ahead(); ++g) issue(g);
  }
};

// acc += A[16 x p.k] . p^T for panel p, whose first chunk is chunk g0 of the
// stream; A in shared memory (stride sa, zero past p.k up to the chunk edge).
// While chunks remain to be issued, each chunk waits for its copies and a
// block barrier, which also frees the stage the next issue refills; once the
// last chunk has been issued, one wait for all and one barrier serve the rest.
template <bool BF16>
__device__ void panel_mma(float (&acc)[kNtMax][4], const Split& sp, const float* A, int sa,
                          Stream& st, int g0, const Panel& p) {
  const int nk = p.chunks();
  for (int c = 0; c < nk; ++c) {
    const int g = g0 + c;
    if (!st.landed) {
      if (g + st.ahead() >= st.total) {
        cp_async_wait<0>();
        __syncthreads();
        st.landed = true;
      } else {
        cp_async_wait_pending(st.ahead() - 1);  // chunk g has landed (this thread's copies)
        __syncthreads();                        // ... everyone's; stage (g-1) % stages is free
        st.issue(g + st.ahead());
      }
    }
    warp_mma<BF16, false>(acc, sp, A + c * kKc, sa, st.place(g), kStageStride, kKc);
  }
}

// LayerNorm of one row of D values, by one warp: fetch(c) gives the pre-norm
// float4 at column c (c % 4 == 0), emit(c, v) takes the normalised one. Two
// passes over the row in registers (the mean, then the squared deviations).
template <typename Fetch, typename Emit>
__device__ __forceinline__ void warp_layernorm(Fetch fetch, Emit emit, const float* gamma,
                                               const float* beta, int D, float eps) {
  const int lane = threadIdx.x & 31;
  float4 v[kMaxVec];
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = 4 * lane + 128 * i;
    if (c < D) v[i] = fetch(c);
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (4 * lane + 128 * i < D) s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
  }
  const float mean = warp_sum(s) / D;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (4 * lane + 128 * i < D) {
      const float a = v[i].x - mean, b = v[i].y - mean, c = v[i].z - mean, d = v[i].w - mean;
      q += (a * a + b * b) + (c * c + d * d);
    }
  }
  const float inv = 1.0f / sqrtf(warp_sum(q) / D + eps);
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = 4 * lane + 128 * i;
    if (c < D) {
      const float4 ga = ld4(gamma + c), be = ld4(beta + c);
      emit(c, make_float4((v[i].x - mean) * inv * ga.x + be.x, (v[i].y - mean) * inv * ga.y + be.y,
                          (v[i].z - mean) * inv * ga.z + be.z, (v[i].w - mean) * inv * ga.w + be.w));
    }
  }
}

// ---- grid 1: qkv = x Win^T + bin -------------------------------------------------
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
encoder_layer_qkv(const float* __restrict__ x, const float* __restrict__ w_in,
                  const float* __restrict__ b_in, float* __restrict__ qkv, int M, int D,
                  int stages) {
  extern __shared__ __align__(16) float smem[];
  const int N = 3 * D, n0 = blockIdx.x * kQkvCols, m0 = blockIdx.y * kRows;
  const int ncols = min(kQkvCols, N - n0), sa = kstride(D);
  float* xs = smem;                // [16][sa]  x rows
  float* bias = xs + kRows * sa;   // [64]
  float* red = bias + kQkvCols;    // k-group partials
  float* ring = red + kRedFloats;  // the weight chunks
  const Series w{w_in + static_cast<size_t>(n0) * D, D, ncols, D};
  Stream st(w, w, 1, ring, stages);
  mark(0, 0);
  issue_vec(bias, b_in + n0, ncols);
  st.prefetch();
  grid_dependency_wait();
  mark(0, 1);
  launch_dependents();
  issue_rows(xs, sa, x, D, m0, M, kRows, D, round_up(D, kKc));
  cp_async_wait_all();
  mark(0, 2);
  const Panel p = w.panel(0);
  const Split sp(p.ntiles(), kKc / 16);
  float acc[kNtMax][4] = {};
  panel_mma<BF16>(acc, sp, xs, sa, st, 0, p);
  mark(0, 3);
  if (reduce_k(acc, sp, red)) {
    for_each_acc(acc, sp, [&](int r, int c, float v) {
      if (m0 + r < M && c < ncols) qkv[static_cast<size_t>(m0 + r) * N + n0 + c] = v + bias[c];
    });
  }
  mark(0, 4);
}

// ---- grid 2: attention of one (batch, head, 16-query tile) -----------------------
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
encoder_layer_attention(const float* __restrict__ qkv, float* __restrict__ out, int T, int D,
                        int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int hd = D / H, b = blockIdx.x / H, h = blockIdx.x % H, q0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tk = round_up(T, 16);   // keys, padded to the P V k-step
  const int hk = round_up(hd, 16);  // head columns, padded to the Q K^T k-step
  const int hn = round_up(hd, 8);   // head columns as P V n-tiles
  const int sq = kstride(hd), sv = vstride(hd), sp_ = kstride(T);
  float* qs = smem;             // [16][sq]  Q tile
  float* ks = qs + kRows * sq;  // [tk][sq]  K
  float* vs = ks + tk * sq;     // [tk][sv]  V
  float* ps = vs + tk * sv;     // [16][sp_] scores, then probabilities
  mark(1, 0);
  grid_dependency_wait();
  mark(1, 1);
  launch_dependents();
  const size_t ld = 3 * static_cast<size_t>(D);
  const float* base = qkv + static_cast<size_t>(b) * T * ld + h * hd;
  issue_rows(qs, sq, base, ld, q0, T, kRows, hd, hk);
  issue_rows(ks, sq, base + D, ld, 0, T, tk, hd, hk);
  issue_rows(vs, sv, base + 2 * D, ld, 0, T, tk, hd, hn);
  cp_async_wait_all();
  mark(1, 2);

  // S = (Q K^T) * scale over the padded keys; each warp owns its tiles
  for (int n0 = 0; n0 < tk / 8; n0 += kWarps * kNtMax) {
    const Split sp(min(tk / 8 - n0, kWarps * kNtMax), 1);
    float acc[kNtMax][4] = {};
    warp_mma<BF16, false>(acc, sp, qs, sq, ks + n0 * 8 * sq, sq, hk);
    for_each_acc(acc, sp, [&](int r, int c, float v) { ps[r * sp_ + n0 * 8 + c] = v * scale; });
  }
  __syncthreads();
  mark(1, 3);

  // softmax over the T valid keys; the padded keys get probability 0
  for (int r = warp; r < kRows; r += kWarps) {
    float* row = ps + r * sp_;
    float m = -FLT_MAX;
    for (int j = lane; j < T; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
    for (int j = lane; j < T; j += 32) row[j] *= inv;
    for (int j = T + lane; j < tk; j += 32) row[j] = 0.0f;
  }
  __syncthreads();
  mark(1, 4);

  // O = P V, V read k-major
  for (int n0 = 0; n0 < hn / 8; n0 += kWarps * kNtMax) {
    const Split sp(min(hn / 8 - n0, kWarps * kNtMax), 1);
    float acc[kNtMax][4] = {};
    warp_mma<BF16, true>(acc, sp, ps, sp_, vs + n0 * 8, sv, tk);
    for_each_acc(acc, sp, [&](int r, int c, float v) {
      c += n0 * 8;
      if (q0 + r < T && c < hd) out[(static_cast<size_t>(b) * T + q0 + r) * D + h * hd + c] = v;
    });
  }
  mark(1, 5);
}

// ---- grid 2, key tiles: the same attention with keys and values in tiles ---------
// For rows of keys that do not fit in shared memory whole (T = 197 at head dim
// 128, T > 336 at head dim 64): one block per (batch, head, 16 queries), as
// above, streams K and V through shared memory `kt` keys at a time (kt = 64,
// or 32 / 16 at head dims whose 64-key tiles do not fit) and keeps a running
// maximum m and sum l per query row (online softmax). Per tile: S = (Q K^T) *
// scale; m' = max(m, max S); p = exp(S - m'), 0 on the padded keys; l = l
// exp(m - m') + sum p; O = O exp(m - m') + p V, O in f32 shared memory (each
// value owned by one thread). At the end out = O / l. The probabilities enter
// P V unnormalised (rounded to bf16 in the mxu_bf16 mode), so the result
// differs from the whole-row grid by rounding only. Shared memory depends on
// kt and the head dim, not on T. Every sum runs in a fixed order: no atomics,
// bitwise-equal repeats.
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
encoder_layer_attention_tiled(const float* __restrict__ qkv, float* __restrict__ out, int T,
                              int D, int H, float scale, int kt) {
  extern __shared__ __align__(16) float smem[];
  const int hd = D / H, b = blockIdx.x / H, h = blockIdx.x % H, q0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hk = round_up(hd, 16), hn = round_up(hd, 8);
  const int sq = kstride(hd), sv = vstride(hd), sp_ = kstride(kt);
  float* qs = smem;             // [16][sq]  Q tile
  float* ks = qs + kRows * sq;  // [kt][sq]  K tile
  float* vs = ks + kt * sq;     // [kt][sv]  V tile
  float* ps = vs + kt * sv;     // [16][sp_] scores, then unnormalised probabilities
  float* os = ps + kRows * sp_; // [16][hn]  O, the running P V
  float* ms = os + kRows * hn;  // [16]      running maximum
  float* ls = ms + kRows;       // [16]      running sum
  float* cs = ls + kRows;       // [16]      this tile's correction exp(m - m')
  mark(1, 0);
  grid_dependency_wait();
  mark(1, 1);
  launch_dependents();
  const size_t ld = 3 * static_cast<size_t>(D);
  const float* base = qkv + static_cast<size_t>(b) * T * ld + h * hd;
  issue_rows(qs, sq, base, ld, q0, T, kRows, hd, hk);
  for (int i = threadIdx.x; i < kRows * hn; i += kThreads) os[i] = 0.0f;
  if (threadIdx.x < kRows) {
    ms[threadIdx.x] = -FLT_MAX;
    ls[threadIdx.x] = 0.0f;
  }
  for (int k0 = 0; k0 < T; k0 += kt) {
    const int nk = min(kt, T - k0);  // valid keys of this tile
    issue_rows(ks, sq, base + D, ld, k0, T, kt, hd, hk);
    issue_rows(vs, sv, base + 2 * D, ld, k0, T, kt, hd, hn);
    cp_async_wait_all();
    // S = (Q K^T) * scale over the tile's kt keys
    {
      const Split sp(kt / 8, 1);
      float acc[kNtMax][4] = {};
      warp_mma<BF16, false>(acc, sp, qs, sq, ks, sq, hk);
      for_each_acc(acc, sp, [&](int r, int c, float v) { ps[r * sp_ + c] = v * scale; });
    }
    __syncthreads();
    // running maximum and sum; the padded keys get probability 0
    for (int r = warp; r < kRows; r += kWarps) {
      float* row = ps + r * sp_;
      float mt = -FLT_MAX;
      for (int j = lane; j < nk; j += 32) mt = fmaxf(mt, row[j]);
      const float m_old = ms[r], m_new = fmaxf(m_old, warp_max(mt));
      float sum = 0.0f;
      for (int j = lane; j < kt; j += 32) {
        const float e = j < nk ? expf(row[j] - m_new) : 0.0f;
        row[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[r] = corr;
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
    // O = O * corr + P V, V read k-major; each O value has one owner
    for (int n0 = 0; n0 < hn / 8; n0 += kWarps * kNtMax) {
      const Split sp(min(hn / 8 - n0, kWarps * kNtMax), 1);
      float acc[kNtMax][4] = {};
      warp_mma<BF16, true>(acc, sp, ps, sp_, vs + n0 * 8, sv, kt);
      for_each_acc(acc, sp, [&](int r, int c, float v) {
        float* o = os + r * hn + n0 * 8 + c;
        *o = *o * cs[r] + v;
      });
    }
    __syncthreads();  // K, V and P are free for the next tile
  }
  mark(1, 2);
  for (int i = threadIdx.x; i < kRows * hd; i += kThreads) {
    const int r = i / hd, c = i % hd;
    if (q0 + r < T) out[(static_cast<size_t>(b) * T + q0 + r) * D + h * hd + c] = os[r * hn + c] / ls[r];
  }
  mark(1, 5);
}

// ---- grid 3: y = LN1(x + a Wout^T + bout), h = act(y W1^T + b1) -----------------
// One cluster per 16 rows. Block `rank` computes columns [rank db, rank db + db)
// of the pre-norm rows; after one cluster barrier every block normalises all
// 16 rows, read from the cluster through distributed shared memory, into the
// A operand of its slice of linear1: hidden columns [rank fb, rank fb + fb).
// Block `rank` writes y's rows 2 rank, 2 rank + 1 (grid 4's residual) and its
// hidden columns of h.
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
encoder_layer_out_ff1(const float* __restrict__ attn, const float* __restrict__ w_out,
                      const float* __restrict__ b_out, const float* __restrict__ x,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      float* __restrict__ y, float* __restrict__ hid, int M, int D, int F,
                      int act, float eps, int stages) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5;
  const int m0 = (blockIdx.x / kCluster) * kRows;
  const int db = slice(D), c0 = rank * db, nc = max(0, min(db, D - c0));
  const int fb = slice(F), f0 = rank * fb, nf = max(0, min(fb, F - f0));
  const int sa = kstride(D);
  float* as = smem;             // [16][sa]  attention rows, then y rows (linear1's A)
  float* vs = as + kRows * sa;  // [16][db]  x, then the pre-norm rows (this block's columns)
  float* bo = vs + kRows * db;  // [db]      bout (this block's columns)
  float* gb = bo + db;          // [2][D]    gamma, beta
  float* b1s = gb + 2 * D;      // [fb]      b1 (this block's hidden columns)
  float* wbuf = b1s + fb;       // the weight chunks
  const Series wo{w_out + static_cast<size_t>(c0) * D, D, nc, D};  // this block's Wout rows
  const Series wf{w1 + static_cast<size_t>(f0) * D, D, nf, D};     // its W1 rows
  Stream st(wo, wf, 2, wbuf, stages);
  mark(2, 0);
  issue_vec(bo, b_out + c0, nc);
  issue_vec(gb, gamma, D);
  issue_vec(gb + D, beta, D);
  issue_vec(b1s, b1 + f0, nf);
  st.prefetch();
  grid_dependency_wait();
  mark(2, 1);
  launch_dependents();
  issue_rows(as, sa, attn, D, m0, M, kRows, D, round_up(D, kKc));
  issue_rows(vs, db, x + c0, D, m0, M, kRows, nc, nc);
  cp_async_wait_all();
  mark(2, 2);
  if (nc > 0) {
    const Panel p = wo.panel(0);
    const Split sp(p.ntiles(), 1);
    float acc[kNtMax][4] = {};
    panel_mma<BF16>(acc, sp, as, sa, st, 0, p);
    for_each_acc(acc, sp, [&](int r, int c, float v) {
      if (c < nc) vs[r * db + c] += v + bo[c];
    });
  }
  cluster.sync();  // every block's columns are complete (and `as` is read)
  mark(2, 3);
  for (int r = warp; r < kRows; r += kWarps) {
    const bool own = r / kRowsPerBlock == rank && m0 + r < M;
    warp_layernorm(
        [&](int c) {
          const int q = c / db;
          return ld4(cluster.map_shared_rank(vs, q) + r * db + c - q * db);
        },
        [&](int c, float4 v) {
          *reinterpret_cast<float4*>(as + r * sa + c) = v;
          if (own) *reinterpret_cast<float4*>(y + static_cast<size_t>(m0 + r) * D + c) = v;
        },
        gb, gb + D, D, eps);
  }
  cluster_arrive();  // done with the other blocks' shared memory
  __syncthreads();   // the y rows are complete
  mark(2, 4);
  int g = wo.chunks();
  for (int i = 0; i < wf.panels(); ++i) {
    const Panel p = wf.panel(i);
    const Split sp(p.ntiles(), 1);
    float acc[kNtMax][4] = {};
    panel_mma<BF16>(acc, sp, as, sa, st, g, p);
    g += p.chunks();
    const int h0 = i * kPanelRows;
    for_each_acc(acc, sp, [&](int r, int c, float v) {
      if (m0 + r < M && c < p.rows) {
        hid[static_cast<size_t>(m0 + r) * F + f0 + h0 + c] = activate(v + b1s[h0 + c], act);
      }
    });
  }
  mark(2, 5);
  cluster_wait();  // no block leaves while another still reads its shared memory
}

// ---- grid 4: out = LN2(y + h W2^T + b2), one cluster per 16 rows -----------------
// Block `rank` multiplies its hidden columns of h by the same columns of W2
// (all D rows); the partials are summed over the cluster in rank order for
// the rows it normalises, 2 rank and 2 rank + 1.
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
encoder_layer_ff2_ln2(const float* __restrict__ hid, const float* __restrict__ y,
                      const float* __restrict__ w2, const float* __restrict__ b2,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      float* __restrict__ out, int M, int D, int F, float eps, int stages) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5;
  const int m0 = (blockIdx.x / kCluster) * kRows;
  const int fb = slice(F), f0 = rank * fb, nf = max(0, min(fb, F - f0));
  const int sy = kstride(D), sh = kstride(fb);
  float* hs = smem;                   // [16][sh]  h, this block's hidden columns
  float* ps = hs + kRows * sh;        // [16][sy]  this block's partial h W2^T
  float* yr = ps + kRows * sy;        // [2][D]    y, the rows this block normalises
  float* pv = yr + kRowsPerBlock * D; // [3][D]    b2, gamma, beta
  float* red = pv + 3 * D;            // k-group partials
  float* wbuf = red + kRedFloats;     // the weight chunks
  const Series w{w2 + f0, F, D, nf};  // this block's W2 columns, all rows
  Stream st(w, w, 1, wbuf, stages);
  mark(3, 0);
  issue_vec(pv, b2, D);
  issue_vec(pv + D, gamma, D);
  issue_vec(pv + 2 * D, beta, D);
  st.prefetch();
  grid_dependency_wait();
  mark(3, 1);
  launch_dependents();
  issue_rows(hs, sh, hid + f0, F, m0, M, kRows, nf, round_up(nf, kKc));
  issue_rows(yr, D, y, D, m0 + rank * kRowsPerBlock, M, kRowsPerBlock, D, D);
  cp_async_wait_all();
  mark(3, 2);
  int g = 0;
  for (int i = 0; i < w.panels(); ++i) {
    const Panel p = w.panel(i);
    const Split sp(p.ntiles(), kKc / 16);
    float acc[kNtMax][4] = {};
    panel_mma<BF16>(acc, sp, hs, sh, st, g, p);
    g += p.chunks();
    if (reduce_k(acc, sp, red)) {
      const int n0 = i * kPanelRows;
      for_each_acc(acc, sp, [&](int r, int c, float v) {
        if (c < p.rows) ps[r * sy + n0 + c] = v;
      });
    }
  }
  cluster.sync();  // every block's partial is complete
  mark(3, 3);
  if (warp < kRowsPerBlock && m0 + rank * kRowsPerBlock + warp < M) {
    const int r = rank * kRowsPerBlock + warp;
    warp_layernorm(
        [&](int c) {
          float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int q = 0; q < kCluster; ++q) {
            const float4 part = ld4(cluster.map_shared_rank(ps, q) + r * sy + c);
            s.x += part.x;
            s.y += part.y;
            s.z += part.z;
            s.w += part.w;
          }
          const float4 bias = ld4(pv + c), res = ld4(yr + warp * D + c);
          return make_float4(s.x + bias.x + res.x, s.y + bias.y + res.y, s.z + bias.z + res.z,
                             s.w + bias.w + res.w);
        },
        [&](int c, float4 v) {
          *reinterpret_cast<float4*>(out + static_cast<size_t>(m0 + r) * D + c) = v;
        },
        pv + D, pv + 2 * D, D, eps);
  }
  cluster_arrive();  // done with the other blocks' shared memory
  mark(3, 4);
  cluster_wait();    // no block leaves while another still reads its shared memory
}

// ---- host side ----------------------------------------------------------------------

// Floats of one chunk of a series of `rows` weight rows (as Series::chunk_floats).
int chunk_floats(int rows) { return round_up(std::min(rows, kPanelRows), 8) * kStageStride; }
int series_chunks(int rows, int k) {
  return (rows + kPanelRows - 1) / kPanelRows * ((k + kKc - 1) / kKc);
}

// Shared memory of a grid: `fixed` floats besides its weights, whose chunks
// are n0 of f0 floats then n1 of f1. Picks the weights' layout: every chunk in
// a place of its own (stages 0) when that fits, else the deepest ring of
// 2..kMaxStages stages that fits; stages -1 when none does.
struct Smem {
  int stages;
  size_t bytes;
  Smem(size_t fixed, int n0, int f0, int n1, int f1) {
    bytes = sizeof(float) * (fixed + static_cast<size_t>(n0) * f0 + static_cast<size_t>(n1) * f1);
    stages = 0;
    if (bytes <= kSmemLimit) return;
    for (stages = kMaxStages; stages >= 2; --stages) {
      bytes = sizeof(float) * (fixed + static_cast<size_t>(stages) * std::max(f0, f1));
      if (bytes <= kSmemLimit) return;
    }
    stages = -1;
  }
};

Smem qkv_smem(int D) {
  const int n = series_chunks(kQkvCols, D), f = chunk_floats(kQkvCols);
  return Smem(kRows * kstride(D) + kQkvCols + kRedFloats, n, f, 0, 0);
}
size_t attention_smem(int T, int D, int H) {
  const int hd = D / H, tk = round_up(T, 16);
  return sizeof(float) *
         ((kRows + tk) * kstride(hd) + tk * vstride(hd) + kRows * kstride(T));
}
size_t attention_tiled_smem(int kt, int D, int H) {
  const int hd = D / H;
  return sizeof(float) * ((kRows + kt) * kstride(hd) + kt * vstride(hd) + kRows * kstride(kt) +
                          kRows * round_up(hd, 8) + 3 * kRows);
}

// The attention grid's key tile: 0 for the whole-row grid where one head's
// keys and values fit in shared memory whole, else the keys per tile of the
// key-tiled grid (the most of kKeyTiles that fits); -1 when neither fits.
constexpr int kKeyTiles[] = {64, 32, 16};
int key_tile(int T, int D, int H) {
  if (attention_smem(T, D, H) <= kSmemLimit) return 0;
  for (int kt : kKeyTiles) {
    if (attention_tiled_smem(kt, D, H) <= kSmemLimit) return kt;
  }
  return -1;
}
size_t attention_grid_smem(int T, int D, int H) {
  const int kt = key_tile(T, D, H);
  if (kt < 0) return kSmemLimit + 1;
  return kt ? attention_tiled_smem(kt, D, H) : attention_smem(T, D, H);
}
Smem out_ff1_smem(int D, int F) {
  const int db = slice(D), fb = slice(F);
  return Smem(kRows * kstride(D) + (kRows + 1) * db + 2 * D + fb, series_chunks(db, D),
              chunk_floats(db), series_chunks(fb, D), chunk_floats(fb));
}
Smem ff2_ln2_smem(int D, int F) {
  const int fb = slice(F);
  return Smem(kRows * kstride(fb) + kRows * kstride(D) + kRowsPerBlock * D + 3 * D + kRedFloats,
              series_chunks(D, fb), chunk_floats(D), 0, 0);
}

// One layer's arguments, as dsg_encoder_layer takes them.
struct LayerArgs {
  const float *x, *w_in, *b_in, *w_out, *b_out, *ln1_w, *ln1_b, *w1, *b1, *w2, *b2, *ln2_w, *ln2_b;
  float *work, *out;
  int B, T, D, H, F, act;
  float scale, eps;
};

// Raises `Kernel`'s dynamic shared-memory limit to kSmemLimit on the current
// device, once per device: the attribute belongs to a device, so a process that
// launches on a second card opts in there too (at the ZEGGS shapes all four
// grids need more than the default 48 KB: 115,968 / 71,168 / 226,944 / 211,968
// bytes). A failed opt-in is not recorded, and its error goes back to the
// wrapper, which raises.
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

// Launches `Kernel` with Programmatic Dependent Launch (and a cluster of
// kCluster blocks along x when `cluster`) on `stream`. The kernel's dynamic
// shared-memory limit is raised first, once per device.
template <auto Kernel, typename... Args>
cudaError_t launch(dim3 grid, size_t smem, bool cluster, cudaStream_t stream, Args... args) {
  const cudaError_t allowed = allow_smem<Kernel>();
  if (allowed != cudaSuccess) return allowed;
  if (smem > kSmemLimit) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = kCluster;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = cluster ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, Kernel, args...);
}

// Launches grid `which` (1..4) of the layer; the layer is the four in order.
template <bool BF16>
cudaError_t launch_grid(int which, const LayerArgs& a, cudaStream_t stream) {
  const int M = a.B * a.T, D = a.D, F = a.F, mtiles = (M + kRows - 1) / kRows;
  float* qkv = a.work;
  float* attn = qkv + static_cast<size_t>(M) * 3 * D;
  float* y = attn + static_cast<size_t>(M) * D;
  float* hid = y + static_cast<size_t>(M) * D;
  switch (which) {
    case 1: {
      const Smem s = qkv_smem(D);
      if (s.stages < 0) return cudaErrorInvalidConfiguration;
      return launch<encoder_layer_qkv<BF16>>(dim3((3 * D + kQkvCols - 1) / kQkvCols, mtiles),
                                             s.bytes, false, stream, a.x, a.w_in, a.b_in, qkv, M,
                                             D, s.stages);
    }
    case 2: {
      const int kt = key_tile(a.T, D, a.H);
      const dim3 grid(a.B * a.H, (a.T + kRows - 1) / kRows);
      if (kt < 0) return cudaErrorInvalidConfiguration;
      if (kt) {
        return launch<encoder_layer_attention_tiled<BF16>>(
            grid, attention_tiled_smem(kt, D, a.H), false, stream, static_cast<const float*>(qkv),
            attn, a.T, D, a.H, a.scale, kt);
      }
      return launch<encoder_layer_attention<BF16>>(grid, attention_smem(a.T, D, a.H), false,
                                                   stream, static_cast<const float*>(qkv), attn,
                                                   a.T, D, a.H, a.scale);
    }
    case 3: {
      const Smem s = out_ff1_smem(D, F);
      if (s.stages < 0) return cudaErrorInvalidConfiguration;
      return launch<encoder_layer_out_ff1<BF16>>(
          dim3(kCluster * mtiles), s.bytes, true, stream, static_cast<const float*>(attn),
          a.w_out, a.b_out, a.x, a.ln1_w, a.ln1_b, a.w1, a.b1, y, hid, M, D, F, a.act, a.eps,
          s.stages);
    }
    case 4: {
      const Smem s = ff2_ln2_smem(D, F);
      if (s.stages < 0) return cudaErrorInvalidConfiguration;
      return launch<encoder_layer_ff2_ln2<BF16>>(
          dim3(kCluster * mtiles), s.bytes, true, stream, static_cast<const float*>(hid),
          static_cast<const float*>(y), a.w2, a.b2, a.ln2_w, a.ln2_b, a.out, M, D, F, a.eps,
          s.stages);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

// Checks the arguments, then launches grid `which` (1..4), or all four when 0.
cudaError_t run(int which, bool bf16, const LayerArgs& a, cudaStream_t stream) {
  // the 16-byte copies and stores need 16-byte aligned rows and vectors
  const void* ptrs[] = {a.x,  a.w_in, a.b_in, a.w_out, a.b_out, a.ln1_w, a.ln1_b, a.w1,
                        a.b1, a.w2,   a.b2,   a.ln2_w, a.ln2_b, a.work,  a.out};
  for (const void* p : ptrs) {
    if (reinterpret_cast<size_t>(p) % 16) return cudaErrorMisalignedAddress;
  }
  if (a.B < 1 || a.T < 1 || a.D % a.H || (a.D / a.H) % 4 || a.D % 4 || a.F % 4 ||
      a.D > kMaxWidth || which < 0 || which > 4) {
    return cudaErrorInvalidValue;
  }
  for (int g = which ? which : 1; g <= (which ? which : 4); ++g) {
    const cudaError_t e = bf16 ? launch_grid<true>(g, a, stream) : launch_grid<false>(g, a, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// The largest dynamic shared memory (bytes) one of the layer's four grids
// needs; above 227 KB (no layout fits) the layer cannot run.
extern "C" size_t dsg_encoder_layer_smem_bytes(int T, int D, int H, int F) {
  const Smem s[] = {qkv_smem(D), out_ff1_smem(D, F), ff2_ln2_smem(D, F)};
  size_t most = attention_grid_smem(T, D, H);
  for (const Smem& g : s) most = std::max(most, g.stages < 0 ? kSmemLimit + 1 : g.bytes);
  return most;
}

// Keys per tile of the attention grid the layer takes at this shape: 0 for the
// whole-row grid, -1 when none fits.
extern "C" int dsg_encoder_layer_key_tile(int T, int D, int H) { return key_tile(T, D, H); }

// Floats of device workspace one layer needs: qkv, the attention output, y and h.
extern "C" size_t dsg_encoder_layer_workspace_floats(int B, int T, int D, int F) {
  return static_cast<size_t>(B) * T * (5 * D + F);
}

// x, out: (B, T, D) float32, D <= 1024. Weights in nn.Linear (out, in) layout,
// float32. act: 0 none, 1 erf GELU, 2 tanh GELU, 3 ReLU. bf16: 0 for the f32
// (3xTF32) mode, 1 for the mxu_bf16 mode. `work` holds
// dsg_encoder_layer_workspace_floats(B, T, D, F) floats. `which` is 0 for the
// whole layer (four grids, in order), or 1..4 for that grid alone, for timing.
// Returns the first CUDA error of the launches (0 on success).
extern "C" int dsg_encoder_layer(int which, const float* x, const float* w_in, const float* b_in,
                                 const float* w_out, const float* b_out, const float* ln1_w,
                                 const float* ln1_b, const float* w1, const float* b1,
                                 const float* w2, const float* b2, const float* ln2_w,
                                 const float* ln2_b, float* work, float* out, int B, int T,
                                 int D, int H, int F, int act, int bf16, float attn_scale,
                                 float eps, cudaStream_t stream) {
  const LayerArgs a{x,  w_in, b_in, w_out, b_out, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b,
                    work, out, B, T, D, H, F, act, attn_scale, eps};
  return static_cast<int>(run(which, bf16 != 0, a, stream));
}

// Copies the phase marks of the last run into `out` (kPhaseGrids x
// kPhaseBlocks x kPhaseMarks x {global timer ns, SM cycles}); returns the
// number of values copied, 0 when the library was built without DSG_PHASES.
extern "C" int dsg_encoder_layer_phases(unsigned long long* out) {
#ifdef DSG_PHASES
  if (cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases)) != cudaSuccess) return 0;
  return static_cast<int>(sizeof(g_phases) / sizeof(unsigned long long));
#else
  (void)out;
  return 0;
#endif
}
