// One post-norm transformer encoder layer (torch 1.9 nn.TransformerEncoderLayer,
// inference) for Hopper (sm_90a): every product on wgmma, every operand tile
// brought into shared memory by TMA on mbarriers, seven grids a layer.
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
// taken as torch stores them, nn.Linear (out, in), f32, with no per-call copy;
// in f32 mode a GEMM grid may read them from weight planes instead (below).
// Head dims up to 256.
//
// Operand modes. f32 (the main path): 3xTF32 on wgmma.mma_async m64nNk8.tf32.
// Each operand is split into big (its top 19 bits, a tf32 value) and small =
// v - big (exact in f32), and the products small*big, big*small, then big*big
// go into one f32 accumulator, as CUTLASS's 3xTF32 does; this keeps the layer
// within 1e-4 of a float32 layer. Where each part is split: the GEMM grids'
// activation operand (A) in registers (each warpgroup reads its fragments
// from the raw f32 tile TMA landed and issues wgmma with A from registers);
// their weight operand (W) either from weight planes, big and small copies of
// each weight matrix that dsg_encoder_layer_split makes once per weight
// version (the wrapper keeps them), TMA-loaded into the stage as they are, or
// in shared memory, each tile split in place as it lands (big written over
// it, small beside it); the plan picks per grid. The attention grid splits Q
// and K tiles in shared memory, and P in registers. bf16 (`mxu_bf16`, the
// Pallas kernel's `mxu_bf16=True`): m64nNk16.bf16 with exactly the operands
// the Pallas kernel rounds rounded to bf16 (x, Win, q, k, the softmax
// probabilities, v, the attention output, Wout, y, W1, the activated hidden
// rows, W2) and f32 sums; the tiles are rounded in shared memory after they
// land.
//
// What bounds it on an H100 (SXM, 132 SMs; 495 TFLOP/s TF32, 989 bf16, 3.35
// TB/s): one layer at the ZEGGS shape (B*T = 89 rows, D = 256, H = 4, F = 1024)
// is 148 MFLOP against 3.3 MB of f32 weights and activations: at B = 1 the
// bytes bound it (1.0 us against 0.9 us for the three TF32 products); at
// B >= 16 the operations do (14.4 us at B = 16, 0.27 ms at B = 300, 3xTF32).
// What the design does about each:
//   * B >= 16, operations: wgmma at the tensor cores' own rate (the earlier
//     mma.sync 3xTF32 design ran at a quarter of it); row tiles of 64 or 128
//     rows that span batch elements, so each weight tile is read from L2 once
//     per 64-128 rows (the earlier design read the layer's whole 3.15 MB
//     weight set once per 16 rows: 5.3 GB of L2 traffic a layer at B = 300);
//     a ring of TMA stages fed by one producer warp while the tensor cores run
//     the previous stage; and tiles, K splits and stages chosen so that a
//     grid's blocks sit on the SMs at once (two or three a SM) rather than in
//     a second wave. Shared-memory traffic bounded the GEMM grids when both
//     operands were split in shared memory (a stage of 64 x 64 tiles moved
//     ~112 KB: TMA's writes, the split's read and two writes of each tile, and
//     the three products' operand reads, against 384 tensor-core cycles). Now
//     the activation is split in registers (its tile read once) and, where
//     many row tiles read each weight tile, the weight comes split from its
//     planes: ~56 KB a stage, for twice the weight bytes from L2.
//   * B = 1, bytes and latency: 89 rows are two 64-row tiles, so every GEMM
//     grid splits K over a cluster (4 blocks, 8 for FF2's K = 1024 and the
//     out-proj at D >= 512) to spread over 32-128 SMs; the two LayerNorms run
//     in grids of their own (a cluster that holds whole rows for the norm has
//     at most 8 blocks a row tile: 16 SMs at B = 1, where FF2 took 15.5 us
//     against 8.3 us now for its GEMM and LayerNorm grids); each grid issues
//     its weight tiles, and splits them in shared memory (no planes: their
//     extra bytes would cost more than two row tiles' splits), before
//     griddepcontrol.wait, so under programmatic dependent launch that work
//     overlaps the previous grid; split partials are pushed into their owner's
//     shared memory (no round trip through device memory).
//
// Design (seven grids in five steps, each grid launched with cudaLaunchKernelEx
// and programmatic dependent launch; the host picks each step's tiles from the
// shape and the card's SM count, see ops/encoder_layer.py::plan, and grid_smem
// below checks the plan):
//   1. QKV      qkv = x Win^T + bin: BM x BN tiles of (M, 3D), BM = 64 or 128
//               rows (1 or 2 consumer warpgroups), BN = 64 or 128 columns (one
//               wgmma n64 / n128 a k-step), K split over a cluster of 1-4.
//   2. attn     one block per (batch, head, 64 queries): Q (64 x hd) stays in
//               shared memory; K and V stream in tiles of 64 / 32 / 16 keys
//               (head dim <= 64 / 128 / 256) through TMA buffers that are
//               released as soon as a tile is converted (K split, V transposed
//               to the K-major layout wgmma's .tf32 needs), so the next tile
//               loads while this one's products run. Where the grid fills at
//               most half the SMs (B = 1), two consumer warpgroups take
//               alternate tiles, each with its own buffers, running max, sum
//               and O, merged at the end. S = Q K^T on wgmma (both
//               operands in shared memory), an online softmax in registers,
//               O += P V on wgmma with P taken from registers (in tf32 the keys
//               of V^T are permuted within each group of 8 so that the score
//               accumulator's layout is the A fragment's).
//   3. out, LN1 s = a Wout^T + bout as grid 1 (N = D, K split over 1-8), into
//               qkv's place in the workspace; then y = LN1(x + s), one warp a
//               row (encoder_layer_norm).
//   4. FF1      h = act(y W1^T + b1), as grid 1.
//   5. FF2, LN2 s = h W2^T + b2 as step 3 (K = F), then out = LN2(y + s).
//   Operand tiles: rows of 32 f32 (128 bytes) in TMA's 128-byte swizzle, the
//   layout wgmma reads K-major (and whose chunks spread a warp's A-fragment
//   reads over all banks); bf16 copies in the 64-byte swizzle. A GEMM stage
//   in f32 holds raw A, big W and small W (24 KB at 64 x 64), the same on
//   weight planes and off them. TMA
//   descriptors come from cuTensorMapEncodeTiled (reached through
//   cudaGetDriverEntryPoint, no link against libcuda), cached by their fields
//   and passed as __grid_constant__ parameters, so graph capture records them.
//   No atomics and no split-K partial through device memory: every sum runs
//   in a fixed order, so two calls on the same input give bitwise-equal
//   output. Nothing is allocated here: the wrapper's workspace holds qkv (and
//   later the pre-norm sums), a, y and h. A failed launch returns its error;
//   the wrapper raises.
//
// Two Hopper features the design does without. setmaxnreg: a block holds at
// most 288 threads, so every thread may use 224 registers; the GEMM grids use
// 128 and the attention grid 160-184 (ptxas, as scripts/encoder_layer_timing.py
// prints them), with no spills, so there is nothing for the producer warp to
// hand over. TMA multicast: a cluster splits K, so its blocks read different
// weight tiles and different A tiles (the same rows, other k); no two blocks
// of a cluster load the same tile.
//
// Times a layer on an NVIDIA H100 80GB HBM3 at 700 W (scripts/encoder_layer_timing.py,
// this source and, in the same call, the one before weight planes and the
// register split of A; PERF.md's kernel table), f32 / bf16: (1, 89, 256) 0.0322
// / 0.0295 ms (before: 0.0339 / 0.0293); (1, 151, 384) 0.0476 / 0.0420 (0.0486 /
// 0.0418); (1, 151, 512) 0.0558 / 0.0459 (0.0595 / 0.0462); (16, 89, 256)
// 0.0667 / 0.0658 (0.0863 / 0.0680); (300, 89, 256) 0.905 / 0.789 (1.018 /
// 0.796).
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <map>
#include <mutex>
#include <utility>

namespace cg = cooperative_groups;

namespace {

enum Activation { kNone = 0, kGeluErf = 1, kGeluTanh = 2, kRelu = 3 };

constexpr int kSteps = 5;           // QKV, attention, out-proj + LN1, FF1, FF2 + LN2
constexpr int kKc = 32;             // k values of one stage: one 128-byte row of f32
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kMaxWidth = 1024;     // D
constexpr int kMaxHeadDim = 256;
constexpr int kQueries = 64;        // query rows of an attention block (one wgmma m-tile)
constexpr size_t kSmemLimit = 227 * 1024;
constexpr size_t kReserve = 1024 + 256;  // alignment slack and the mbarriers
constexpr int kPlanInts = 7;        // per step: nc, nb, ck, stages, key tile, overlay, planes
constexpr int kMaxStages = 10;      // three mbarriers a stage in the 256 reserved bytes

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// ---- PTX: barriers, TMA, dependent launch --------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// The dynamic shared memory from its first 1024-byte boundary (the swizzle atoms
// of TMA and wgmma repeat every 1024 bytes of address).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival, and `bytes` more to land by TMA before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// Waits until the phase of the given parity has completed. Every wait follows
// griddepcontrol.wait, so it waits on this block's own copies and products
// only; one that lasts seconds is a fault, and traps (the launch then fails
// with an error the wrapper raises) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  unsigned long long start = 0;
  for (uint32_t n = 1;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 0xffff) == 0) {  // the clock is read only once a wait is long
      const unsigned long long now = global_ns();
      if (start == 0) start = now;
      else if (now - start > 4000000000ull) __trap();
    }
  }
}
// Fetches a TMA descriptor ahead of its first use.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// A contiguous copy of `bytes` (a multiple of 16) bytes into shared memory, on a barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Generic-proxy writes to shared memory become visible to wgmma and TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier 1 among the consumer warpgroups only.
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}
// Named barrier `id` among `threads` threads (whole warps).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// Wait until the grids this one depends on have completed and their writes are visible.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
// Let the next grid on the stream launch (its pre-wait prologue) now.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// The shared::cluster address of shared-memory address `addr` in cluster block `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// Two floats into another block's shared memory (distributed shared memory).
__device__ __forceinline__ void st_cluster2(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b)
               : "memory");
}
// The two halves of a cluster barrier: arrive (releasing this block's shared
// memory writes and reads) and wait (acquiring the other blocks').
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Phase marks, compiled in only with -DDSG_PHASES (scripts/encoder_layer_timing.py
// --phases): thread 0 of each block records the global timer and its SM's
// cycle counter at mark i of grid g; dsg_encoder_layer_phases copies them out.
#ifdef DSG_PHASES
constexpr int kPhaseBlocks = 256, kPhaseMarks = 8;
__device__ unsigned long long g_phases[kSteps][kPhaseBlocks][kPhaseMarks][2];
__device__ __forceinline__ void mark(int g, int i) {
  const int b = blockIdx.x + gridDim.x * blockIdx.y;
  if (threadIdx.x == 0 && b < kPhaseBlocks) {
    g_phases[g][b][i][0] = global_ns();
    g_phases[g][b][i][1] = clock64();
  }
}
#else
__device__ __forceinline__ void mark(int, int) {}
#endif

// ---- wgmma --------------------------------------------------------------------------
// A and B K-major in shared memory (ss) or A in registers (rs); D += A B^T in f32.

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers across
// the asynchronous products.
// Pinning them before wgmma.fence and after wgmma.wait_group also keeps ptxas
// from finding other instructions writing them inside a batch, which makes it
// serialise the products (C7515).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Descriptor of a K-major operand tile in shared memory: rows of W bytes (128,
// 64 or 32) in the swizzle of that width, atoms of 8 rows (8 W bytes) stacked
// along M / N. `addr` is the tile's row 0 plus the k-step's byte offset in the row.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int W) {
  const uint64_t layout = W == 128 ? 1 : W == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * W) >> 4) << 32) | (layout << 62);
}
// Byte offset of byte `byte` of row `row` in a tile of W-byte swizzled rows
// (16-byte chunk c of row r sits at chunk c ^ (address bits 7.. of the row)).
__device__ __forceinline__ int swz(int W, int row, int byte) {
  return row * W + ((((byte >> 4) ^ ((row * W) >> 7)) & (W / 16 - 1)) << 4) + (byte & 15);
}
__device__ __forceinline__ void wgmma_ss_tf32_n16(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_tf32_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_tf32_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_tf32_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tf32_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tf32_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs_tf32_n64(d, a, b);
  else wgmma_rs_tf32_n128(d, a, b);
}

__device__ __forceinline__ void wgmma_ss_bf16_n16(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_bf16_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_bf16_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_bf16_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_bf16_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <bool BF16, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (BF16) {
    if constexpr (N == 16) wgmma_ss_bf16_n16(d, a, b);
    else if constexpr (N == 32) wgmma_ss_bf16_n32(d, a, b);
    else if constexpr (N == 64) wgmma_ss_bf16_n64(d, a, b);
    else wgmma_ss_bf16_n128(d, a, b);
  } else {
    if constexpr (N == 16) wgmma_ss_tf32_n16(d, a, b);
    else if constexpr (N == 32) wgmma_ss_tf32_n32(d, a, b);
    else if constexpr (N == 64) wgmma_ss_tf32_n64(d, a, b);
    else wgmma_ss_tf32_n128(d, a, b);
  }
}

// ---- conversions in shared memory -------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}
// 3xTF32 split: big keeps the top 19 bits (a tf32 value); small = v - big is exact.
__device__ __forceinline__ float tf32_big(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xffffe000u);
}
__device__ __forceinline__ float4 big4(float4 v) {
  return make_float4(tf32_big(v.x), tf32_big(v.y), tf32_big(v.z), tf32_big(v.w));
}
__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}
// float4 i in [begin, end) (step `step`) of `src`: big to `hi`, small to `lo`,
// at the same offsets (hi may be src: the split in place).
__device__ __forceinline__ void split_tf32(const float4* src, float4* hi, float4* lo, int begin,
                                           int end, int step) {
  for (int i = begin; i < end; i += step) {
    const float4 v = src[i], b = big4(v);
    hi[i] = b;
    lo[i] = sub4(v, b);
  }
}
// 16-byte chunk i in [begin, end) of a tile of 128-byte rows of f32 (TMA's
// 128-byte swizzle; row i / 8) to bf16 at the same row of a tile of 64-byte rows
// (64-byte swizzle). Any row count that is a multiple of 8 keeps the swizzle
// phases of both, so a run of tiles converts as one.
__device__ __forceinline__ void to_bf16(const uint8_t* src, uint8_t* dst, int begin, int end,
                                        int step) {
  for (int i = begin; i < end; i += step) {
    const int r = i >> 3, c = (i & 7) ^ (r & 7);  // c: the chunk's place in the row (4 values)
    const float4 v = *reinterpret_cast<const float4*>(src + 16 * i);
    *reinterpret_cast<uint2*>(dst + swz(64, r, 8 * c)) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// ---- the GEMM grids (1, 3, 4 and 5) ---------------------------------------------------
// A block of NC consumer warpgroups (BM = 64 NC rows) and one producer warp
// computes BM x BN (BN = 64 NB) of A W^T over a range of K, 32 k a stage.
// Stage layout: raw A [BM][32] f32 and W [BN][32] f32 (TMA, 128-byte swizzle),
// then the converted operands. f32 mode: small W [BN][32] (A is split in
// registers, see a_fragments); on weight planes TMA brings the big plane into
// W's place and the small plane into small W's, otherwise the consumers split
// the raw W tile there (big written over it). bf16 mode: A, W in bf16
// (64-byte swizzle).
template <bool BF16, int NC, int NB>
struct Gemm {
  static constexpr int BM = 64 * NC, BN = 64 * NB;
  static constexpr int kConsumers = 128 * NC, kThreads = kConsumers + 32;
  static constexpr int kRawA = BM * 128, kRawB = BN * 128;
  static constexpr int kOpA = BF16 ? BM * 64 : 0, kOpB = BF16 ? BN * 64 : kRawB;
  static constexpr int kStage = kRawA + kRawB + kOpA + kOpB;
};

// The consumer threads (tid < kConsumers) convert the W tile of stage `st`
// (all of them) or, in bf16 mode, its A tile (each warpgroup its own 64 rows).
template <bool BF16, int NC, int NB>
__device__ __forceinline__ void convert_w(uint8_t* st, int tid) {
  using G = Gemm<BF16, NC, NB>;
  uint8_t* raw = st + G::kRawA;
  uint8_t* op = st + G::kRawA + G::kRawB + G::kOpA;
  if constexpr (BF16) {
    to_bf16(raw, op, tid, 8 * G::BN, G::kConsumers);
  } else {
    split_tf32(reinterpret_cast<float4*>(raw), reinterpret_cast<float4*>(raw),
               reinterpret_cast<float4*>(op), tid, 8 * G::BN, G::kConsumers);
  }
}
template <int NC, int NB>
__device__ __forceinline__ void convert_a_bf16(uint8_t* st, int tid) {
  using G = Gemm<true, NC, NB>;
  const int wg = tid >> 7, lt = tid & 127;
  to_bf16(st, st + G::kRawA + G::kRawB, wg * 512 + lt, wg * 512 + 512, 128);
}

// Warpgroup wg's bf16 products of one stage into acc (64 x BN).
template <int NC, int NB>
__device__ __forceinline__ void stage_products_bf16(float (&acc)[NB * 32], uint32_t st, int wg) {
  using G = Gemm<true, NC, NB>;
  const uint32_t op = st + G::kRawA + G::kRawB;
  const uint32_t a = op + wg * 4096, b = op + G::kOpA;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    wgmma_ss<true, G::BN>(acc, smem_desc(a + 32 * kk, 64), smem_desc(b + 32 * kk, 64));
  }
}

// A thread's A fragments of k-steps 2h and 2h + 1 (8 k each) of a stage, split
// for 3xTF32: fragment e of k-step kk is row r (+ 8 for e = 1, 3) and column
// 8 kk + q (+ 4 for e = 2, 3) of the raw f32 tile, r = 16 warp + g of the
// warpgroup's 64 rows (`row` points at row r of the tile). A warp's 32 loads of
// one fragment fall on 8 rows x 4 columns whose 16-byte chunks the 128-byte
// swizzle spreads over all 32 banks.
template <int H>
__device__ __forceinline__ void a_fragments(const uint8_t* row, int g, int q,
                                            uint32_t (&hi)[2][4], uint32_t (&lo)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kk = 2 * H + j;
    const int c0 = (((2 * kk) ^ g) << 4) + 4 * q, c1 = (((2 * kk + 1) ^ g) << 4) + 4 * q;
    const float v[4] = {*reinterpret_cast<const float*>(row + c0),
                        *reinterpret_cast<const float*>(row + 1024 + c0),
                        *reinterpret_cast<const float*>(row + c1),
                        *reinterpret_cast<const float*>(row + 1024 + c1)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float b = tf32_big(v[e]);
      hi[j][e] = __float_as_uint(b);
      lo[j][e] = __float_as_uint(v[e] - b);
    }
    fence_regs(hi[j]);
    fence_regs(lo[j]);
  }
}

// Warpgroup products of k-steps 2h and 2h + 1 of a stage, A from registers,
// big and small W at `whi` / `wlo`: small*big, big*small, big*big into acc.
template <int NB, int H>
__device__ __forceinline__ void half_products(float (&acc)[NB * 32], const uint32_t (&hi)[2][4],
                                              const uint32_t (&lo)[2][4], uint32_t whi,
                                              uint32_t wlo) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t o = 32 * (2 * H + j);
    wgmma_rs_tf32<64 * NB>(acc, lo[j], smem_desc(whi + o, 128));
    wgmma_rs_tf32<64 * NB>(acc, hi[j], smem_desc(wlo + o, 128));
    wgmma_rs_tf32<64 * NB>(acc, hi[j], smem_desc(whi + o, 128));
  }
  wgmma_commit();
}

// The W operand of a stage at (k, n0): the raw tile, or on weight planes the
// big and the small plane's tiles, on one barrier.
template <typename G>
__device__ __forceinline__ void load_w(uint8_t* st, const CUtensorMap* wmap,
                                       const CUtensorMap* smap, uint64_t* bar, int k, int n0,
                                       int planes) {
  mbar_expect_tx(bar, planes ? 2 * G::kRawB : G::kRawB);
  tma_load_2d(st + G::kRawA, wmap, bar, k, n0);
  if (planes) tma_load_2d(st + G::kRawA + G::kRawB, smap, bar, k, n0);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ---- the GEMM grids: out = act(A W^T + bias) ----------------------------------------------
// QKV and FF1 (act: none, or the layer's), and the products of out-proj and FF2
// (none), whose LayerNorm runs in the next grid. A cluster of ck blocks per
// BM-row tile (grid x) and BN-column tile (grid y): block `rank` computes the
// tile over K in [rank kl, rank kl + kl). With one block a cluster the epilogue
// works from the accumulators. Otherwise block `rank` owns rows [rank per,
// rank per + per) of the tile: every block stores its partial of those rows
// straight into the owner's receive buffer (distributed shared memory,
// [ck][per][BN + 4]; beside the stage ring, or over it behind one more cluster
// barrier where that lets more blocks share an SM, as the plan says); after
// one cluster barrier each owner sums the ck partials of its rows in rank order
// from its own shared memory and adds bias and activation.
//
// Pipeline: the producer warp's first thread issues the W (weight) tiles of
// the first `stages` stages (on weight planes, `planes`: the big and the small
// plane's tiles), then waits for the grids before (griddepcontrol.wait) and
// issues the A tiles, then refills each stage as the consumers release it.
// Without planes the consumers split (f32) or round (bf16) the weight tiles of
// those stages before they wait for the grids before (so at B = 1 that work
// overlaps the previous grid), and each later stage's W tile as it lands.
// Then for each stage, f32: each warpgroup reads its A fragments from the raw
// tile, splits them in registers and issues the stage's products in two
// halves of two k-steps, each half while the one before is still in flight
// (wgmma.wait_group 1), from two sets of fragment registers; bf16: the
// consumers round the A tile in shared memory and issue the stage's products
// while the previous stage's are in flight. A stage is released once its
// products are done.
// (64-row tiles: registers for three blocks a SM, as many as the plan puts there)
template <bool BF16, int NC, int NB>
__global__ void __launch_bounds__(Gemm<BF16, NC, NB>::kThreads, NC == 1 ? 3 : 1)
encoder_layer_gemm(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap smap, const float* __restrict__ bias,
                   float* __restrict__ out, int M, int N, int K, int kl, int act, int stages,
                   int overlay, int planes, int grid) {
  using G = Gemm<BF16, NC, NB>;
  extern __shared__ uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int m0 = (blockIdx.x / csize) * G::BM;
  const int n0 = blockIdx.y * G::BN, k0 = rank * kl;
  const int nk = max(0, cdiv(min(K, k0 + kl) - k0, kKc)), pre = min(stages, nk);
  // the rows a block owns, and the row stride of its receive buffer (floats)
  const int per = cdiv(G::BM, csize), rs = G::BN + 4;
  uint8_t* ring = align1024(smem);
  // the receive buffer (split blocks) beside the ring or over it
  const size_t ring_bytes = static_cast<size_t>(stages) * G::kStage;
  const size_t recv_bytes = csize > 1 ? 4 * static_cast<size_t>(csize) * per * rs : 0;
  float* recv = reinterpret_cast<float*>(overlay ? ring : ring + ring_bytes);
  uint64_t* full_a = reinterpret_cast<uint64_t*>(
      ring + (overlay ? (ring_bytes > recv_bytes ? ring_bytes : recv_bytes)
                      : ring_bytes + recv_bytes));
  uint64_t* full_w = full_a + stages;
  uint64_t* empty = full_w + stages;
  mark(grid, 0);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full_a[s], 1);
      mbar_init(&full_w[s], 1);
      mbar_init(&empty[s], NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float acc[NB * 32];
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) acc[i] = 0.0f;
  fence_regs(acc);
  if (tid >= G::kConsumers) {  // the producer warp
    if (tid == G::kConsumers) {
      prefetch_map(&amap);
      for (int c = 0; c < pre; ++c) {
        load_w<G>(ring + c * G::kStage, &wmap, &smap, &full_w[c], k0 + kKc * c, n0, planes);
      }
      grid_dependency_wait();
      for (int c = 0; c < pre; ++c) {
        mbar_expect_tx(&full_a[c], G::kRawA);
        tma_load_2d(ring + c * G::kStage, &amap, &full_a[c], k0 + kKc * c, m0);
      }
      for (int c = pre; c < nk; ++c) {
        const int s = c % stages;
        uint8_t* st = ring + s * G::kStage;
        mbar_wait(&empty[s], (c / stages - 1) & 1);
        load_w<G>(st, &wmap, &smap, &full_w[s], k0 + kKc * c, n0, planes);
        mbar_expect_tx(&full_a[s], G::kRawA);
        tma_load_2d(st, &amap, &full_a[s], k0 + kKc * c, m0);
      }
    }
    __syncwarp();
  } else {
    if (!planes) {
      for (int c = 0; c < pre; ++c) {  // weights only: before the wait
        mbar_wait(&full_w[c], 0);
        convert_w<BF16, NC, NB>(ring + c * G::kStage, tid);
      }
    }
    grid_dependency_wait();  // nothing this grid writes may be read by the grids before
    launch_dependents();
    mark(grid, 1);
    const int wg = tid >> 7, lt = tid & 127;
    if constexpr (BF16) {
      for (int c = 0; c < nk; ++c) {
        const int s = c % stages;
        uint8_t* st = ring + s * G::kStage;
        if (c >= pre) {
          mbar_wait(&full_w[s], (c / stages) & 1);
          convert_w<BF16, NC, NB>(st, tid);
        }
        mbar_wait(&full_a[s], (c / stages) & 1);
        __syncwarp();
        if (c == 0) mark(grid, 2);
        convert_a_bf16<NC, NB>(st, tid);
        fence_proxy_async();
        consumer_sync(G::kConsumers);
        fence_regs(acc);
        wgmma_fence();
        stage_products_bf16<NC, NB>(acc, smem_u32(st), wg);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_regs(acc);
        if (c > 0 && lt == 0) mbar_arrive(&empty[(c - 1) % stages]);
      }
    } else {
      const int lane = tid & 31, g = lane >> 2, q = lane & 3;
      const int r = 64 * wg + 16 * ((tid >> 5) & 3) + g;  // this thread's first A row
      uint32_t hi[2][2][4], lo[2][2][4];  // the two halves' fragments
      if (!planes) {  // the weight tiles split before the wait, for every warpgroup's products
        fence_proxy_async();
        consumer_sync(G::kConsumers);
      }
      for (int c = 0; c < nk; ++c) {
        const int s = c % stages;
        const uint32_t parity = (c / stages) & 1;
        uint8_t* st = ring + s * G::kStage;
        if (planes) {
          mbar_wait(&full_w[s], parity);
        } else if (c >= pre) {
          mbar_wait(&full_w[s], parity);
          convert_w<BF16, NC, NB>(st, tid);
          fence_proxy_async();
          consumer_sync(G::kConsumers);
        }
        mbar_wait(&full_a[s], parity);
        __syncwarp();
        if (c == 0) mark(grid, 2);
        const uint8_t* row = st + r * 128;
        const uint32_t whi = smem_u32(st) + G::kRawA, wlo = whi + G::kRawB;
        a_fragments<0>(row, g, q, hi[0], lo[0]);
        half_products<NB, 0>(acc, hi[0], lo[0], whi, wlo);
        wgmma_wait<1>();  // the previous stage's products are done
        fence_regs(acc);
        if (c > 0 && lt == 0) mbar_arrive(&empty[(c - 1) % stages]);
        a_fragments<1>(row, g, q, hi[1], lo[1]);
        half_products<NB, 1>(acc, hi[1], lo[1], whi, wlo);
        wgmma_wait<1>();  // this stage's first half is done
        fence_regs(acc);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }
  // accumulator i of a warpgroup: row 16 warp + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 q + (i & 1)
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int rbase = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + g;
  if (csize == 1) {
    if (tid >= G::kConsumers) return;
    mark(grid, 3);
#pragma unroll
    for (int i = 0; i < NB * 32; i += 2) {
      const int row = m0 + rbase + 8 * ((i >> 1) & 1), col = n0 + 8 * (i >> 2) + 2 * q;
      if (row < M && col < N) {
        const float2 v = make_float2(activate(acc[i] + bias[col], act),
                                     activate(acc[i + 1] + bias[col + 1], act));
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * N + col) = v;
      }
    }
    mark(grid, 4);
    return;
  }
  if (overlay) {  // every block of the cluster is done with its ring
    __syncwarp();
    cluster_arrive();
    cluster_wait();
  }
  if (tid < G::kConsumers) {  // this block's partial into its rows' owners
    const uint32_t dst = smem_u32(recv) + 4 * rank * per * rs;
#pragma unroll
    for (int i = 0; i < NB * 32; i += 2) {
      const int row = rbase + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * q;
      const int owner = row / per;
      st_cluster2(map_rank(dst + 4 * ((row - owner * per) * rs + col), owner), acc[i],
                  acc[i + 1]);
    }
  }
  __syncwarp();
  cluster_arrive();
  cluster_wait();  // every block's partials have landed
  mark(grid, 3);
  if (tid < G::kConsumers) {
    const int r0 = rank * per, r1 = min(G::BM, r0 + per);
    constexpr int q4 = G::BN / 4;
#pragma unroll 4
    for (int i = tid; i < (r1 - r0) * q4; i += G::kConsumers) {
      const int r = r0 + i / q4, cc = 4 * (i % q4), m = m0 + r, col = n0 + cc;
      if (m >= M || col >= N) continue;
      const float* in = recv + (r - r0) * rs + cc;
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        if (k < csize) s = add4(s, ld4(in + k * per * rs));
      }
      const float4 b = ld4(bias + col);
      *reinterpret_cast<float4*>(out + static_cast<size_t>(m) * N + col) =
          make_float4(activate(s.x + b.x, act), activate(s.y + b.y, act),
                      activate(s.z + b.z, act), activate(s.w + b.w, act));
    }
  }
  mark(grid, 4);
}

// ---- the LayerNorm grids: out = LN(resid + s) ----------------------------------------------
// After the out-proj and FF2 GEMM grids (s = A W^T + bias), one warp a row adds
// the residual and normalises, two passes over the row in registers (the mean,
// then the squared deviations); D <= 128 V. A grid of its own rather than the
// epilogue of a GEMM cluster that holds whole rows: at a few dozen rows such
// clusters (at most 8 blocks a row tile) leave most SMs idle, and at every
// shape timed this grid plus a plain GEMM grid took less.
template <int V>
__global__ void __launch_bounds__(128)
encoder_layer_norm(const float* __restrict__ s, const float* __restrict__ resid,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   float* __restrict__ out, int M, int D, float eps) {
  const int r = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  grid_dependency_wait();
  launch_dependents();
  if (r >= M) return;  // a whole warp
  const size_t base = static_cast<size_t>(r) * D;
  float4 v[V];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = 4 * lane + 128 * i;
    if (c < D) v[i] = add4(ld4(s + base + c), ld4(resid + base + c));
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (4 * lane + 128 * i < D) sum += (v[i].x + v[i].y) + (v[i].z + v[i].w);
  }
  const float mean = warp_sum(sum) / D;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (4 * lane + 128 * i < D) {
      const float a = v[i].x - mean, b = v[i].y - mean, c = v[i].z - mean, d = v[i].w - mean;
      sq += (a * a + b * b) + (c * c + d * d);
    }
  }
  const float inv = 1.0f / sqrtf(warp_sum(sq) / D + eps);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = 4 * lane + 128 * i;
    if (c < D) {
      const float4 ga = ld4(gamma + c), be = ld4(beta + c);
      *reinterpret_cast<float4*>(out + base + c) =
          make_float4((v[i].x - mean) * inv * ga.x + be.x, (v[i].y - mean) * inv * ga.y + be.y,
                      (v[i].z - mean) * inv * ga.z + be.z, (v[i].w - mean) * inv * ga.w + be.w);
    }
  }
}

// ---- grid 2: attention of one (batch, head, 64 queries) --------------------------------
// NB = ceil(head dim / 64) n64 blocks of O; keys stream in tiles of KT, tile i
// to consumer warpgroup i % NW (NW = 2 where the grid leaves most SMs idle:
// each warpgroup keeps its own running max, sum and O over half the tiles, and
// the two are merged at the end, in a fixed order). Shared memory (hc =
// ceil(hd / 32) chunks of 32 head columns): Q raw / big [hc][64][128 B] and Q
// small or bf16; then for each warpgroup nraw (1 or 2) TMA buffers of a K tile
// and a V tile [hc][KT][128 B] each, the converted K (big and small, or bf16)
// and V^T (rows = head columns, 64 NB of them; big and small, or bf16).
template <bool BF16, int NB>
struct Attn {
  static constexpr int KT = NB == 1 ? 64 : NB == 2 ? 32 : 16;  // keys a tile
  static constexpr int kElem = BF16 ? 2 : 4;
  static constexpr int kVRows = 64 * NB;
  static constexpr int kVW = KT * kElem < 128 ? KT * kElem : 128;  // bytes a V^T swizzle row
  static constexpr int kVChunk = kVRows * kVW;                     // bytes of one such column of atoms
  static constexpr int kVBytes = kVRows * KT * kElem;              // one V^T operand
};

// The k place of key j (of a tile) in the tf32 V^T: within each group of 8
// keys, key 2u at place u and key 2u + 1 at place u + 4, so that the score
// accumulator (a thread's columns 2q, 2q + 1 of each 8) is the A fragment of
// P V as it stands (a thread's k columns q and q + 4). The bf16 V^T keeps the
// keys in order: the accumulator of two n8 tiles is already the k16 A fragment.
__device__ __forceinline__ int key_place_tf32(int j) {
  return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1);
}

// V tile (KT keys x hd, raw TMA layout) -> V^T operand(s). Each thread takes
// keys j, j + 1 and head columns d .. d + 3; neighbouring lanes take
// neighbouring keys, so a warp's stores into a row of V^T spread over the banks.
template <bool BF16, int NB>
__device__ __forceinline__ void convert_vt(const uint8_t* vraw, uint8_t* vop, int hd, int tid) {
  using A = Attn<BF16, NB>;
  constexpr int KT = A::KT, W = A::kVW;
  for (int i = tid; i < (KT / 2) * (hd >> 2); i += 128) {
    const int j = 2 * (i % (KT / 2)), d = 4 * (i / (KT / 2));
    const uint8_t* chunk = vraw + (d >> 5) * KT * 128;
    const int rb = (d & 31) * 4;
    const float4 v0 = *reinterpret_cast<const float4*>(chunk + swz(128, j, rb));
    const float4 v1 = *reinterpret_cast<const float4*>(chunk + swz(128, j + 1, rb));
    const float a[4] = {v0.x, v0.y, v0.z, v0.w}, b[4] = {v1.x, v1.y, v1.z, v1.w};
    if constexpr (BF16) {
      const int byte = 2 * j;  // keys j and j + 1: one bf16 pair
      uint8_t* col = vop + (byte / W) * A::kVChunk;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        *reinterpret_cast<uint32_t*>(col + swz(W, d + e, byte % W)) = pack_bf16(a[e], b[e]);
      }
    } else {
      const int p0 = 4 * key_place_tf32(j), p1 = 4 * key_place_tf32(j + 1);
      uint8_t* c0 = vop + (p0 / W) * A::kVChunk;
      uint8_t* c1 = vop + (p1 / W) * A::kVChunk;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ba = tf32_big(a[e]), bb = tf32_big(b[e]);
        float* h0 = reinterpret_cast<float*>(c0 + swz(W, d + e, p0 % W));
        float* h1 = reinterpret_cast<float*>(c1 + swz(W, d + e, p1 % W));
        h0[0] = ba;
        h1[0] = bb;
        h0[A::kVBytes / 4] = a[e] - ba;  // the small operand, kVBytes further on
        h1[A::kVBytes / 4] = b[e] - bb;
      }
    }
  }
}

// O's n64 blocks and the key tile of the attention grid at head dim hd.
__host__ __device__ constexpr int attention_nb(int hd) { return hd <= 64 ? 1 : hd <= 128 ? 2 : 4; }
__host__ __device__ constexpr int attention_kt(int hd) {
  return attention_nb(hd) == 1 ? 64 : attention_nb(hd) == 2 ? 32 : 16;
}
// Shared-memory bytes of one consumer warpgroup's part of the attention grid:
// nraw TMA buffers of a K and a V tile, the converted K and V^T.
__host__ __device__ constexpr size_t attention_region(bool bf16, int hd, int nraw) {
  return static_cast<size_t>(nraw) * 2 * cdiv(hd, 32) * attention_kt(hd) * 128 +
         (bf16 ? static_cast<size_t>(cdiv(hd, 32)) * attention_kt(hd) * 64 +
                     64 * attention_nb(hd) * attention_kt(hd) * 2
               : static_cast<size_t>(cdiv(hd, 32)) * attention_kt(hd) * 256 +
                     64 * attention_nb(hd) * attention_kt(hd) * 8);
}
// Bytes warpgroup 1 hands to warpgroup 0 in its own part (a thread's O, max, sum).
__host__ __device__ constexpr size_t attention_handoff(int hd) {
  return static_cast<size_t>(128) * (attention_nb(hd) * 32 + 4) * 4;
}
// Shared-memory bytes of the attention grid past the alignment (as
// ops/encoder_layer.py::plan): Q, then nw warpgroups' parts.
__host__ __device__ constexpr size_t attention_bytes(bool bf16, int hd, int nraw, int nw) {
  return static_cast<size_t>(cdiv(hd, 32)) * 8192 * (bf16 ? 3 : 4) / 2 +
         static_cast<size_t>(nw) * attention_region(bf16, hd, nraw);
}

template <bool BF16, int NB, int NW>
__global__ void __launch_bounds__(128 * NW + 32, 1)
encoder_layer_attention(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kvmap, float* __restrict__ out, int T,
                        int D, int H, float scale, int nraw) {
  using A = Attn<BF16, NB>;
  constexpr int KT = A::KT;
  extern __shared__ uint8_t smem[];
  uint8_t* qraw = align1024(smem);
  const int hd = D / H, hc = cdiv(hd, 32);
  const int b = blockIdx.x / H, h = blockIdx.x % H, q0 = blockIdx.y * kQueries;
  const int tid = threadIdx.x, wg = tid >> 7, lt = tid & 127;
  uint8_t* qop = qraw + hc * 8192;
  uint8_t* wg0 = qop + hc * (BF16 ? 4096 : 8192);  // warpgroup 0's buffers
  const int rawsz = 2 * hc * KT * 128;               // a K tile, then a V tile
  const int kopsz = BF16 ? hc * KT * 64 : 2 * hc * KT * 128;
  const int wgsz = nraw * rawsz + kopsz + (BF16 ? 1 : 2) * A::kVBytes;
  uint8_t* raw0 = wg0 + wg * wgsz;  // this warpgroup's (the producer: unused)
  uint8_t* kop = raw0 + nraw * rawsz;
  uint8_t* vop = kop + kopsz;
  // at the same offset as the host's attention_bytes
  uint64_t* bars = reinterpret_cast<uint64_t*>(qraw + attention_bytes(BF16, hd, nraw, NW));
  uint64_t *qbar = bars, *full = bars + 1, *empty = bars + 1 + 2 * NW;  // [warpgroup][buffer]
  const int ntiles = cdiv(T, KT);
  mark(1, 0);
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < 2 * NW; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid >= 128 * NW) {  // the producer warp
    if (tid == 128 * NW) {
      prefetch_map(&qmap);
      prefetch_map(&kvmap);
      grid_dependency_wait();
      mbar_expect_tx(qbar, hc * 8192);
      for (int c = 0; c < hc; ++c) tma_load_4d(qraw + c * 8192, &qmap, qbar, 32 * c, h, q0, b);
      for (int i = 0; i < ntiles; ++i) {  // tile i: warpgroup i % NW, its tile j
        const int w = i % NW, j = i / NW, s = j % nraw;
        if (j >= nraw) mbar_wait(&empty[2 * w + s], (j / nraw - 1) & 1);
        uint8_t* r = wg0 + w * wgsz + s * rawsz;
        mbar_expect_tx(&full[2 * w + s], rawsz);
        for (int c = 0; c < hc; ++c) {
          tma_load_4d(r + c * KT * 128, &kvmap, &full[2 * w + s], 32 * c, H + h, i * KT, b);
          tma_load_4d(r + (hc + c) * KT * 128, &kvmap, &full[2 * w + s], 32 * c, 2 * H + h,
                      i * KT, b);
        }
      }
    }
    __syncwarp();
    return;
  }
  grid_dependency_wait();
  launch_dependents();
  mark(1, 1);
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, q = lane & 3;
  mbar_wait(qbar, 0);
  __syncwarp();
  if constexpr (BF16) {
    to_bf16(qraw, qop, tid, hc * 512, 128 * NW);
  } else {
    float4* qr = reinterpret_cast<float4*>(qraw);
    split_tf32(qr, qr, reinterpret_cast<float4*>(qop), tid, hc * 512, 128 * NW);
  }
  if constexpr (NW > 1) {  // each warpgroup reads Q converted by both
    fence_proxy_async();
    named_sync(1, 128 * NW);
  }
  float o[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.0f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.0f, 0.0f};  // rows g, g + 8 of the warp
  for (int jt = 0, i = wg; i < ntiles; ++jt, i += NW) {
    const int s = jt % nraw;
    uint8_t* r = raw0 + s * rawsz;
    mbar_wait(&full[2 * wg + s], (jt / nraw) & 1);
    __syncwarp();
    if (i == 0) mark(1, 2);
    if constexpr (BF16) {
      to_bf16(r, kop, lt, hc * KT * 8, 128);
    } else {
      split_tf32(reinterpret_cast<const float4*>(r), reinterpret_cast<float4*>(kop),
                 reinterpret_cast<float4*>(kop + hc * KT * 128), lt, hc * KT * 8, 128);
    }
    convert_vt<BF16, NB>(r + hc * KT * 128, vop, hd, lt);
    fence_proxy_async();
    named_sync(2 + wg, 128);
    if (lt == 0) mbar_arrive(&empty[2 * wg + s]);  // the TMA buffer may take the next tile

    // S = Q K^T
    float sc[KT / 2];
#pragma unroll
    for (int k = 0; k < KT / 2; ++k) sc[k] = 0.0f;
    fence_regs(sc);
    wgmma_fence();
    for (int c = 0; c < hc; ++c) {
      if constexpr (BF16) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          wgmma_ss<true, KT>(sc, smem_desc(smem_u32(qop + c * 4096) + 32 * kk, 64),
                             smem_desc(smem_u32(kop + c * KT * 64) + 32 * kk, 64));
        }
      } else {
        const uint32_t qh = smem_u32(qraw + c * 8192), ql = smem_u32(qop + c * 8192);
        const uint32_t kh = smem_u32(kop + c * KT * 128), kl = kh + hc * KT * 128;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t off = 32 * kk;
          wgmma_ss<false, KT>(sc, smem_desc(ql + off, 128), smem_desc(kh + off, 128));
          wgmma_ss<false, KT>(sc, smem_desc(qh + off, 128), smem_desc(kl + off, 128));
          wgmma_ss<false, KT>(sc, smem_desc(qh + off, 128), smem_desc(kh + off, 128));
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // online softmax over the tile's keys; keys past T get probability 0
    // sc[4 jj + e]: row g + 8 (e >> 1), key i KT + 8 jj + 2 q + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int k = 0; k < KT / 2; ++k) {
      const int key = i * KT + 8 * (k >> 2) + 2 * q + (k & 1);
      const float v = key < T ? sc[k] * scale : -INFINITY;
      sc[k] = v;
      mx[(k >> 1) & 1] = fmaxf(mx[(k >> 1) & 1], v);
    }
    float corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float mnew = fmaxf(mrow[rr], mx[rr]);  // finite: every tile has a key below T
      corr[rr] = expf(mrow[rr] - mnew);
      mrow[rr] = mnew;
      lrow[rr] *= corr[rr];
    }
#pragma unroll
    for (int k = 0; k < KT / 2; ++k) {
      const float p = expf(sc[k] - mrow[(k >> 1) & 1]);
      sc[k] = p;
      lrow[(k >> 1) & 1] += p;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int k = 0; k < 32; ++k) o[j][k] *= corr[(k >> 1) & 1];

    // O += P V: P from registers (its A fragments built before the batch), V^T
    // in shared memory
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(o[j]);
    if constexpr (BF16) {
      uint32_t a[KT / 16][4];
#pragma unroll
      for (int t = 0; t < KT / 16; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[t][e] = pack_bf16(sc[8 * t + 2 * e], sc[8 * t + 2 * e + 1]);
        fence_regs(a[t]);
      }
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < KT / 16; ++t) {
        const uint32_t byte = 32 * t;
        const uint32_t v = smem_u32(vop) + (byte / A::kVW) * A::kVChunk + byte % A::kVW;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          wgmma_rs_bf16_n64(o[j], a[t], smem_desc(v + j * 64 * A::kVW, A::kVW));
        }
      }
    } else {
      // A fragment of step t: (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4) =
      // scores of keys 2q, 2q, 2q + 1, 2q + 1 of the step's 8
      uint32_t hi[KT / 8][4], lo[KT / 8][4];
#pragma unroll
      for (int t = 0; t < KT / 8; ++t) {
        const float pv[4] = {sc[4 * t], sc[4 * t + 2], sc[4 * t + 1], sc[4 * t + 3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float bg = tf32_big(pv[e]);
          hi[t][e] = __float_as_uint(bg);
          lo[t][e] = __float_as_uint(pv[e] - bg);
        }
        fence_regs(hi[t]);
        fence_regs(lo[t]);
      }
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < KT / 8; ++t) {
        const uint32_t byte = 32 * t;
        const uint32_t vh = smem_u32(vop) + (byte / A::kVW) * A::kVChunk + byte % A::kVW;
        const uint32_t vl = vh + A::kVBytes;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const uint32_t jo = j * 64 * A::kVW;
          wgmma_rs_tf32_n64(o[j], lo[t], smem_desc(vh + jo, A::kVW));
          wgmma_rs_tf32_n64(o[j], hi[t], smem_desc(vl + jo, A::kVW));
          wgmma_rs_tf32_n64(o[j], hi[t], smem_desc(vh + jo, A::kVW));
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(o[j]);
  }
  mark(1, 3);
  if constexpr (NW > 1) {
    // warpgroup 1 hands its max, sum and O (thread by thread: the same rows and
    // columns as warpgroup 0's thread) over in its own buffers, now unused;
    // warpgroup 0 rescales both to the larger max and adds them
    constexpr int kStride = NB * 32 + 4;
    float* hand = reinterpret_cast<float*>(wg0 + wgsz) + lt * kStride;
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int k = 0; k < 32; ++k) hand[32 * j + k] = o[j][k];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        hand[NB * 32 + rr] = mrow[rr];
        hand[NB * 32 + 2 + rr] = lrow[rr];
      }
    }
    named_sync(1, 128 * NW);
    if (wg == 1) return;
    float c0[2], c1[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float m1 = hand[NB * 32 + rr], m = fmaxf(mrow[rr], m1);
      c0[rr] = expf(mrow[rr] - m);
      c1[rr] = expf(m1 - m);  // 0 where warpgroup 1 had no tile
      lrow[rr] = lrow[rr] * c0[rr] + hand[NB * 32 + 2 + rr] * c1[rr];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        o[j][k] = o[j][k] * c0[(k >> 1) & 1] + hand[32 * j + k] * c1[(k >> 1) & 1];
      }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    lrow[rr] += __shfl_xor_sync(0xffffffffu, lrow[rr], 1);
    lrow[rr] += __shfl_xor_sync(0xffffffffu, lrow[rr], 2);
  }
  const float inv_l[2] = {1.0f / lrow[0], 1.0f / lrow[1]};
  const int row0 = q0 + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const int t = row0 + 8 * ((k >> 1) & 1), d = 64 * j + 8 * (k >> 2) + 2 * q;
      if (t < T && d < hd) {
        const float inv = inv_l[(k >> 1) & 1];
        *reinterpret_cast<float2*>(out + (static_cast<size_t>(b) * T + t) * D + h * hd + d) =
            make_float2(o[j][k] * inv, o[j][k + 1] * inv);
      }
    }
  mark(1, 4);
}

// ---- the weight planes ----------------------------------------------------------------
// A weight matrix split once for 3xTF32, as convert_w splits a tile: big (the
// top 19 bits) and small = w - big, n4 float4s of each.
__global__ void __launch_bounds__(256)
weight_planes_split(const float4* __restrict__ w, float4* __restrict__ big,
                    float4* __restrict__ small, int n4) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
    const float4 v = w[i], b = big4(v);
    big[i] = b;
    small[i] = sub4(v, b);
  }
}

// ---- host side ----------------------------------------------------------------------

// One step's plan, as ops/encoder_layer.py::plan gives it: consumer warpgroups
// (rows 64 nc), n64 blocks a block (columns 64 nb), K splits (the cluster),
// stages of the TMA ring (step 2: TMA buffers), key tile (step 2), whether a
// split grid's receive buffer lies over its ring (1) or beside it, and whether
// an f32 GEMM grid reads the weight planes (1) or splits its W tiles (0).
struct GridPlan {
  int nc, nb, ck, stages, kt, overlay, planes;
};

// Bytes of a GEMM ring stage: raw A and W, then small W (f32) or A and W in bf16.
size_t gemm_stage_bytes(bool bf16, int nc, int nb) {
  return bf16 ? static_cast<size_t>(64) * (nc + nb) * 192
              : static_cast<size_t>(64) * (128 * nc + 256 * nb);
}
// k values of each of ck K slices (whole stages)
int slice_k(int K, int ck) { return cdiv(cdiv(K, ck), kKc) * kKc; }
// A ring refills a stage only after the stage after it has landed, so it needs
// two stages unless it holds every chunk at once.
bool ring_ok(int stages, int chunks) { return stages >= 1 && (stages >= 2 || stages >= chunks); }

// Shared memory of the GEMM or attention grid of step `which` (1..5) under plan
// p, or 0 when p is not one the kernels take at this shape.
size_t grid_smem(int which, bool bf16, const GridPlan& p, int D, int H, int F) {
  const int hd = D / H;
  if (which == 2) {
    if (hd > kMaxHeadDim || p.nb != attention_nb(hd) || p.kt != attention_kt(hd) ||
        p.stages < 1 || p.stages > 2 || p.overlay != 0 || p.planes != 0 || p.nc < 1 ||
        p.nc > 2 || p.ck != 1 ||
        (p.nc == 2 && (p.nb > 2 ||
                       attention_region(bf16, hd, p.stages) < attention_handoff(hd)))) {
      return 0;
    }
    return kReserve + attention_bytes(bf16, hd, p.stages, p.nc);
  }
  if (which < 1 || which > kSteps) return 0;
  const int K = which == 5 ? F : D;
  // the instantiations: (nc, nb) 22, 12 and 11
  const bool tile = (p.nc == 2 && p.nb == 2) || (p.nc == 1 && p.nb == 2) ||
                    (p.nc == 1 && p.nb == 1);
  if (!tile || p.ck < 1 || p.ck > kMaxCluster || cdiv(K, slice_k(K, p.ck)) != p.ck ||
      !ring_ok(p.stages, cdiv(slice_k(K, p.ck), kKc)) || p.stages > kMaxStages ||
      p.overlay < 0 || p.overlay > (p.ck > 1 ? 1 : 0) || p.planes < 0 ||
      p.planes > (bf16 ? 0 : 1)) {
    return 0;
  }
  const size_t ring = p.stages * gemm_stage_bytes(bf16, p.nc, p.nb);
  const int per = cdiv(64 * p.nc, p.ck);
  const size_t recv = p.ck > 1 ? static_cast<size_t>(p.ck) * per * (64 * p.nb + 4) * 4 : 0;
  return kReserve + (p.overlay ? std::max(ring, recv) : ring + recv);
}

// cuTensorMapEncodeTiled, reached through the runtime (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                 : nullptr;
  }();
  return fn;
}

// A TMA descriptor of a float32 tensor (rank 2 or 4; dims innermost first,
// strides in bytes of dims 1..), boxes of 32 x box[1] x ..., 128-byte swizzle,
// zeros past the edges. Descriptors are cached by their fields: encoding is
// host work on every eager call otherwise.
cudaError_t tensor_map(CUtensorMap* map, const float* ptr, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box) {
  std::array<uint64_t, 14> key{};
  key[0] = reinterpret_cast<uint64_t>(ptr);
  key[1] = static_cast<uint64_t>(rank);
  for (int i = 0; i < rank; ++i) {
    key[2 + i] = dims[i];
    key[6 + i] = box[i];
    if (i + 1 < rank) key[10 + i] = strides[i];
  }
  static std::mutex mu;
  static std::map<std::array<uint64_t, 14>, CUtensorMap> cache;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = cache.find(key);
    if (it != cache.end()) {
      *map = it->second;
      return cudaSuccess;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<float*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}
// A row-major (rows, cols) matrix, boxes of 32 columns x box_rows rows.
cudaError_t matrix_map(CUtensorMap* map, const float* ptr, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_rows)};
  return tensor_map(map, ptr, 2, dims, strides, box);
}

// Floats of a layer's weight planes: big and small of Win (3D x D), Wout (D x
// D), W1 (F x D) and W2 (D x F), in that order.
size_t plane_floats(int D, int F) { return 2 * (static_cast<size_t>(4) * D * D + 2 * D * F); }

// One layer's arguments, as dsg_encoder_layer takes them.
struct LayerArgs {
  const float *x, *w_in, *b_in, *w_out, *b_out, *ln1_w, *ln1_b, *w1, *b1, *w2, *b2, *ln2_w, *ln2_b;
  const float* planes;  // the layer's weight planes (plane_floats), or null
  float *work, *out;
  int B, T, D, H, F, act;
  float scale, eps;
};

// Raises `Kernel`'s dynamic shared-memory limit to kSmemLimit on the current
// device, once per device: the attribute belongs to a device, so a process that
// launches on a second card opts in there too. A failed opt-in is not
// recorded, and its error goes back to the wrapper, which raises.
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

// cudaLaunchKernelExC with each argument converted to its parameter's type.
template <typename... Params, typename... Args>
cudaError_t launch_ex(const cudaLaunchConfig_t& cfg, void (*kernel)(Params...), Args... args) {
  return [&](Params... coerced) {
    void* ptrs[] = {const_cast<void*>(static_cast<const void*>(&coerced))...};
    return cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), ptrs);
  }(args...);
}

// Launches `Kernel` with Programmatic Dependent Launch (and clusters of
// `cluster` blocks along x when cluster > 0) on `stream`.
template <auto Kernel, typename... Args>
cudaError_t launch(dim3 grid, int threads, size_t smem, int cluster, cudaStream_t stream,
                   Args... args) {
  const cudaError_t allowed = allow_smem<Kernel>();
  if (allowed != cudaSuccess) return allowed;
  if (smem > kSmemLimit) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = cluster;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = cluster > 0 ? 2 : 1;
  return launch_ex(cfg, Kernel, args...);
}

// out (M, N) = act(A (M, K) W (N, K)^T + bias); `grid` numbers its phase marks.
// On weight planes (p.planes) W's big plane is at `planes`, its small plane
// N K floats further on; otherwise the grid splits or rounds W itself.
template <bool BF16>
cudaError_t run_gemm(const GridPlan& p, size_t smem, const float* A, const float* W,
                     const float* planes, const float* bias, float* out, int M, int N, int K,
                     int act, int grid, cudaStream_t stream) {
  CUtensorMap am, wm, sm;
  cudaError_t e = matrix_map(&am, A, M, K, 64 * p.nc);
  if (e == cudaSuccess) e = matrix_map(&wm, p.planes ? planes : W, N, K, 64 * p.nb);
  if (e == cudaSuccess) {
    if (p.planes) e = matrix_map(&sm, planes + static_cast<size_t>(N) * K, N, K, 64 * p.nb);
    else sm = wm;  // not read
  }
  if (e != cudaSuccess) return e;
  const dim3 g(cdiv(M, 64 * p.nc) * p.ck, cdiv(N, 64 * p.nb));
  const int key = 10 * p.nc + p.nb, kl = slice_k(K, p.ck);
#define DSG_GEMM(NC, NB)                                                                      \
  launch<encoder_layer_gemm<BF16, NC, NB>>(g, Gemm<BF16, NC, NB>::kThreads, smem, p.ck, stream, \
                                           am, wm, sm, bias, out, M, N, K, kl, act, p.stages,  \
                                           p.overlay, p.planes, grid)
  if (key == 22) return DSG_GEMM(2, 2);
  if (key == 12) return DSG_GEMM(1, 2);
  return DSG_GEMM(1, 1);
#undef DSG_GEMM
}

// out (M, D) = LN(resid + s), one warp a row.
cudaError_t run_norm(const float* s, const float* resid, const float* gamma, const float* beta,
                     float* out, int M, int D, float eps, cudaStream_t stream) {
  const dim3 g(cdiv(M, 4));
#define DSG_NORM(V) \
  launch<encoder_layer_norm<V>>(g, 128, 0, 0, stream, s, resid, gamma, beta, out, M, D, eps)
  if (D <= 256) return DSG_NORM(2);
  if (D <= 512) return DSG_NORM(4);
  return DSG_NORM(8);
#undef DSG_NORM
}

// Grid 2: attention over qkv (B, T, 3, H, hd) into attn (B, T, D).
template <bool BF16>
cudaError_t run_attention(const GridPlan& p, size_t smem, const LayerArgs& a, const float* qkv,
                          float* attn, cudaStream_t stream) {
  const int hd = a.D / a.H;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(3 * a.H),
                              static_cast<cuuint64_t>(a.T), static_cast<cuuint64_t>(a.B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 4,
                                 static_cast<cuuint64_t>(3 * a.D) * 4,
                                 static_cast<cuuint64_t>(a.T) * 3 * a.D * 4};
  const cuuint32_t qbox[4] = {32, 1, kQueries, 1};
  const cuuint32_t kvbox[4] = {32, 1, static_cast<cuuint32_t>(p.kt), 1};
  CUtensorMap qm, kvm;
  cudaError_t e = tensor_map(&qm, qkv, 4, dims, strides, qbox);
  if (e == cudaSuccess) e = tensor_map(&kvm, qkv, 4, dims, strides, kvbox);
  if (e != cudaSuccess) return e;
  const dim3 g(a.B * a.H, cdiv(a.T, kQueries));
  const int threads = 128 * p.nc + 32, key = 10 * p.nb + p.nc;
#define DSG_ATTN(NB, NW)                                                                     \
  launch<encoder_layer_attention<BF16, NB, NW>>(g, threads, smem, 0, stream, qm, kvm, attn, a.T, \
                                                a.D, a.H, a.scale, p.stages)
  switch (key) {
    case 11: return DSG_ATTN(1, 1);
    case 12: return DSG_ATTN(1, 2);
    case 21: return DSG_ATTN(2, 1);
    case 22: return DSG_ATTN(2, 2);
    case 41: return DSG_ATTN(4, 1);
    default: return cudaErrorInvalidValue;
  }
#undef DSG_ATTN
}

// Launches step `which` (1..5) of the layer (steps 3 and 5: a GEMM grid and a
// LayerNorm grid); the layer is the five in order, seven grids.
template <bool BF16>
cudaError_t launch_step(int which, const LayerArgs& a, const GridPlan* plan, cudaStream_t stream) {
  const int M = a.B * a.T, D = a.D, F = a.F;
  float* qkv = a.work;
  float* attn = qkv + static_cast<size_t>(M) * 3 * D;
  float* y = attn + static_cast<size_t>(M) * D;
  float* hid = y + static_cast<size_t>(M) * D;
  const GridPlan& p = plan[which - 1];
  const size_t smem = grid_smem(which, BF16, p, D, a.H, F);
  if (smem == 0 || smem > kSmemLimit || (p.planes && a.planes == nullptr)) {
    return cudaErrorInvalidValue;
  }
  // each matrix's big plane (its small plane follows it)
  const float* pin = a.planes;
  const float* pout = pin + static_cast<size_t>(6) * D * D;
  const float* p1 = pout + static_cast<size_t>(2) * D * D;
  const float* p2 = p1 + static_cast<size_t>(2) * F * D;
  switch (which) {
    case 1:
      return run_gemm<BF16>(p, smem, a.x, a.w_in, pin, a.b_in, qkv, M, 3 * D, D, kNone, 0,
                            stream);
    case 2:
      return run_attention<BF16>(p, smem, a, qkv, attn, stream);
    case 3: {  // s (in qkv's place: attention has read it) = attn Wout^T + bout; y = LN1(x + s)
      const cudaError_t e = run_gemm<BF16>(p, smem, attn, a.w_out, pout, a.b_out, qkv, M, D, D,
                                           kNone, 2, stream);
      return e != cudaSuccess ? e : run_norm(qkv, a.x, a.ln1_w, a.ln1_b, y, M, D, a.eps, stream);
    }
    case 4:
      return run_gemm<BF16>(p, smem, y, a.w1, p1, a.b1, hid, M, F, D, a.act, 3, stream);
    case 5: {  // s (in qkv's place) = h W2^T + b2; out = LN2(y + s)
      const cudaError_t e =
          run_gemm<BF16>(p, smem, hid, a.w2, p2, a.b2, qkv, M, D, F, kNone, 4, stream);
      return e != cudaSuccess ? e : run_norm(qkv, y, a.ln2_w, a.ln2_b, a.out, M, D, a.eps, stream);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

// Checks the arguments and the plan, then launches step `which` (1..5), or all
// five when 0.
cudaError_t run(int which, bool bf16, const LayerArgs& a, const int* plan_ints,
                cudaStream_t stream) {
  // TMA and the 16-byte loads and stores need 16-byte aligned rows and vectors
  const void* ptrs[] = {a.x,  a.w_in, a.b_in,  a.w_out, a.b_out, a.ln1_w, a.ln1_b, a.w1,
                        a.b1, a.w2,   a.b2,    a.ln2_w, a.ln2_b, a.planes, a.work, a.out};
  for (const void* p : ptrs) {
    if (reinterpret_cast<size_t>(p) % 16) return cudaErrorMisalignedAddress;
  }
  if (plan_ints == nullptr || a.B < 1 || a.T < 1 || a.H < 1 || a.D % a.H || (a.D / a.H) % 4 ||
      a.D / a.H > kMaxHeadDim || a.D % 4 || a.F % 4 || a.D > kMaxWidth || which < 0 ||
      which > kSteps) {
    return cudaErrorInvalidValue;
  }
  GridPlan plan[kSteps];
  for (int g = 0; g < kSteps; ++g) {
    const int* v = plan_ints + kPlanInts * g;
    plan[g] = GridPlan{v[0], v[1], v[2], v[3], v[4], v[5], v[6]};
  }
  for (int g = which ? which : 1; g <= (which ? which : kSteps); ++g) {
    const cudaError_t e = bf16 ? launch_step<true>(g, a, plan, stream)
                               : launch_step<false>(g, a, plan, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// The number of steps of a layer (`which` of dsg_encoder_layer).
extern "C" int dsg_encoder_layer_steps() { return kSteps; }

// Dynamic shared memory (bytes) of step `which`'s GEMM or attention grid (1..5)
// under its plan (seven ints, as ops/encoder_layer.py::plan gives them), 0 when
// this source refuses the plan at this shape.
extern "C" size_t dsg_encoder_layer_grid_smem(int which, int bf16, const int* plan, int D, int H,
                                              int F) {
  if (which < 1 || which > kSteps || H < 1 || D % H) return 0;
  const GridPlan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};
  return grid_smem(which, bf16 != 0, p, D, H, F);
}

// Floats of device workspace one layer needs: qkv, the attention output, y and h.
extern "C" size_t dsg_encoder_layer_workspace_floats(int B, int T, int D, int F) {
  return static_cast<size_t>(B) * T * (5 * D + F);
}

// Floats of a layer's weight planes (dsg_encoder_layer_split).
extern "C" size_t dsg_encoder_layer_plane_floats(int D, int F) { return plane_floats(D, F); }

// Splits the layer's four weight matrices (nn.Linear layout, f32) into
// `planes` (dsg_encoder_layer_plane_floats(D, F) floats, 16-byte aligned), on
// `stream`. Returns the first CUDA error (0 on success).
extern "C" int dsg_encoder_layer_split(const float* w_in, const float* w_out, const float* w1,
                                       const float* w2, float* planes, int D, int F,
                                       cudaStream_t stream) {
  if (D < 4 || F < 4 || D % 4 || F % 4 || D > kMaxWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* src[4] = {w_in, w_out, w1, w2};
  const size_t n[4] = {static_cast<size_t>(3) * D * D, static_cast<size_t>(D) * D,
                       static_cast<size_t>(F) * D, static_cast<size_t>(D) * F};
  // Win first: the layer's first grid may begin (programmatic dependent launch)
  // before the last split ends, and before it waits it reads Win's planes only
  float* dst = planes;
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<size_t>(src[i]) % 16 || reinterpret_cast<size_t>(dst) % 16) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    const int n4 = static_cast<int>(n[i] / 4);
    weight_planes_split<<<std::min(cdiv(n4, 256), 1024), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(src[i]), reinterpret_cast<float4*>(dst),
        reinterpret_cast<float4*>(dst + n[i]), n4);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    dst += 2 * n[i];
  }
  return 0;
}

// x, out: (B, T, D) float32, D <= 1024, head dim D / H <= 256. Weights in
// nn.Linear (out, in) layout, float32. `planes`: the layer's weight planes
// (dsg_encoder_layer_split), read by the GEMM grids whose plan says so; may be
// null when none does. act: 0 none, 1 erf GELU, 2 tanh GELU, 3 ReLU. bf16: 0
// for the f32 (3xTF32) mode, 1 for the mxu_bf16 mode. `work` holds
// dsg_encoder_layer_workspace_floats(B, T, D, F) floats. `plan`: five steps x
// seven ints (ops/encoder_layer.py::plan). `which` is 0 for the whole layer
// (five steps, seven grids, in order), or 1..5 for that step alone, for timing.
// Returns the first CUDA error of the launches (0 on success).
extern "C" int dsg_encoder_layer(int which, const float* x, const float* w_in, const float* b_in,
                                 const float* w_out, const float* b_out, const float* ln1_w,
                                 const float* ln1_b, const float* w1, const float* b1,
                                 const float* w2, const float* b2, const float* ln2_w,
                                 const float* ln2_b, const float* planes, float* work, float* out,
                                 int B, int T, int D, int H, int F, int act, int bf16,
                                 float attn_scale, float eps, const int* plan,
                                 cudaStream_t stream) {
  const LayerArgs a{x,  w_in, b_in,  w_out, b_out, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b,
                    planes, work, out, B, T, D, H, F, act, attn_scale, eps};
  return static_cast<int>(run(which, bf16 != 0, a, plan, stream));
}

// Copies the phase marks of the last run into `out` (kSteps x kPhaseBlocks x
// kPhaseMarks x {global timer ns, SM cycles}); returns the number of values
// copied, 0 when the library was built without DSG_PHASES.
extern "C" int dsg_encoder_layer_phases(unsigned long long* out) {
#ifdef DSG_PHASES
  if (cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases)) != cudaSuccess) return 0;
  return static_cast<int>(sizeof(g_phases) / sizeof(unsigned long long));
#else
  (void)out;
  return 0;
#endif
}
