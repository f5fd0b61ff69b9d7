// The product stage of both block-stack kernels for bf16 and int8 packs, on
// Hopper's warpgroup tensor-core instructions (wgmma), and the description
// of a product that both the wgmma engine and the float32 packs' mma.sync
// stage (mma_stages.cuh) take.
//
// Each product is computed swapped, out^T = W^T . A^T: a tile of 64 weight
// columns is the 64-row A operand of wgmma.m64n64k16, held in registers, and
// 64 operand rows are its B operand, read from shared memory. The weights
// move from memory in the pack's type (int8 or bf16); an int8 tile is
// widened to bf16 in registers, which is exact for |q| <= 127, so a level of
// few tokens fills the n64 side without a wasted weight row.
//
// Loads: a ring of stages in shared memory, each one step of 64 contraction
// rows (the operand rows' tile and one or two weight tiles), filled by TMA
// (host-made tensor maps) that one thread of the lane issues, each stage's
// arrival tracked by an mbarrier and its release by another; the other
// threads spend no instructions on loads and no block-wide barrier runs per
// step. A warpgroup waits only on the stage it needs.
//
// Arithmetic, as the mma.sync design had it (PERF.md §6): bf16 operands;
// each 64-deep step's sum from zero (a fresh wgmma group, scale-d = 0 on its
// first k16) and added to the running float32 sum with ordinary float32
// adds; for int8 one running sum per d-deep scale chunk, scaled (fmaf) into
// the split's sum in order. No atomics. A warpgroup waits for each group
// before its next one (two sets of step sums in flight do not fit the
// registers at 128 rows, and divergent work beside a group in flight makes
// ptxas serialise every wgmma); the two warpgroups' groups alternate on the
// tensor cores instead.
//
// Tiles and splits. The host picks a plan from the launch's rows
// (ops/ar_block_stack.gemm_plan): wide, the two warpgroups share one ring
// and one 128-row operand tile, each taking 64 of a CTA item's 128 columns
// (each step as two 64-row groups with the same weight fragments); narrow,
// each warpgroup is a lane of its own (half the ring, items of 64 rows x 64
// columns, spread over the CTAs first), so that a product of few rows still
// spreads its weights over the grid. The contraction's split count comes
// from one batch row's shape (contraction_splits, encoder_splits). When the
// unsplit wide tiles alone fill the grid, a CTA computes all splits of its
// tile in order and adds them, split 0 first, to a float32 sum from 0 (the
// fold), as the row pass adds the planes, and writes one plane: the same
// bits, and s - 1 planes fewer through memory. A row's result therefore does
// not depend on the batch, the plan or the fold.

#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include <type_traits>

#include "block_stack_common.cuh"
#include "mma_ptx.cuh"

namespace enc {

using namespace ptx;

constexpr int kThreads = bs::kThreads;
constexpr int kWarps = bs::kWarps;

// kBias / kGelu / kGeluTanh: bias (and GELU) added, stored in the operand
// type; kBiasF32: bias added, stored in float32; kPartial: the split's
// float32 sum to partial[split], for a row pass to add
enum Epi { kBias = 0, kGelu = 1, kPartial = 2, kGeluTanh = 3, kBiasF32 = 4 };

// the wgmma engine's tile plan of a product (ops/ar_block_stack.gemm_plan):
// kWide, the two warpgroups share 128-column items; kFold, a CTA adds all
// splits of its tile (one plane written); kFoldLastFirst, a planted fault
// for chip_smoke.py that adds the folded splits last first
enum Plan { kWide = 1, kFold = 2, kFoldLastFirst = 4 };

// the operand type of a pack: float32 for float32 packs, else bf16
template <typename WT>
using Operand = typename std::conditional<sizeof(WT) == 4, float, __nv_bfloat16>::type;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// out = epi(A[M, K] @ W[K, N] + bias) for A and W of the pack's operand and
// weight types; with splits > 1 (kPartial) the float32 partial sums of each
// split go to partial[split][M][N] for the row pass to add (one plane when
// folded). An int8 sum is scaled at the end of each scale chunk (`chunk`
// rows of the contraction).
struct MmaGemm {
  int M, N, K;
  const void* a;        // (M, K) operand rows, row stride K
  const void* w;        // (K, N) in the pack's type
  const float* scales;  // int8 packs: (K / chunk, N); else unused
  int chunk;
  int splits;
  int epi;
  const float* bias;    // (N), all but kPartial
  void* out;            // (M, N): the operand type, float32 for kBiasF32
  float* partial;       // kPartial
  // the wgmma engine: tensor maps of the operand rows (bf16, 64 x 64 boxes)
  // and of the weights ((depth, K, N), 64 x 64 x 1 boxes), the weights'
  // depth index, and the tile plan
  const CUtensorMap* amap = nullptr;
  const CUtensorMap* wmap = nullptr;
  int layer = 0;
  int plan = 0;
};

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// waits until the barrier's phase of this parity has completed; a wait of
// more than 10 s traps, so that a ring that never fills fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  unsigned long long since = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 0xFFFF) == 0) {
      const unsigned long long now = global_ns();
      if (since == 0) since = now;
      else if (now - since > 10000000000ull) __trap();
    }
  }
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// earlier generic-proxy accesses of shared memory ordered before later
// async-proxy ones (TMA writes, wgmma reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

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
// keeps the compiler from moving accesses of a register across the wgmma
// instructions that read or write it asynchronously
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// the descriptor of a K-major, 128-byte-swizzled tile of 64-element (128 B)
// rows in shared memory (8-row groups 1024 B apart), at its first k
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 64 float32, a warpgroup's fragment: 32 floats a thread) = [d +]
// a (64 x 16 bf16, in registers) . b (16 x 64 bf16, K-major in shared
// memory); d from zero unless accumulate
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the CUDA driver's cuTensorMapEncodeTiled, looked up once (the library links
// only the CUDA runtime)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// error code of the entry points when a tensor map cannot be made
constexpr int kNoTensorMap = -2;

// the operand rows (rows, k) in bf16, read as 64 x 64 boxes with the 128-byte
// swizzle; rows past the end read as zeros
inline bool rows_map(CUtensorMap* map, const void* base, int rows, int k) {
  const EncodeTiled fn = encode_tiled();
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box[2] = {64, 64}, one[2] = {1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
             CUDA_SUCCESS;
}

// the weights (depth, k, n) of a bf16 or int8 pack, read as 64-column x
// 64-row boxes of one layer, swizzled over their 128- or 64-byte rows
template <typename WT>
bool weight_map(CUtensorMap* map, const void* base, int depth, int k, int n) {
  const EncodeTiled fn = encode_tiled();
  constexpr cuuint64_t kSize = sizeof(WT);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {n * kSize, static_cast<cuuint64_t>(k) * n * kSize};
  const cuuint32_t box[3] = {64, 64, 1}, one[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, kSize == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            kSize == 1 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
             CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// The engine
// ---------------------------------------------------------------------------

constexpr int kWgCols = 64;   // weight columns of a warpgroup's tile (the wgmma M side)
constexpr int kStep = 64;     // contraction rows of a step

// Shared memory of the engine (1024-byte aligned): a ring of RING_KB KB of
// stages, each one operand tile (RN rows x 64 bf16, 128-byte swizzle) and
// one weight tile per warpgroup of the lane (64 x 64 of the pack's type,
// 128- or 64-byte swizzle); 64 KB of float32 sums a thread keeps across
// splits or int8 scale chunks (the fold, a split's earlier chunks); a full
// and an empty barrier per stage. A wide product's one lane takes the whole
// ring in 128-row stages, a narrow one's two lanes half of it each in
// 64-row stages (a warpgroup whose partner has no item, the whole of it):
// at 160 KB, int8 6 stages wide and 6 a lane narrow, bf16 5 and 5; at 96
// KB, int8 4 and 4, bf16 3 and 3.
template <typename WT, int RING_KB>
struct Ring {
  static constexpr int kWBytes = kStep * kWgCols * static_cast<int>(sizeof(WT));
  static constexpr int kRingBytes = RING_KB * 1024;
  static constexpr int kSumBytes = 64 * 1024;
  static constexpr int kMaxStages = 16;
  static constexpr int kBarOffset = kRingBytes + kSumBytes;
  static constexpr int kBytes = kBarOffset + 2 * kMaxStages * 8;
  __host__ __device__ static constexpr int rows(bool wide) { return wide ? 128 : 64; }
  __host__ __device__ static constexpr int stage_bytes(bool wide) {
    return rows(wide) * kStep * 2 + (wide ? 2 : 1) * kWBytes;
  }
  __host__ __device__ static constexpr int stages(bool wide) {
    return (wide ? kRingBytes : kRingBytes / 2) / stage_bytes(wide);
  }
};

// The A fragments of a step (four k16 sub-steps) of this warp's 16 weight
// columns from a weight tile [64 k][64 n]. bf16 (128-byte rows, 128-byte
// swizzle): ldmatrix.trans gives them as they are, fragment row m = column
// 16 w + m. int8 (64-byte rows, 64-byte swizzle): ldmatrix.trans of byte
// pairs gives a thread q[2t][2g..2g+1] and q[2t+1][2g..2g+1]; fragment row
// g takes column 16 w + 2g and row g + 8 column 16 w + 2g + 1, each widened
// to bf16 (exactly: 2^23 + (q + 128) as a float's bits, less 2^23 + 128).
template <typename WT>
__device__ __forceinline__ void load_frags(const unsigned char* wt, uint32_t (&a)[4][4]) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int q = lane >> 3, i = lane & 7;
  if constexpr (sizeof(WT) == 2) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 16 * kk + 8 * (q >> 1) + i, c = 2 * w + (q & 1);
      ldsm_x4_trans(a[kk], wt + k * 128 + ((c ^ (k & 7)) << 4));
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 32 * h + 8 * q + i;
      uint32_t r[4];
      ldsm_x4_trans(r, wt + k * 64 + ((w ^ ((k >> 1) & 3)) << 4));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t x = r[u] ^ 0x80808080u;
        constexpr float kBias = 8388736.0f;   // 2^23 + 128
        const float f0 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650)) - kBias;
        const float f1 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7651)) - kBias;
        const float f2 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7652)) - kBias;
        const float f3 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7653)) - kBias;
        // matrix u: k rows 32h + 8u ..; even u the first half of a k16, odd the second
        uint32_t* f = a[2 * h + (u >> 1)] + 2 * (u & 1);
        f[0] = pack_bf16(f0, f2);   // column 2g: k 2t, 2t + 1
        f[1] = pack_bf16(f1, f3);   // column 2g + 1
      }
    }
  }
}

// A lane's walk over its items and their steps, kept step by step without
// divisions: the item's first row and columns, its split, the contraction
// row k0 of the step, the step within the item and within its split.
struct Cursor {
  int item, m0, n0, split, k0, step, in_split;
};

// The engine for tiles of RN operand rows (128: wide plans, 64: narrow).
// Inlined: a wgmma pipeline that crosses a call is serialised by ptxas, so
// the kernels call wg_gemm from one place.
template <typename WT, int RING_KB, int RN>
__device__ __forceinline__ void wg_run(const MmaGemm& g, unsigned char* smem) {
  using R = Ring<WT, RING_KB>;
  using AT = Operand<WT>;
  constexpr bool kInt8 = sizeof(WT) == 1;
  constexpr bool kWide = RN == 128;
  constexpr int kAcc = RN / 2;                       // floats of a thread's fragment
  constexpr int kStages = R::stages(kWide), kStageBytes = R::stage_bytes(kWide);
  constexpr int kRowBytes = RN * kStep * 2;
  constexpr int kCols = kWide ? 2 * kWgCols : kWgCols;
  constexpr uint32_t kTx = kRowBytes + (kWide ? 2 : 1) * R::kWBytes;
  // the warpgroup's index through a shuffle, so that the compiler knows it
  // uniform across each warp
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int gq = lane >> 2, t = lane & 3;

  const bool fold = g.plan & kFold, last_first = g.plan & kFoldLastFirst;
  const int col_tiles = g.N / kCols, row_tiles = (g.M + RN - 1) / RN;
  const int items = row_tiles * col_tiles * (fold ? 1 : g.splits);
  const int split_len = g.K / g.splits, split_steps = split_len / kStep;
  const int nk = fold ? g.K / kStep : split_steps;   // steps of an item
  // a split over several int8 scale chunks (never folded: ops/ar_block_stack.gemm_plan)
  const bool multi = kInt8 && split_len > g.chunk;
  const int chunk_steps = g.chunk / kStep;
  // narrow lanes: item i to warpgroup i / grid of CTA i % grid, so that a
  // product of few items spreads over the SMs; a warpgroup whose partner has
  // no item takes the whole ring
  const int stride = kWide ? gridDim.x : 2 * gridDim.x;
  const int first = kWide ? blockIdx.x : blockIdx.x + wg * gridDim.x;
  const bool alone = !kWide && blockIdx.x + gridDim.x >= items;
  const int stages = alone ? 2 * kStages : kStages;
  unsigned char* ring = smem + (kWide || alone ? 0 : wg * (R::kRingBytes / 2));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::kBarOffset) +
                   (kWide || alone ? 0 : wg * kStages);
  uint64_t* empty = full + R::kMaxStages;
  // this thread's sums across splits or scale chunks: [kAcc / 4][kThreads] float4
  float4* sums = reinterpret_cast<float4*>(smem + R::kRingBytes) + tid;
  const bool producer = (tid & 127) == 0 && (!kWide || wg == 0);
  const bool leader = (tid & 127) == 0;   // releases this warpgroup's stages
  const int sub = kWide ? wg : 0;         // this warpgroup's weight tile of a stage
  const int wcol = kWide ? kWgCols * wg : 0;

  // (called right after a grid barrier: the CTA is done with shared memory's
  // earlier use)
  if (tid == 0) {
    for (int s = 0; s < (kWide ? 1 : 2) * kStages; ++s) {
      mbar_init(reinterpret_cast<uint64_t*>(smem + R::kBarOffset) + s, 1);
      mbar_init(reinterpret_cast<uint64_t*>(smem + R::kBarOffset) + R::kMaxStages + s,
                kWide ? 2 : 1);
    }
    fence_barrier_init();
  }
  fence_proxy_async();
  __syncthreads();

  auto start = [&](Cursor& c, int item) {
    c.item = item;
    if (item >= items) return;
    int rt, ct;
    const int splits = fold ? 1 : g.splits;
    if (kWide) {   // columns fastest: the CTAs in flight share operand rows in L2
      ct = item % col_tiles;
      c.split = fold ? 0 : (item / col_tiles) % splits;
      rt = item / (col_tiles * splits);
    } else {       // rows fastest: the CTAs in flight share weight tiles
      rt = item % row_tiles;
      c.split = (item / row_tiles) % splits;
      ct = item / (row_tiles * splits);
    }
    c.m0 = rt * RN;
    c.n0 = ct * kCols;
    c.k0 = fold ? (last_first ? (g.splits - 1) * split_len : 0) : c.split * split_len;
    c.step = c.in_split = 0;
  };
  auto advance = [&](Cursor& c) {
    c.k0 += kStep;
    if (++c.in_split == split_steps) {
      c.in_split = 0;
      if (last_first) c.k0 -= 2 * split_len;   // the split before
    }
    if (++c.step == nk) start(c, c.item + stride);
  };

  // the producer's walk, ahead of the consumers' by up to stages - 1 steps:
  // a stage is refilled once this lane's consumers have released it
  Cursor pc;
  start(pc, first);
  int p_stage = 0;
  uint32_t p_phase = 0;
  bool p_wrapped = false;
  auto produce = [&]() {
    if (pc.item >= items) return;
    if (p_wrapped) mbar_wait(empty + p_stage, p_phase ^ 1);
    unsigned char* dst = ring + p_stage * kStageBytes;
    mbar_expect_tx(full + p_stage, kTx);
#pragma unroll
    for (int h = 0; h < RN / 64; ++h)
      tma_load_2d(dst + h * 64 * 128, g.amap, full + p_stage, pc.k0, pc.m0 + 64 * h);
#pragma unroll
    for (int w = 0; w < (kWide ? 2 : 1); ++w)
      tma_load_3d(dst + kRowBytes + w * R::kWBytes, g.wmap, full + p_stage,
                  pc.n0 + w * kWgCols, pc.k0, g.layer);
    advance(pc);
    if (++p_stage == stages) {
      p_stage = 0;
      p_phase ^= 1;
      p_wrapped = true;
    }
  };
  if (producer)
    for (int s = 0; s < stages - 1; ++s) produce();
  __syncwarp();

  // this thread's two weight columns (fragment rows g and g + 8) within its
  // warpgroup's 64: adjacent for int8, 8 apart for bf16
  const int col_a = 16 * warp + (kInt8 ? 2 * gq : gq);
  const int col_b = col_a + (kInt8 ? 1 : 8);

  // acc: the running sums of the thread's RN / 2 values; part: one 64-row
  // half's step sum (a wide tile runs its halves one after the other, with
  // the same weight fragments, so that the registers hold both sets)
  float part[32], acc[kAcc];
  uint32_t frag[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

  // the item's values (acc) through the epilogue; rows from M on are not written
  auto epilogue = [&](const Cursor& c, float ba, float bb) {
    const int na = c.n0 + wcol + col_a, nb = c.n0 + wcol + col_b;
#pragma unroll
    for (int j = 0; j < RN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = c.m0 + 8 * j + 2 * t + e;
        if (row >= g.M) continue;
        float ya = acc[4 * j + e], yb = acc[4 * j + 2 + e];
        if (g.epi == kPartial) {
          float* dst = g.partial + (static_cast<size_t>(fold ? 0 : c.split) * g.M + row) * g.N;
          if constexpr (kInt8) {
            store2(dst + na, ya, yb);
          } else {
            dst[na] = ya;
            dst[nb] = yb;
          }
          continue;
        }
        ya += ba;
        yb += bb;
        if (g.epi == kGelu) {
          ya = bs::gelu_erf(ya);
          yb = bs::gelu_erf(yb);
        } else if (g.epi == kGeluTanh) {
          ya = bs::gelu_tanh(ya);
          yb = bs::gelu_tanh(yb);
        }
        if (g.epi == kBiasF32) {
          float* dst = static_cast<float*>(g.out) + static_cast<size_t>(row) * g.N;
          if constexpr (kInt8) {
            store2(dst + na, ya, yb);
          } else {
            dst[na] = ya;
            dst[nb] = yb;
          }
        } else {
          AT* dst = static_cast<AT*>(g.out) + static_cast<size_t>(row) * g.N;
          if constexpr (kInt8) {
            store2(dst + na, ya, yb);
          } else {
            dst[na] = __float2bfloat16_rn(ya);
            dst[nb] = __float2bfloat16_rn(yb);
          }
        }
      }
  };
  // acc = the saved sums + acc (first: acc stands alone, as 0 + acc would,
  // but for the sign of a zero, which no later sum keeps); then saved unless last
  auto add_saved = [&](bool first_part, bool last_part) {
#pragma unroll
    for (int i4 = 0; i4 < kAcc / 4; ++i4) {
      float4 v = first_part ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : sums[i4 * kThreads];
      v.x = __fadd_rn(v.x, acc[4 * i4]);
      v.y = __fadd_rn(v.y, acc[4 * i4 + 1]);
      v.z = __fadd_rn(v.z, acc[4 * i4 + 2]);
      v.w = __fadd_rn(v.w, acc[4 * i4 + 3]);
      if (last_part) {
        acc[4 * i4] = v.x;
        acc[4 * i4 + 1] = v.y;
        acc[4 * i4 + 2] = v.z;
        acc[4 * i4 + 3] = v.w;
      } else {
        sums[i4 * kThreads] = v;
      }
    }
  };

  // The consumers' walk: per step, wait for its stage, widen the weights'
  // fragments, run the step's group from zero and wait for it; only then
  // (no group in flight: divergent work there would serialise every wgmma)
  // release the stage, add the step's sum, close a scale chunk, a split or
  // an item, and refill a stage. The two warpgroups' groups alternate on
  // the tensor cores.
  Cursor cc;
  start(cc, first);
  int stage = 0;
  uint32_t phase = 0;
  int chunk_step = 0;   // multi: the step within its scale chunk
  // the item's bias and the scale chunk's int8 scales, loaded at its first
  // step so that their latency hides behind the item's steps
  float ba = 0.0f, bb = 0.0f, sa = 0.0f, sb = 0.0f;
  while (cc.item < items) {
    if (cc.step == 0 && g.epi != kPartial) {
      ba = __ldg(g.bias + cc.n0 + wcol + col_a);
      bb = __ldg(g.bias + cc.n0 + wcol + col_b);
    }
    if (kInt8 && (multi ? chunk_step == 0 : cc.in_split == 0)) {
      const float* sc = g.scales + static_cast<size_t>(cc.k0 / g.chunk) * g.N + cc.n0 + wcol;
      sa = __ldg(sc + col_a);
      sb = __ldg(sc + col_b);
    }
    mbar_wait(full + stage, phase);
    const unsigned char* base = ring + stage * kStageBytes;
    load_frags<WT>(base + kRowBytes + sub * R::kWBytes, frag);
#pragma unroll
    for (int h = 0; h < RN / 64; ++h) {
      // rows 64 h ..: 8 KB into the operand tile, 512 in the descriptor's units
      const uint64_t desc = sw128_desc(base) + 512 * h;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16(part, frag[kk], desc + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_reg(part[i]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[32 * h + i] += part[i];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) fence_reg(frag[kk][r]);
    if (leader) mbar_arrive(empty + stage);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }

    const bool split_end = cc.in_split + 1 == split_steps;
    const bool item_end = cc.step + 1 == nk;
    const bool first_split = cc.step < split_steps;   // folded: the first in the order
    bool saved = false;   // acc went to the sums kept across splits or chunks
    if constexpr (kInt8) {
      const bool chunk_end = multi ? ++chunk_step == chunk_steps : split_end;
      if (chunk_end) {
        // the end of a scale chunk: its sum scaled; folded (one chunk a
        // split), added to the fold as the row pass adds the planes; over
        // several chunks, added into the split's sum in order (fmaf)
        if (fold) {
#pragma unroll
          for (int i = 0; i < kAcc; ++i) acc[i] = __fmul_rn(acc[i], (i & 2) ? sb : sa);
          add_saved(first_split, item_end);
          saved = !item_end;
        } else if (multi) {
          const bool first_chunk = cc.in_split + 1 == chunk_steps;
#pragma unroll
          for (int i4 = 0; i4 < kAcc / 4; ++i4) {
            float4 v = first_chunk ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : sums[i4 * kThreads];
            v.x = fmaf(acc[4 * i4], sa, v.x);
            v.y = fmaf(acc[4 * i4 + 1], sa, v.y);
            v.z = fmaf(acc[4 * i4 + 2], sb, v.z);
            v.w = fmaf(acc[4 * i4 + 3], sb, v.w);
            if (split_end) {
              acc[4 * i4] = v.x;
              acc[4 * i4 + 1] = v.y;
              acc[4 * i4 + 2] = v.z;
              acc[4 * i4 + 3] = v.w;
            } else {
              sums[i4 * kThreads] = v;
            }
          }
          saved = !split_end;
          chunk_step = 0;
        } else {
#pragma unroll
          for (int i = 0; i < kAcc; ++i) acc[i] = fmaf(acc[i], (i & 2) ? sb : sa, 0.0f);
        }
      }
    } else if (fold && split_end) {
      add_saved(first_split, item_end);
      saved = !item_end;
    }
    if (item_end) epilogue(cc, ba, bb);
    if (item_end || saved) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    }
    advance(cc);
    if (producer) produce();   // into the stage the step before released
    __syncwarp();
  }

  __syncthreads();   // every stage consumed: the barriers' memory is free again
  if (tid == 0)
    for (int s = 0; s < (kWide ? 1 : 2) * kStages; ++s) {
      mbar_inval(reinterpret_cast<uint64_t*>(smem + R::kBarOffset) + s);
      mbar_inval(reinterpret_cast<uint64_t*>(smem + R::kBarOffset) + R::kMaxStages + s);
    }
}

template <typename WT, int RING_KB>
__device__ __forceinline__ void wg_gemm(const MmaGemm& g, unsigned char* smem) {
  if (g.plan & kWide)
    wg_run<WT, RING_KB, 128>(g, smem);
  else
    wg_run<WT, RING_KB, 64>(g, smem);
}

// Before a grid barrier, the thread that will fill each lane's ring asks for
// the next product's tensor-map descriptors, so that its first copies after
// the barrier do not wait for them. (Its weight tiles are not prefetched: at
// B = 1 issuing them delayed every CTA's arrival at the barrier by more than
// they saved, 0.43 ms a window of 4.4; PERF.md §6.)
__device__ __forceinline__ void tensormap_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void wg_prefetch(const MmaGemm& g) {
  if (threadIdx.x != 0) return;
  tensormap_prefetch(g.amap);
  tensormap_prefetch(g.wmap);
}

}  // namespace enc
