// AR block stack for Hopper (sm_90a), bound through ctypes: one VAR scale
// level's tokens through all AdaLN blocks in one launch.
//
// Replaces the Pallas TPU kernel artalk_tpu/ops/ar_block_stack.py:_kernel
// (launched by ar_block_stack() at its pl.pallas_call). Per block, as there:
//   xm  = LN(x) * (1 + scale1) + shift1            (LN without affine, eps 1e-6)
//   q, k, v = xm @ Wqkv + b                         (the k bias is zero)
//   q^ = l2n(q) * exp(min(scale_mul, ln 100)) per head, k^ = l2n(k)
//   attn = softmax(q^ . [cache keys [0, start) | k^]) . [cache values | v]
//   x  += (attn @ Wproj + b) * gate1
//   x  += (gelu_tanh((LN(x) * (1 + scale2) + shift2) @ Wfc1 + b) @ Wfc2 + b) * gate2
// with the AdaLN chunks in the order gate1, gate2, scale1, scale2, shift1,
// shift2. It returns the features (fp32) and each block's k^ and v in the
// cache type; the caller appends them to the cache at `start`.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s; 989 TFLOP/s bf16 and 495
// TF32 on the tensor cores, 67 fp32 outside them): the weights, 12 blocks x
// 7,077,888 = 84.9 M, are read once per call: 340 MB in fp32 (0.101 ms), 170
// MB in bf16 (0.051 ms), 85 MB in int8 (0.025 ms), all more than the 50 MB L2.
// The products cost 2 x 84.9 M x pn FLOP; only the float32 pack at pn = 100
// (three TF32 products each, 0.103 ms) comes near its bytes.
//
// What the design does about it (csrc/mma_stages.cuh): the products run on
// the tensor cores (mma.sync: bf16 for bf16 and int8 packs, whose reference
// rounds both operands to bf16, with a fresh accumulator per 64-deep step
// and, for int8, one scaled sum per d-deep scale chunk; 3xTF32 for float32)
// in tiles of BM rows, 32 for levels of at most 64 tokens and 128 above (the
// wrapper picks BM from pn, never from the batch), 64 columns wide (32 for
// the unsplit q/k/v and fc1 when their items then still fit the grid),
// through a cp.async ring in the pack's type that loads no operand row past
// the level's tokens, so a weight moves from memory once per call in its
// pack's width. One persistent cooperative grid of one CTA per SM walks each
// stage's items. Weights depend on no activation, so before each grid
// barrier a CTA issues the first kPrefetch weight tiles of its first item of
// the next product (prefetch_weights), which then stream in while it waits.
// Per block seven barriers separate: q/k/v | attention | the output
// projection | its row pass | fc1 + tanh GELU | fc2 | its row pass, which
// also writes the next block's modulated LayerNorm (84 a launch; the
// CUDA-core design before took 7 to 9 a block, a split product's reduction
// behind a barrier of its own). The row passes (one CTA a row) add the split
// partial sums of the projection and fc2, the bias and the gated residual,
// and write the AdaLN-modulated LayerNorm once per row, as torch computes
// the plain version's on the card (ops/ar_block_stack.ln_width), in the
// operand type. The q/k/v product's output stays float32 for the L2
// normalisation. The attention (pn queries against at most cache_len keys a
// head) runs on the tensor cores for bf16 and int8 packs (ar_tc_attention:
// the head's keys and values staged once per 64 query rows, the keys split
// between the eight warps) and on the CUDA cores for float32 packs
// (block_stack_common.cuh); it writes its output in the operand type and k^
// and v in the cache type. Each batch row's result does not depend on the
// others: every row is computed in the same order whatever B is, and the
// split counts (ops/ar_block_stack.contraction_splits) come from pn alone.
// The Pallas kernel's (d, TW) tile stream, its padding of pn to 16 rows and
// its batch tiling were Mosaic/VMEM artefacts and are gone.
// At these sizes each of the seven stages is bound by latency, not by bytes
// or operations (a few items a CTA, a warp's serial chain of mma.sync per
// 64-deep step; PERF.md §6).

#include "mma_stages.cuh"

// Field order and types must match ArParams in ops/ar_block_stack.py.
struct ArParams {
  const float* x;       // (B * pn, d)
  const float* ada;     // (depth, B * pn, 6d)
  const void* wqkv;     // (depth, d, 3d)
  const void* wproj;    // (depth, d, d)
  const void* wfc1;     // (depth, d, hidden)
  const void* wfc2;     // (depth, hidden, d)
  const float* bqkv;    // (depth, 3d)
  const float* bproj;   // (depth, d)
  const float* bfc1;    // (depth, hidden)
  const float* bfc2;    // (depth, d)
  const float* qscale;  // (depth, H)
  const float* sqkv;    // int8 packs: (depth, 1, 3d); else null
  const float* sproj;   // (depth, 1, d)
  const float* sfc1;    // (depth, 1, hidden)
  const float* sfc2;    // (depth, hidden / d, d)
  const void* kc;       // (depth, B, cache_len, d)
  const void* vc;
  float* feats;         // (B * pn, d); the running x after the first projection
  void* k_new;          // (depth, B, pn, d)
  void* v_new;
  void* xa;             // scratch (B * pn, d): a modulated LayerNorm, operand type
  float* qkv;           // scratch (B * pn, 3d)
  void* attn;           // scratch (B * pn, d), operand type
  void* h;              // scratch (B * pn, hidden), operand type
  float* partial;       // scratch (max splits x rows x d) of the split products
  long long* prof;      // null, or 13 profile counters (stage_times in the wrapper)
  int B, pn, d, H, hidden, depth, cache_len, start;
  int wtype, ctype;     // 0 f32, 1 bf16, 2 int8 / 0 f32, 1 bf16
  int bm;               // rows of a product tile: 32 or 128
  int ln_width;         // threads of torch's LayerNorm reduction for pn rows
  int sp_proj, sp_fc2;  // contraction splits of the projection and fc2
};

namespace {

constexpr int kBN = 64;   // columns of a product tile
// weight tiles a CTA issues before a grid barrier (0, 1, 2, 3 and 7 measured
// within a few % of each other; PERF.md §6)
constexpr int kPrefetch = 2;
// profile slots, as CTA 0 sees them: per stage the ns from the end of the
// previous barrier to its arrival at the next one (its own work), then per
// stage the ns it waits in that barrier, then the barriers passed
enum Stage { kRowPass = 0, kQkv, kAttention, kProj, kFc1, kFc2, kStages };
constexpr int kBarriers = 2 * kStages;

// the product tiles of BM rows: a ring of 8 stages of 32 rows or 4 of 128
// (110.6 KB either way for bf16 and float32 packs)
template <typename WT, int BM, int BN = kBN>
using ArTiles = enc::Tiles<WT, BM, BN, BM == 32 ? 8 : 4>;
// q/k/v and fc1 are not split (their consumers need whole sums); their tiles
// are half as wide when that still gives every item a CTA of the grid, so
// that twice the CTAs stream their weights. The width does not change any
// output element's arithmetic (the same mma.sync steps in the same order).
constexpr int kNarrowBN = 32;

// The attention runs on the tensor cores (enc::ar_tc_attention) for bf16 and
// int8 packs with a bf16 cache and a head dim of 64, whose reference rounds
// q, k, p and v to bf16; otherwise (float32 packs) on the CUDA cores
// (bs::attention).
constexpr int kTcHeadDim = 64;
__host__ __device__ inline bool attention_on_tensor_cores(const ArParams& p) {
  return p.wtype != 0 && p.ctype == 1 && p.d == kTcHeadDim * p.H;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <typename WT, int BM>
__global__ void __launch_bounds__(enc::kThreads, 1) ar_kernel(ArParams p) {
  using T = ArTiles<WT, BM>;
  using AT = typename T::A;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* scratch = smem + T::kBytes;   // attention and row passes; the ring stays
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int M = p.B * p.pn, d = p.d, hid = p.hidden;
  const WT* wqkv = static_cast<const WT*>(p.wqkv);
  const WT* wproj = static_cast<const WT*>(p.wproj);
  const WT* wfc1 = static_cast<const WT*>(p.wfc1);
  const WT* wfc2 = static_cast<const WT*>(p.wfc2);
  const bool clock = p.prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long last = clock ? global_ns() : 0;
  auto sync = [&](int stage) {
    const unsigned long long arrive = clock ? global_ns() : 0;
    grid.sync();
    if (clock) {
      const unsigned long long now = global_ns();
      p.prof[stage] += static_cast<long long>(arrive - last);
      p.prof[kStages + stage] += static_cast<long long>(now - arrive);
      p.prof[kBarriers] += 1;
      last = now;
    }
  };
  auto product = [&](int i, int which) -> enc::MmaGemm {
    const size_t di = static_cast<size_t>(i) * d;
    switch (which) {
      case kQkv:
        return {M, 3 * d, d, p.xa, wqkv + di * 3 * d, p.sqkv ? p.sqkv + 3 * di : nullptr, d, 1,
                enc::kBiasF32, p.bqkv + 3 * di, p.qkv, nullptr};
      case kProj:
        return {M, d, d, p.attn, wproj + di * d, p.sproj ? p.sproj + di : nullptr, d,
                p.sp_proj, enc::kPartial, nullptr, nullptr, p.partial};
      case kFc1:
        return {M, hid, d, p.xa, wfc1 + di * hid,
                p.sfc1 ? p.sfc1 + static_cast<size_t>(i) * hid : nullptr, d, 1, enc::kGeluTanh,
                p.bfc1 + static_cast<size_t>(i) * hid, p.h, nullptr};
      default:  // fc2; int8 scales (hid / d) x d
        return {M, d, hid, p.h, wfc2 + di * hid,
                p.sfc2 ? p.sfc2 + static_cast<size_t>(i) * hid : nullptr, d, p.sp_fc2,
                enc::kPartial, nullptr, nullptr, p.partial};
    }
  };
  auto narrow = [&](const enc::MmaGemm& g) {
    return g.splits == 1 && (g.M + BM - 1) / BM * (g.N / kNarrowBN) <= static_cast<int>(gridDim.x);
  };
  auto gemm = [&](const enc::MmaGemm& g) {
    if (narrow(g))
      enc::mma_gemm<WT, BM, kNarrowBN, T::kStages, kPrefetch>(g, smem, true);
    else
      enc::mma_gemm<WT, BM, kBN, T::kStages, kPrefetch>(g, smem, true);
  };
  auto prefetch = [&](const enc::MmaGemm& g) {
    if (narrow(g))
      enc::prefetch_weights<WT, BM, kNarrowBN, T::kStages, kPrefetch>(g, smem);
    else
      enc::prefetch_weights<WT, BM, kBN, T::kStages, kPrefetch>(g, smem);
  };

  // the first block's modulated LN1 of the input rows
  const float eps = 1e-6f;
  enc::ada_row_pass<AT>({M, d, nullptr, 0, nullptr, p.x, nullptr, nullptr, p.ada + 2 * d,
                         p.ada + 4 * d, 6 * d, eps, p.ln_width, p.xa}, scratch);
  prefetch(product(0, kQkv));
  sync(kRowPass);
  for (int i = 0; i < p.depth; ++i) {
    const float* x = i == 0 ? p.x : p.feats;
    const float* ada = p.ada + static_cast<size_t>(i) * M * 6 * d;
    const bool last = i + 1 == p.depth;

    gemm(product(i, kQkv));
    prefetch(product(i, kProj));
    sync(kQkv);

    const size_t cache_block = static_cast<size_t>(i) * p.B * p.cache_len * d;
    const size_t new_block = static_cast<size_t>(i) * M * d;
    if (attention_on_tensor_cores(p)) {
      enc::ar_tc_attention<kTcHeadDim>(
          {p.B, p.pn, p.H, d, p.start, static_cast<const __nv_bfloat16*>(p.kc) + cache_block,
           static_cast<const __nv_bfloat16*>(p.vc) + cache_block,
           static_cast<long long>(p.cache_len) * d, p.qkv, p.qscale + i * p.H,
           static_cast<__nv_bfloat16*>(p.attn), static_cast<__nv_bfloat16*>(p.k_new) + new_block,
           static_cast<__nv_bfloat16*>(p.v_new) + new_block}, scratch);
    } else {
      bs::Attn a{};
      a.B = p.B; a.T = p.pn; a.H = p.H; a.hd = d / p.H; a.d = d;
      a.prefix = p.start;
      a.cache_b_stride = static_cast<long long>(p.cache_len) * d;
      a.q = p.qkv; a.k = p.qkv + d; a.v = p.qkv + 2 * d; a.ld = 3 * d;
      a.l2norm = 1; a.qscale = p.qscale + i * p.H; a.logit_scale = 1.0f;
      a.round = sizeof(WT) != sizeof(float); a.out = p.attn;
      float* attn_smem = reinterpret_cast<float*>(scratch);
      if (p.ctype == 0) {
        a.kc = static_cast<const float*>(p.kc) + cache_block;
        a.vc = static_cast<const float*>(p.vc) + cache_block;
        a.k_out = static_cast<float*>(p.k_new) + new_block;
        a.v_out = static_cast<float*>(p.v_new) + new_block;
        bs::attention<float, AT>(a, attn_smem);
      } else {
        a.kc = static_cast<const __nv_bfloat16*>(p.kc) + cache_block;
        a.vc = static_cast<const __nv_bfloat16*>(p.vc) + cache_block;
        a.k_out = static_cast<__nv_bfloat16*>(p.k_new) + new_block;
        a.v_out = static_cast<__nv_bfloat16*>(p.v_new) + new_block;
        bs::attention<__nv_bfloat16, AT>(a, attn_smem);
      }
    }
    sync(kAttention);

    gemm(product(i, kProj));
    prefetch(product(i, kFc1));
    sync(kProj);
    // x + (attn Wproj + b) gate1 -> feats; LN2 modulated by scale2, shift2
    enc::ada_row_pass<AT>({M, d, p.partial, p.sp_proj, p.bproj + static_cast<size_t>(i) * d,
                           x, ada, p.feats, ada + 3 * d, ada + 5 * d, 6 * d, eps, p.ln_width,
                           p.xa},
                          scratch);
    sync(kRowPass);

    gemm(product(i, kFc1));
    prefetch(product(i, kFc2));
    sync(kFc1);
    gemm(product(i, kFc2));
    if (!last) prefetch(product(i + 1, kQkv));
    sync(kFc2);
    // feats + (h Wfc2 + b) gate2 -> feats; the next block's LN1
    const float* next = p.ada + static_cast<size_t>(i + 1) * M * 6 * d;
    enc::ada_row_pass<AT>({M, d, p.partial, p.sp_fc2, p.bfc2 + static_cast<size_t>(i) * d,
                           p.feats, ada + d, p.feats, last ? nullptr : next + 2 * d,
                           last ? nullptr : next + 4 * d, 6 * d, eps, p.ln_width, p.xa},
                          scratch);
    if (!last) sync(kRowPass);
  }
  if (clock) p.prof[kRowPass] += static_cast<long long>(global_ns() - last);
}

template <typename WT, int BM>
int launch(const ArParams& p, cudaStream_t stream) {
  using T = ArTiles<WT, BM>;
  const int attn = attention_on_tensor_cores(p) ? enc::ar_attn_bytes<kTcHeadDim>(p.start + p.pn)
                                   : bs::attn_smem_floats(p.start + p.pn, p.d / p.H) *
                                         static_cast<int>(sizeof(float));
  const int rows = (5 * enc::kThreads + 1) * static_cast<int>(sizeof(float));
  const int bytes = T::kBytes + (attn > rows ? attn : rows);
  return bs::launch_cooperative(ar_kernel<WT, BM>, p, (bytes + 3) / 4, stream);
}

template <typename WT>
int dispatch_rows(const ArParams& p, cudaStream_t stream) {
  return p.bm == 32 ? launch<WT, 32>(p, stream) : launch<WT, 128>(p, stream);
}

}  // namespace

// Plain C entry point. Returns 0 on success, a cudaError_t code, or
// bs::kNotCoResident (-1) when the grid cannot be co-resident. It does not
// synchronise and allocates nothing.
extern "C" int artalk_ar_block_stack(const ArParams* p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->wtype) {
    case 0: return dispatch_rows<float>(*p, s);
    case 1: return dispatch_rows<__nv_bfloat16>(*p, s);
    default: return dispatch_rows<int8_t>(*p, s);
  }
}
