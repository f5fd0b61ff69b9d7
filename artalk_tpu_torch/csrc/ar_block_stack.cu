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
// The products cost 2 x 84.9 M x B x pn FLOP: at B = 1 only the float32 pack
// at pn = 100 (three TF32 products each, 0.103 ms) comes near its bytes; at
// the serving batches (B x pn = 140 to 40,800 rows a level) every bf16 and
// int8 product is a compute-bound matrix product.
//
// What the design does about it: the bf16 and int8 packs' products run on
// the warpgroup tensor-core engine of wgmma_gemm.cuh (bf16 operands, whose
// reference rounds both to bf16, a fresh sum per 64-deep step and, for int8,
// one scaled sum per d-deep scale chunk), weights streamed by TMA in the
// pack's width, in tiles whose plan (ops/ar_block_stack.gemm_plan) comes
// from the launch's rows: warpgroup items of 64 rows x 64 columns for a
// level of few rows, 64 x 128 CTA items where they fill the grid, and the
// projection's and fc2's splits added inside the CTA (one plane for the row
// pass) where the unsplit tiles alone fill it. Float32 packs keep the 3xTF32
// mma.sync stage of mma_stages.cuh in tiles of BM rows, 32 for levels of at
// most 64 tokens and 128 above (from pn), 64 columns wide (32 for the unsplit
// q/k/v and fc1 when their items then still fit the grid), through a cp.async
// ring; before each grid barrier a CTA issues the first kPrefetch weight
// tiles of its first item of the next product (prefetch_weights), which then
// stream in while it waits. One persistent cooperative grid of one CTA per
// SM walks each stage's items.
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
// others: every row is computed in the same order whatever B is, the tile
// plan changes no row's arithmetic, and the split counts
// (ops/ar_block_stack.contraction_splits) come from pn alone.
// The Pallas kernel's (d, TW) tile stream, its padding of pn to 16 rows and
// its batch tiling were Mosaic/VMEM artefacts and are gone.
// At B = 1 each of the seven stages is bound by latency, not by bytes or
// operations (a few items a CTA; PERF.md §6).

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
  int bm;               // float32 packs: rows of a product tile, 32 or 128
  int ln_width;         // threads of torch's LayerNorm reduction for pn rows
  int sp_proj, sp_fc2;  // contraction splits of the projection and fc2
  // bf16 / int8 packs: the wgmma engine's plan of q/k/v, the projection,
  // fc1 and fc2 (enc::Plan bits, ops/ar_block_stack.gemm_plan)
  int plan_qkv, plan_proj, plan_fc1, plan_fc2;
};

// The tensor maps of the wgmma engine's operands (bf16 and int8 packs): the
// rows of xa, attn and h, and the four weight stacks.
struct ArMaps {
  CUtensorMap xa, attn, h, wqkv, wproj, wfc1, wfc2;
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

// the wgmma engine's ring (bf16 / int8 packs): 96 KB, so that with its sums
// the kernel's shared memory stays at 160 KB and L1 keeps the rest of the SM's
// 256 KB for the attention's and row passes' loads and spilled registers
constexpr int kRingKB = 96;
// float32 packs' product tiles of BM rows: a ring of 8 stages of 32 rows or
// 4 of 128 (110.6 KB either way)
template <int BM, int BN = kBN>
using ArTiles = enc::Tiles<BM, BN, BM == 32 ? 8 : 4>;
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

template <typename WT, int BM>
__global__ void __launch_bounds__(enc::kThreads, 1)
    ar_kernel(ArParams p, const __grid_constant__ ArMaps maps) {
  // bf16 / int8 packs: the wgmma engine, whose ring shares shared memory with
  // the attention and the row passes; float32 packs: the mma.sync ring,
  // which stays across the barriers with the prefetched weight tiles
  constexpr bool kWg = sizeof(WT) != sizeof(float);
  using T = ArTiles<BM>;
  using AT = enc::Operand<WT>;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* scratch = kWg ? smem : smem + T::kBytes;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int M = p.B * p.pn, d = p.d, hid = p.hidden;
  const WT* wqkv = static_cast<const WT*>(p.wqkv);
  const WT* wproj = static_cast<const WT*>(p.wproj);
  const WT* wfc1 = static_cast<const WT*>(p.wfc1);
  const WT* wfc2 = static_cast<const WT*>(p.wfc2);
  const bool clock = p.prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long last = clock ? enc::global_ns() : 0;
  auto sync = [&](int stage) {
    const unsigned long long arrive = clock ? enc::global_ns() : 0;
    grid.sync();
    if (clock) {
      const unsigned long long now = enc::global_ns();
      p.prof[stage] += static_cast<long long>(arrive - last);
      p.prof[kStages + stage] += static_cast<long long>(now - arrive);
      p.prof[kBarriers] += 1;
      last = now;
    }
  };
  // the row pass after a split product reads one plane when it was folded
  const int rows_proj = p.plan_proj & enc::kFold ? 1 : p.sp_proj;
  const int rows_fc2 = p.plan_fc2 & enc::kFold ? 1 : p.sp_fc2;
  auto product = [&](int i, int which) -> enc::MmaGemm {
    const size_t di = static_cast<size_t>(i) * d;
    enc::MmaGemm g;
    switch (which) {
      case kQkv:
        g = {M, 3 * d, d, p.xa, wqkv + di * 3 * d, p.sqkv ? p.sqkv + 3 * di : nullptr, d, 1,
             enc::kBiasF32, p.bqkv + 3 * di, p.qkv, nullptr, &maps.xa, &maps.wqkv, i,
             p.plan_qkv};
        break;
      case kProj:
        g = {M, d, d, p.attn, wproj + di * d, p.sproj ? p.sproj + di : nullptr, d, p.sp_proj,
             enc::kPartial, nullptr, nullptr, p.partial, &maps.attn, &maps.wproj, i,
             p.plan_proj};
        break;
      case kFc1:
        g = {M, hid, d, p.xa, wfc1 + di * hid,
             p.sfc1 ? p.sfc1 + static_cast<size_t>(i) * hid : nullptr, d, 1, enc::kGeluTanh,
             p.bfc1 + static_cast<size_t>(i) * hid, p.h, nullptr, &maps.xa, &maps.wfc1, i,
             p.plan_fc1};
        break;
      default:  // fc2; int8 scales (hid / d) x d
        g = {M, d, hid, p.h, wfc2 + di * hid,
             p.sfc2 ? p.sfc2 + static_cast<size_t>(i) * hid : nullptr, d, p.sp_fc2,
             enc::kPartial, nullptr, nullptr, p.partial, &maps.h, &maps.wfc2, i, p.plan_fc2};
    }
    return g;
  };
  auto narrow = [&](const enc::MmaGemm& g) {
    return g.splits == 1 && (g.M + BM - 1) / BM * (g.N / kNarrowBN) <= static_cast<int>(gridDim.x);
  };
  auto gemm = [&](const enc::MmaGemm& g) {
    if constexpr (kWg) {
      enc::wg_gemm<WT, kRingKB>(g, smem);
    } else {
      if (narrow(g))
        enc::mma_gemm_f32<BM, kNarrowBN, T::kStages, kPrefetch>(g, smem, true);
      else
        enc::mma_gemm_f32<BM, kBN, T::kStages, kPrefetch>(g, smem, true);
    }
  };
  auto prefetch = [&](const enc::MmaGemm& g) {
    if constexpr (kWg) {
      enc::wg_prefetch(g);
    } else {
      if (narrow(g))
        enc::prefetch_weights<BM, kNarrowBN, T::kStages, kPrefetch>(g, smem);
      else
        enc::prefetch_weights<BM, kBN, T::kStages, kPrefetch>(g, smem);
    }
  };

  // the first block's modulated LN1 of the input rows
  const float eps = 1e-6f;
  enc::ada_row_pass<AT>({M, d, nullptr, 0, nullptr, p.x, nullptr, nullptr, p.ada + 2 * d,
                         p.ada + 4 * d, 6 * d, eps, p.ln_width, p.xa}, scratch);
  prefetch(product(0, kQkv));
  sync(kRowPass);
  // Per block its seven stages, walked by one loop so that the product stage
  // has one call site (inlined once: a product engine called as a function
  // would serialise its wgmma instructions)
  constexpr int kOrder[7] = {kQkv, kAttention, kProj, kRowPass, kFc1, kFc2, kRowPass};
#pragma unroll 1
  for (int i = 0; i < p.depth; ++i) {
    const float* x = i == 0 ? p.x : p.feats;
    const float* ada = p.ada + static_cast<size_t>(i) * M * 6 * d;
    const bool last = i + 1 == p.depth;
#pragma unroll 1
    for (int st = 0; st < 7; ++st) {
      const int which = kOrder[st];
      if (which == kQkv || which == kProj || which == kFc1 || which == kFc2) {
        gemm(product(i, which));
        // the next product's first weight tiles, before the barrier
        if (which != kFc2)
          prefetch(product(i, which == kQkv ? kProj : which == kProj ? kFc1 : kFc2));
        else if (!last)
          prefetch(product(i + 1, kQkv));
      } else if (which == kAttention) {
        const size_t cache_block = static_cast<size_t>(i) * p.B * p.cache_len * d;
        const size_t new_block = static_cast<size_t>(i) * M * d;
        if (attention_on_tensor_cores(p)) {
          enc::ar_tc_attention<kTcHeadDim>(
              {p.B, p.pn, p.H, d, p.start, static_cast<const __nv_bfloat16*>(p.kc) + cache_block,
               static_cast<const __nv_bfloat16*>(p.vc) + cache_block,
               static_cast<long long>(p.cache_len) * d, p.qkv, p.qscale + i * p.H,
               static_cast<__nv_bfloat16*>(p.attn),
               static_cast<__nv_bfloat16*>(p.k_new) + new_block,
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
      } else if (st == 3) {
        // x + (attn Wproj + b) gate1 -> feats; LN2 modulated by scale2, shift2
        enc::ada_row_pass<AT>({M, d, p.partial, rows_proj, p.bproj + static_cast<size_t>(i) * d,
                               x, ada, p.feats, ada + 3 * d, ada + 5 * d, 6 * d, eps,
                               p.ln_width, p.xa},
                              scratch);
      } else {
        // feats + (h Wfc2 + b) gate2 -> feats; the next block's LN1
        const float* next = p.ada + static_cast<size_t>(i + 1) * M * 6 * d;
        enc::ada_row_pass<AT>({M, d, p.partial, rows_fc2, p.bfc2 + static_cast<size_t>(i) * d,
                               p.feats, ada + d, p.feats, last ? nullptr : next + 2 * d,
                               last ? nullptr : next + 4 * d, 6 * d, eps, p.ln_width, p.xa},
                              scratch);
      }
      if (!(last && st == 6)) sync(which);
    }
  }
  if (clock) p.prof[kRowPass] += static_cast<long long>(enc::global_ns() - last);
}

template <typename WT, int BM>
int launch(const ArParams& p, cudaStream_t stream) {
  constexpr bool kWg = sizeof(WT) != sizeof(float);
  const int attn = attention_on_tensor_cores(p) ? enc::ar_attn_bytes<kTcHeadDim>(p.start + p.pn)
                                   : bs::attn_smem_floats(p.start + p.pn, p.d / p.H) *
                                         static_cast<int>(sizeof(float));
  const int rows = (5 * enc::kThreads + 1) * static_cast<int>(sizeof(float));
  const int scratch = attn > rows ? attn : rows;
  int bytes = ArTiles<BM>::kBytes + scratch;
  ArMaps maps{};
  if constexpr (kWg) {
    using R = enc::Ring<WT, kRingKB>;
    bytes = R::kBytes > scratch ? R::kBytes : scratch;
    const int m = p.B * p.pn < 64 ? 64 : p.B * p.pn;   // the wrapper allocates >= 64 rows
    if (!enc::rows_map(&maps.xa, p.xa, m, p.d) || !enc::rows_map(&maps.attn, p.attn, m, p.d) ||
        !enc::rows_map(&maps.h, p.h, m, p.hidden) ||
        !enc::weight_map<WT>(&maps.wqkv, p.wqkv, p.depth, p.d, 3 * p.d) ||
        !enc::weight_map<WT>(&maps.wproj, p.wproj, p.depth, p.d, p.d) ||
        !enc::weight_map<WT>(&maps.wfc1, p.wfc1, p.depth, p.d, p.hidden) ||
        !enc::weight_map<WT>(&maps.wfc2, p.wfc2, p.depth, p.hidden, p.d))
      return enc::kNoTensorMap;
  }
  return bs::launch_cooperative(ar_kernel<WT, BM>, p, maps, (bytes + 3) / 4, stream);
}

template <typename WT>
int dispatch_rows(const ArParams& p, cudaStream_t stream) {
  // bf16 / int8 packs: the wgmma engine's tiles come from the plans, not BM
  if constexpr (sizeof(WT) != sizeof(float))
    return launch<WT, 128>(p, stream);
  else
    return p.bm == 32 ? launch<WT, 32>(p, stream) : launch<WT, 128>(p, stream);
}

}  // namespace

// Plain C entry point. Returns 0 on success, a cudaError_t code,
// bs::kNotCoResident (-1) when the grid cannot be co-resident, or
// enc::kNoTensorMap (-2) when a tensor map cannot be made. It does not
// synchronise and allocates nothing.
extern "C" int artalk_ar_block_stack(const ArParams* p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->wtype) {
    case 0: return dispatch_rows<float>(*p, s);
    case 1: return dispatch_rows<__nv_bfloat16>(*p, s);
    default: return dispatch_rows<int8_t>(*p, s);
  }
}
