// wav2vec2 encoder stack for Hopper (sm_90a), bound through ctypes: all
// pre-LN layers of the stable-layer-norm encoder in one launch.
//
// Replaces the Pallas TPU kernel artalk_tpu/ops/encoder_block_stack.py:_kernel
// (launched by encoder_block_stack() at its pl.pallas_call). Per layer, as
// there:
//   x += (softmax((LN1(x) Wq + bq) . (LN1(x) Wk + bk) * hd^-0.5) . (LN1(x) Wv + bv)) Wo + bo
//   x += gelu_erf(LN2(x) W1 + b1) W2 + b2
// with affine LayerNorms (eps from the config, 1e-5) and bidirectional
// attention over the window's frames. The final LayerNorm stays with the
// caller. The Pallas kernel's Abramowitz-Stegun erf existed because Mosaic
// has no erf; this kernel uses erff.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 and 495
// TF32 on the tensor cores, 67 fp32 outside them): 24 layers x 12,582,912 =
// 302 M weights and about 124 GFLOP per 199-frame window, attention
// included. At one window a bf16 pack is bound by its 604 MB of weights
// (0.18 ms), an int8 pack by bf16 tensor-core operations (0.125 ms), the
// float32 pack by 3xTF32 (three TF32 products per product, 0.75 ms), and
// each stage is short, so the grid-wide barriers between stages and the
// latency of each item count as much. At the stream's 140 windows (27,860
// rows) every product is a compute-bound matrix product (17 TFLOP a launch).
//
// What the design does about it: the bf16 and int8 packs' products run on
// the warpgroup tensor-core engine of wgmma_gemm.cuh (bf16 operands, whose
// reference rounds both to bf16; int8 weights widened in registers), fed by
// TMA in the pack's own type, in tiles planned from the launch's rows
// (ops/ar_block_stack.gemm_plan): at one window q/k/v and fc1 take warpgroup
// items of 64 x 64, the split products CTA items of 64 x 128; at a serving
// batch every product takes CTA items, and the output projection's and
// fc2's splits are added inside the CTA (one plane for the row pass). The
// float32 pack keeps mma_stages.cuh's 3xTF32 mma.sync stage in output tiles
// of 128 rows, 64 columns wide for q/k/v and fc1 and 128 for the split
// products, through a 4-stage cp.async ring. Each LayerNorm is computed once
// per row, by the row pass that finishes the row (one CTA a row: the split
// sums, bias and residual of the preceding product), which writes the
// normalised row in the operand type; the attention output and the fc1
// activations are written in it too. The bf16 attention stages each head's
// keys and values once per 128 query rows and computes both products on the
// tensor cores; the float32 pack keeps the fp32 attention of
// block_stack_common.cuh. One persistent cooperative grid of one CTA per SM
// (up to 255 registers a thread, no spills) walks each stage's items; per
// layer seven grid-wide barriers (about 1.5 us each) separate q/k/v,
// attention, the output projection, its row pass (+ LN2), fc1 + GELU, fc2
// and its row pass (+ the next layer's LN1). The two d-wide products split
// their contraction so that every SM has work at one window (the split count
// from the window's frames alone). Several windows may share one launch:
// each window's rows are computed in the same order whatever the batch and
// the tile plan, so its result equals its batch-1 result bit for bit.

#include "mma_stages.cuh"

// Field order and types must match EncParams in ops/encoder_block_stack.py.
struct EncParams {
  const float* x;     // (B * T, d)
  const void* wqkv;   // (depth, d, 3d)
  const void* wout;   // (depth, d, d)
  const void* wfc1;   // (depth, d, hidden)
  const void* wfc2;   // (depth, hidden, d)
  const float* bqkv;  // (depth, 3d)
  const float* bout;  // (depth, d)
  const float* bfc1;  // (depth, hidden)
  const float* bfc2;  // (depth, d)
  const float* ln1s;  // (depth, d) LayerNorm scales and biases
  const float* ln1b;
  const float* ln2s;
  const float* ln2b;
  const float* sqkv;  // int8 packs: (depth, 1, 3d); else null
  const float* sout;  // (depth, 1, d)
  const float* sfc1;  // (depth, 1, hidden)
  const float* sfc2;  // (depth, hidden / d, d)
  float* y;           // (B * T, d); the running x after the first output projection
  void* xa;           // scratch (B * T, d): a LayerNorm's output, in the operand type
  void* qkv;          // scratch (B * T, 3d), operand type
  void* attn;         // scratch (B * T, d), operand type
  void* h;            // scratch (B * T, hidden), operand type
  float* partial;     // scratch (max splits x rows x d) of the split products
  int B, T, d, H, hidden, depth;
  float eps;
  int wtype;          // 0 f32, 1 bf16, 2 int8
  int sp_out, sp_fc2; // contraction splits of the output projection and fc2
  // bf16 / int8 packs: the wgmma engine's plan of q/k/v, the output
  // projection, fc1 and fc2 (enc::Plan bits, ops/ar_block_stack.gemm_plan)
  int plan_qkv, plan_out, plan_fc1, plan_fc2;
};

// The tensor maps of the wgmma engine's operands (bf16 and int8 packs): the
// rows of xa, attn and h, and the four weight stacks.
struct EncMaps {
  CUtensorMap xa, attn, h, wqkv, wout, wfc1, wfc2;
};

namespace {

constexpr int kHeadDim = 64;   // the wrapper checks
constexpr int kBM = 128;       // rows of an output tile
constexpr int kStages = 4;     // depth of the float32 packs' cp.async ring
constexpr int kRingKB = 160;   // the wgmma engine's ring (bf16 / int8 packs)

template <typename WT>
__global__ void __launch_bounds__(enc::kThreads, 1)
    encoder_kernel(EncParams p, const __grid_constant__ EncMaps maps) {
  using AT = enc::Operand<WT>;
  constexpr bool kF32 = sizeof(WT) == sizeof(float);
  extern __shared__ __align__(1024) unsigned char smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int M = p.B * p.T, d = p.d, hid = p.hidden;
  const WT* wqkv = static_cast<const WT*>(p.wqkv);
  const WT* wout = static_cast<const WT*>(p.wout);
  const WT* wfc1 = static_cast<const WT*>(p.wfc1);
  const WT* wfc2 = static_cast<const WT*>(p.wfc2);
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));
  // float32 packs: the mma.sync product (128-row tiles, 64 columns for q/k/v
  // and fc1, 128 for the split products); bf16 / int8: the wgmma engine
  auto gemm = [&](const enc::MmaGemm& g, bool wide_f32) {
    if constexpr (kF32) {
      if (wide_f32)
        enc::mma_gemm_f32<kBM, 128, kStages>(g, smem);
      else
        enc::mma_gemm_f32<kBM, 64, kStages>(g, smem);
    } else {
      enc::wg_gemm<WT, kRingKB>(g, smem);
    }
  };
  // the products of layer i: q/k/v (stage 0), the output projection (2), fc1
  // (4) and fc2 (5)
  auto product = [&](int i, int st) {
    const size_t di = static_cast<size_t>(i) * d;
    enc::MmaGemm g;
    if (st == 0)
      g = {M, 3 * d, d, p.xa, wqkv + di * 3 * d, p.sqkv ? p.sqkv + 3 * di : nullptr, d, 1,
           enc::kBias, p.bqkv + 3 * di, p.qkv, nullptr, &maps.xa, &maps.wqkv, i, p.plan_qkv};
    else if (st == 2)
      g = {M, d, d, p.attn, wout + di * d, p.sout ? p.sout + di : nullptr, d, p.sp_out,
           enc::kPartial, nullptr, nullptr, p.partial, &maps.attn, &maps.wout, i, p.plan_out};
    else if (st == 4)
      g = {M, hid, d, p.xa, wfc1 + di * hid,
           p.sfc1 ? p.sfc1 + static_cast<size_t>(i) * hid : nullptr, d, 1, enc::kGelu,
           p.bfc1 + static_cast<size_t>(i) * hid, p.h, nullptr, &maps.xa, &maps.wfc1, i,
           p.plan_fc1};
    else   // int8 scales (hid / d) x d
      g = {M, d, hid, p.h, wfc2 + di * hid,
           p.sfc2 ? p.sfc2 + static_cast<size_t>(i) * hid : nullptr, d, p.sp_fc2,
           enc::kPartial, nullptr, nullptr, p.partial, &maps.h, &maps.wfc2, i, p.plan_fc2};
    return g;
  };
  // the row pass after a split product reads one plane when it was folded
  const int rows_out = p.plan_out & enc::kFold ? 1 : p.sp_out;
  const int rows_fc2 = p.plan_fc2 & enc::kFold ? 1 : p.sp_fc2;

  // LN1 of the first layer's input rows
  enc::row_pass<AT>({M, d, nullptr, 0, nullptr, p.x, nullptr, p.ln1s, p.ln1b, p.eps, p.xa},
                    smem);
  if constexpr (!kF32) enc::wg_prefetch(product(0, 0));
  grid.sync();
  // Per layer its seven stages, walked by one loop so that the product stage
  // has one call site (inlined once: a product engine called as a function
  // would serialise its wgmma instructions)
#pragma unroll 1
  for (int i = 0; i < p.depth; ++i) {
    const float* x = i == 0 ? p.x : p.y;
    const size_t di = static_cast<size_t>(i) * d;
    const bool last = i + 1 == p.depth;
#pragma unroll 1
    for (int st = 0; st < 7; ++st) {
      if (st == 0 || st == 2 || st == 4 || st == 5) {
        gemm(product(i, st), st == 2 || st == 5);
        // the next product's weight tiles into L2, before the barrier
        if constexpr (!kF32) {
          if (st != 5)
            enc::wg_prefetch(product(i, st == 0 ? 2 : st == 2 ? 4 : 5));
          else if (!last)
            enc::wg_prefetch(product(i + 1, 0));
        }
      } else if (st == 1) {
        if constexpr (kF32) {
          bs::Attn a{};
          a.B = p.B; a.T = p.T; a.H = p.H; a.hd = kHeadDim; a.d = d;
          a.prefix = 0;
          a.q = static_cast<const float*>(p.qkv);
          a.k = a.q + d; a.v = a.q + 2 * d; a.ld = 3 * d;
          a.l2norm = 0; a.logit_scale = scale;
          a.round = 0; a.out = p.attn;
          bs::attention<float>(a, reinterpret_cast<float*>(smem));
        } else {
          enc::tc_attention<kHeadDim>({p.B, p.T, p.H, d,
                                       static_cast<const __nv_bfloat16*>(p.qkv), scale,
                                       static_cast<__nv_bfloat16*>(p.attn)}, smem);
        }
      } else if (st == 3) {
        enc::row_pass<AT>({M, d, p.partial, rows_out, p.bout + di, x, p.y, p.ln2s + di,
                           p.ln2b + di, p.eps, p.xa}, smem);
      } else {
        enc::row_pass<AT>({M, d, p.partial, rows_fc2, p.bfc2 + di, p.y, p.y,
                           last ? nullptr : p.ln1s + di + d, last ? nullptr : p.ln1b + di + d,
                           p.eps, p.xa}, smem);
      }
      if (!(last && st == 6)) grid.sync();
    }
  }
}

// dynamic shared memory of the kernel: the larger of the product's ring and
// the attention's tiles
template <typename WT>
int smem_bytes(const EncParams& p) {
  if constexpr (sizeof(WT) == sizeof(float)) {
    const int attn = bs::attn_smem_floats(p.T, kHeadDim) * static_cast<int>(sizeof(float));
    using Wide = enc::Tiles<kBM, 128, kStages>;
    using Narrow = enc::Tiles<kBM, 64, kStages>;
    const int gemm = Wide::kBytes > Narrow::kBytes ? Wide::kBytes : Narrow::kBytes;
    return attn > gemm ? attn : gemm;
  } else {
    const int attn = enc::AttnTiles<kHeadDim>::bytes(p.T);
    using R = enc::Ring<WT, kRingKB>;
    return attn > R::kBytes ? attn : R::kBytes;
  }
}

template <typename WT>
int launch(const EncParams& p, cudaStream_t stream) {
  EncMaps maps{};
  if constexpr (sizeof(WT) != sizeof(float)) {
    const int m = p.B * p.T < 64 ? 64 : p.B * p.T;   // the wrapper allocates >= 64 rows
    if (!enc::rows_map(&maps.xa, p.xa, m, p.d) || !enc::rows_map(&maps.attn, p.attn, m, p.d) ||
        !enc::rows_map(&maps.h, p.h, m, p.hidden) ||
        !enc::weight_map<WT>(&maps.wqkv, p.wqkv, p.depth, p.d, 3 * p.d) ||
        !enc::weight_map<WT>(&maps.wout, p.wout, p.depth, p.d, p.d) ||
        !enc::weight_map<WT>(&maps.wfc1, p.wfc1, p.depth, p.d, p.hidden) ||
        !enc::weight_map<WT>(&maps.wfc2, p.wfc2, p.depth, p.hidden, p.d))
      return enc::kNoTensorMap;
  }
  return bs::launch_cooperative(encoder_kernel<WT>, p, maps, (smem_bytes<WT>(p) + 3) / 4,
                                stream);
}

}  // namespace

// Plain C entry point. Returns 0 on success, a cudaError_t code,
// bs::kNotCoResident (-1) when the grid cannot be co-resident, or
// enc::kNoTensorMap (-2) when a tensor map cannot be made. It does not
// synchronise and allocates nothing.
extern "C" int artalk_encoder_block_stack(const EncParams* p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->wtype) {
    case 0: return launch<float>(*p, s);
    case 1: return launch<__nv_bfloat16>(*p, s);
    default: return launch<int8_t>(*p, s);
  }
}
