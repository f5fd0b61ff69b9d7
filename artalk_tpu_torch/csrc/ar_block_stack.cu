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
// What bounds it on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32 without
// tensor cores): the weights, 12 blocks x 7,077,888 = 84.9 M, are read once
// per call: 340 MB in fp32 (101 us), 170 MB in bf16, 85 MB in int8, all more
// than the 50 MB L2. The products cost 2 x 84.9 M x pn FLOP, so the fp32 pack
// is bound by fp32 FMA at pn = 50 and 100 (127 and 254 us), and by bytes below.
//
// What the design does about it: one launch replaces the 12 x ~25 small
// launches of the plain version. A persistent cooperative grid hands out the
// output tiles of each stage, split along the contraction where a level has
// too few tokens to give every SM work (the split counts come from the
// wrapper), so the CTAs together stream each weight once per call while the
// activations stay in an L2-resident scratch. Grid-wide barriers separate q/k/v
// (with LN1 folded into its input), attention, proj + residual, fc1 (with LN2
// folded in) + GELU, and fc2 + residual, plus one before the reduction of each
// split product. The Pallas kernel's (d, TW) tile stream, its padding of pn
// to 16 rows and its batch tiling were Mosaic/VMEM artefacts and are gone:
// any batch runs in one launch, and each batch row's result does not depend
// on the others (every row is computed in the same order whatever B is).

#include "block_stack_common.cuh"

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
  float* feats;         // (B * pn, d); the running x after the first proj
  void* k_new;          // (depth, B, pn, d)
  void* v_new;
  float* qkv;           // scratch (B * pn, 3d)
  float* attn;          // scratch (B * pn, d)
  float* h;             // scratch (B * pn, hidden)
  float* partial;       // scratch (max splits x rows x N) of the split products
  int B, pn, d, H, hidden, depth, cache_len, start;
  int wtype, ctype;     // 0 f32, 1 bf16, 2 int8 / 0 f32, 1 bf16
  int sp_qkv, sp_proj, sp_fc1, sp_fc2;  // contraction splits of the four products
};

namespace {

using namespace bs;


template <typename WT, typename CT>
__global__ void __launch_bounds__(kThreads, 2) ar_kernel(ArParams p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int M = p.B * p.pn, d = p.d, hid = p.hidden;
  const int rnd = sizeof(WT) != sizeof(float);
  const WT* wqkv = static_cast<const WT*>(p.wqkv);
  const WT* wproj = static_cast<const WT*>(p.wproj);
  const WT* wfc1 = static_cast<const WT*>(p.wfc1);
  const WT* wfc2 = static_cast<const WT*>(p.wfc2);

  for (int i = 0; i < p.depth; ++i) {
    const float* x = i == 0 ? p.x : p.feats;
    const float* ada = p.ada + static_cast<size_t>(i) * M * 6 * d;

    Gemm g{};
    g.M = M; g.N = 3 * d; g.K = d;
    g.a = x; g.lda = d;
    g.ln = 1; g.eps = 1e-6f; g.s = ada + 2 * d; g.t = ada + 4 * d; g.st_ld = 6 * d; g.s_add = 1.0f;
    g.round_a = rnd;
    g.w = wqkv + static_cast<size_t>(i) * d * 3 * d;
    g.bias = p.bqkv + static_cast<size_t>(i) * 3 * d;
    g.scales = p.sqkv ? p.sqkv + static_cast<size_t>(i) * 3 * d : nullptr;
    g.scale_chunk = d;
    g.epi = kStore; g.out = p.qkv; g.ldo = 3 * d;
    g.splits = p.sp_qkv; g.partial = p.partial;
    gemm<WT>(g, smem, grid);

    Attn a{};
    a.B = p.B; a.T = p.pn; a.H = p.H; a.hd = d / p.H; a.d = d;
    a.prefix = p.start;
    const size_t cache_block = static_cast<size_t>(i) * p.B * p.cache_len * d;
    a.kc = static_cast<const CT*>(p.kc) + cache_block;
    a.vc = static_cast<const CT*>(p.vc) + cache_block;
    a.cache_b_stride = static_cast<long long>(p.cache_len) * d;
    a.q = p.qkv; a.k = p.qkv + d; a.v = p.qkv + 2 * d; a.ld = 3 * d;
    a.l2norm = 1; a.qscale = p.qscale + i * p.H; a.logit_scale = 1.0f;
    a.round = rnd; a.out = p.attn;
    const size_t new_block = static_cast<size_t>(i) * M * d;
    a.k_out = static_cast<CT*>(p.k_new) + new_block;
    a.v_out = static_cast<CT*>(p.v_new) + new_block;
    attention<CT>(a, smem);
    grid.sync();

    g = Gemm{};
    g.M = M; g.N = d; g.K = d;
    g.a = p.attn; g.lda = d; g.round_a = rnd;
    g.w = wproj + static_cast<size_t>(i) * d * d;
    g.bias = p.bproj + static_cast<size_t>(i) * d;
    g.scales = p.sproj ? p.sproj + static_cast<size_t>(i) * d : nullptr;
    g.scale_chunk = d;
    g.epi = kResidual; g.out = p.feats; g.ldo = d;
    g.resid = x; g.ld_resid = d; g.gate = ada; g.ld_gate = 6 * d;
    g.splits = p.sp_proj; g.partial = p.partial;
    gemm<WT>(g, smem, grid);

    g = Gemm{};
    g.M = M; g.N = hid; g.K = d;
    g.a = p.feats; g.lda = d;
    g.ln = 1; g.eps = 1e-6f; g.s = ada + 3 * d; g.t = ada + 5 * d; g.st_ld = 6 * d; g.s_add = 1.0f;
    g.round_a = rnd;
    g.w = wfc1 + static_cast<size_t>(i) * d * hid;
    g.bias = p.bfc1 + static_cast<size_t>(i) * hid;
    g.scales = p.sfc1 ? p.sfc1 + static_cast<size_t>(i) * hid : nullptr;
    g.scale_chunk = d;
    g.epi = kGeluTanh; g.out = p.h; g.ldo = hid;
    g.splits = p.sp_fc1; g.partial = p.partial;
    gemm<WT>(g, smem, grid);

    g = Gemm{};
    g.M = M; g.N = d; g.K = hid;
    g.a = p.h; g.lda = hid; g.round_a = rnd;
    g.w = wfc2 + static_cast<size_t>(i) * hid * d;
    g.bias = p.bfc2 + static_cast<size_t>(i) * d;
    g.scales = p.sfc2 ? p.sfc2 + static_cast<size_t>(i) * hid : nullptr;  // (hid / d) x d
    g.scale_chunk = d;
    g.epi = kResidual; g.out = p.feats; g.ldo = d;
    g.resid = p.feats; g.ld_resid = d; g.gate = ada + d; g.ld_gate = 6 * d;
    g.splits = p.sp_fc2; g.partial = p.partial;
    gemm<WT>(g, smem, grid, i + 1 == p.depth);
  }
}

template <typename WT, typename CT>
int launch(const ArParams& p, cudaStream_t stream) {
  const int attn = attn_smem_floats(p.start + p.pn, p.d / p.H);
  const int smem = attn > gemm_smem_floats() ? attn : gemm_smem_floats();
  return launch_cooperative(ar_kernel<WT, CT>, p, smem, stream);
}

template <typename WT>
int dispatch_cache(const ArParams& p, cudaStream_t stream) {
  return p.ctype == 0 ? launch<WT, float>(p, stream) : launch<WT, __nv_bfloat16>(p, stream);
}

}  // namespace

// Plain C entry point. Returns 0 on success, a cudaError_t code, or
// bs::kNotCoResident (-1) when the grid cannot be co-resident. It does not
// synchronise and allocates nothing.
extern "C" int artalk_ar_block_stack(const ArParams* p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->wtype) {
    case 0: return dispatch_cache<float>(*p, s);
    case 1: return dispatch_cache<__nv_bfloat16>(*p, s);
    default: return dispatch_cache<int8_t>(*p, s);
  }
}
