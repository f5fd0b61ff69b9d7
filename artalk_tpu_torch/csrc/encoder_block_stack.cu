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
// What bounds it on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32 without
// tensor cores, 989 TFLOP/s bf16 with them): 24 layers x 12,582,912 = 302 M
// weights and about 124 GFLOP per 199-frame window, attention included. The
// fp32 pack is bound by fp32 FMA (1.85 ms); a bf16 pack by its 604 MB of
// weights (0.18 ms); an int8 pack by bf16 tensor-core operations (0.125 ms),
// which this kernel, computing on CUDA cores, does not reach.
//
// What the design does about it: one launch replaces the 24 x ~15 launches
// of the plain version. A persistent cooperative grid hands out the output
// tiles of each stage (the two d-wide products also split along the
// contraction, to give every SM work), so each weight is streamed once per
// window while the 199 x 4096 fp32 intermediates (3.3 MB) stay in L2.
// Grid-wide barriers separate q/k/v (LN1 folded into its input), attention,
// output projection + residual, fc1 (LN2 folded in) + GELU, and fc2 +
// residual, plus one before the reduction of each split product. Several windows may share one launch: each window's rows are
// computed in the same order whatever the batch, so its result equals its
// batch-1 result bit for bit.

#include "block_stack_common.cuh"

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
  float* qkv;         // scratch (B * T, 3d)
  float* attn;        // scratch (B * T, d)
  float* h;           // scratch (B * T, hidden)
  float* partial;     // scratch (max splits x rows x N) of the split products
  int B, T, d, H, hidden, depth;
  float eps;
  int wtype;          // 0 f32, 1 bf16, 2 int8
  int sp_qkv, sp_out, sp_fc1, sp_fc2;  // contraction splits of the four products
};

namespace {

using namespace bs;


template <typename WT>
__global__ void __launch_bounds__(kThreads, 2) encoder_kernel(EncParams p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int M = p.B * p.T, d = p.d, hid = p.hidden, hd = d / p.H;
  const int rnd = sizeof(WT) != sizeof(float);
  const WT* wqkv = static_cast<const WT*>(p.wqkv);
  const WT* wout = static_cast<const WT*>(p.wout);
  const WT* wfc1 = static_cast<const WT*>(p.wfc1);
  const WT* wfc2 = static_cast<const WT*>(p.wfc2);

  for (int i = 0; i < p.depth; ++i) {
    const float* x = i == 0 ? p.x : p.y;

    Gemm g{};
    g.M = M; g.N = 3 * d; g.K = d;
    g.a = x; g.lda = d;
    g.ln = 1; g.eps = p.eps; g.s = p.ln1s + static_cast<size_t>(i) * d;
    g.t = p.ln1b + static_cast<size_t>(i) * d; g.st_ld = 0; g.s_add = 0.0f;
    g.round_a = rnd;
    g.w = wqkv + static_cast<size_t>(i) * d * 3 * d;
    g.bias = p.bqkv + static_cast<size_t>(i) * 3 * d;
    g.scales = p.sqkv ? p.sqkv + static_cast<size_t>(i) * 3 * d : nullptr;
    g.scale_chunk = d;
    g.epi = kStore; g.out = p.qkv; g.ldo = 3 * d;
    g.splits = p.sp_qkv; g.partial = p.partial;
    gemm<WT>(g, smem, grid);

    Attn a{};
    a.B = p.B; a.T = p.T; a.H = p.H; a.hd = hd; a.d = d;
    a.prefix = 0;
    a.q = p.qkv; a.k = p.qkv + d; a.v = p.qkv + 2 * d; a.ld = 3 * d;
    a.l2norm = 0; a.logit_scale = 1.0f / sqrtf(static_cast<float>(hd));
    a.round = rnd; a.out = p.attn;
    attention<float>(a, smem);
    grid.sync();

    g = Gemm{};
    g.M = M; g.N = d; g.K = d;
    g.a = p.attn; g.lda = d; g.round_a = rnd;
    g.w = wout + static_cast<size_t>(i) * d * d;
    g.bias = p.bout + static_cast<size_t>(i) * d;
    g.scales = p.sout ? p.sout + static_cast<size_t>(i) * d : nullptr;
    g.scale_chunk = d;
    g.epi = kResidual; g.out = p.y; g.ldo = d;
    g.resid = x; g.ld_resid = d;
    g.splits = p.sp_out; g.partial = p.partial;
    gemm<WT>(g, smem, grid);

    g = Gemm{};
    g.M = M; g.N = hid; g.K = d;
    g.a = p.y; g.lda = d;
    g.ln = 1; g.eps = p.eps; g.s = p.ln2s + static_cast<size_t>(i) * d;
    g.t = p.ln2b + static_cast<size_t>(i) * d; g.st_ld = 0; g.s_add = 0.0f;
    g.round_a = rnd;
    g.w = wfc1 + static_cast<size_t>(i) * d * hid;
    g.bias = p.bfc1 + static_cast<size_t>(i) * hid;
    g.scales = p.sfc1 ? p.sfc1 + static_cast<size_t>(i) * hid : nullptr;
    g.scale_chunk = d;
    g.epi = kGeluErf; g.out = p.h; g.ldo = hid;
    g.splits = p.sp_fc1; g.partial = p.partial;
    gemm<WT>(g, smem, grid);

    g = Gemm{};
    g.M = M; g.N = d; g.K = hid;
    g.a = p.h; g.lda = hid; g.round_a = rnd;
    g.w = wfc2 + static_cast<size_t>(i) * hid * d;
    g.bias = p.bfc2 + static_cast<size_t>(i) * d;
    g.scales = p.sfc2 ? p.sfc2 + static_cast<size_t>(i) * hid : nullptr;  // (hid / d) x d
    g.scale_chunk = d;
    g.epi = kResidual; g.out = p.y; g.ldo = d;
    g.resid = p.y; g.ld_resid = d;
    g.splits = p.sp_fc2; g.partial = p.partial;
    gemm<WT>(g, smem, grid, i + 1 == p.depth);
  }
}

template <typename WT>
int launch(const EncParams& p, cudaStream_t stream) {
  const int attn = attn_smem_floats(p.T, p.d / p.H);
  const int smem = attn > gemm_smem_floats() ? attn : gemm_smem_floats();
  return launch_cooperative(encoder_kernel<WT>, p, smem, stream);
}

}  // namespace

// Plain C entry point. Returns 0 on success, a cudaError_t code, or
// bs::kNotCoResident (-1) when the grid cannot be co-resident. It does not
// synchronise and allocates nothing.
extern "C" int artalk_encoder_block_stack(const EncParams* p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->wtype) {
    case 0: return launch<float>(*p, s);
    case 1: return launch<__nv_bfloat16>(*p, s);
    default: return launch<int8_t>(*p, s);
  }
}
