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
// included. A bf16 pack is bound by its 604 MB of weights (0.18 ms), an int8
// pack by bf16 tensor-core operations (0.125 ms), the float32 pack by 3xTF32
// (three TF32 products per product, 0.75 ms). At 199 rows a layer is 5 GFLOP
// against 25 MB of bf16 weights, so each stage is short and the grid-wide
// barriers between stages and the latency of each item count as much.
//
// What the design does about it (csrc/mma_stages.cuh): the products run
// on the tensor cores (mma.sync: bf16 for bf16 and int8 packs, whose
// reference rounds both operands to bf16; 3xTF32 for float32) in output
// tiles of 128 rows, 64 columns wide for q/k/v and fc1 (96 and 128 items at
// 199 rows, most of the 132 SMs) and 128 for the split output projection and
// fc2 (fewer re-reads of the operand from L2); the tiles stream
// through a 4-stage cp.async ring in the pack's own type (int8 tiles are
// widened to bf16 in shared memory), so a weight moves from memory once per
// window in its pack's width. Each LayerNorm is computed once per row, by the
// row pass that finishes the row (one CTA a row: the split sums, bias and
// residual of the preceding product), which writes the normalised row in the
// operand type; the attention output and the fc1 activations are written in
// it too. The bf16 attention stages each head's keys and values once per 128
// query rows and computes both products on the tensor cores; the float32
// pack keeps the fp32 attention of block_stack_common.cuh. One persistent
// cooperative grid of one CTA per SM (up to 255 registers a thread, no
// spills) walks each stage's items; per layer seven grid-wide barriers
// (about 1.5 us each) separate q/k/v, attention, the output projection, its
// row pass (+ LN2), fc1 + GELU, fc2 and its row pass (+ the next layer's
// LN1). The two d-wide products split their contraction so that every SM has
// work. Several windows may share one launch: each window's rows are
// computed in the same order whatever the batch, so its result equals its
// batch-1 result bit for bit.

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
};

namespace {

constexpr int kHeadDim = 64;   // the wrapper checks
constexpr int kBM = 128;       // rows of an output tile
constexpr int kStages = 4;     // depth of the cp.async ring

template <typename WT>
__global__ void __launch_bounds__(enc::kThreads, 1) encoder_kernel(EncParams p) {
  using AT = typename enc::Tiles<WT, kBM, 128, kStages>::A;
  constexpr bool kF32 = sizeof(WT) == sizeof(float);
  extern __shared__ __align__(16) unsigned char smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int M = p.B * p.T, d = p.d, hid = p.hidden;
  const WT* wqkv = static_cast<const WT*>(p.wqkv);
  const WT* wout = static_cast<const WT*>(p.wout);
  const WT* wfc1 = static_cast<const WT*>(p.wfc1);
  const WT* wfc2 = static_cast<const WT*>(p.wfc2);
  const float scale = 1.0f / sqrtf(static_cast<float>(kHeadDim));

  // LN1 of the first layer's input rows
  enc::row_pass<AT>({M, d, nullptr, 0, nullptr, p.x, nullptr, p.ln1s, p.ln1b, p.eps, p.xa},
                    smem);
  grid.sync();
  for (int i = 0; i < p.depth; ++i) {
    const float* x = i == 0 ? p.x : p.y;
    const size_t di = static_cast<size_t>(i) * d;

    enc::mma_gemm<WT, kBM, 64, kStages>({M, 3 * d, d, p.xa, wqkv + di * 3 * d,
                       p.sqkv ? p.sqkv + 3 * di : nullptr, d, 1, enc::kBias, p.bqkv + 3 * di,
                       p.qkv, nullptr}, smem);
    grid.sync();

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
    grid.sync();

    enc::mma_gemm<WT, kBM, 128, kStages>({M, d, d, p.attn, wout + di * d,
                                          p.sout ? p.sout + di : nullptr, d, p.sp_out,
                                          enc::kPartial, nullptr, nullptr, p.partial}, smem);
    grid.sync();
    enc::row_pass<AT>({M, d, p.partial, p.sp_out, p.bout + di, x, p.y, p.ln2s + di,
                       p.ln2b + di, p.eps, p.xa}, smem);
    grid.sync();

    enc::mma_gemm<WT, kBM, 64, kStages>({M, hid, d, p.xa, wfc1 + di * hid,
                       p.sfc1 ? p.sfc1 + static_cast<size_t>(i) * hid : nullptr, d, 1,
                       enc::kGelu, p.bfc1 + static_cast<size_t>(i) * hid, p.h, nullptr}, smem);
    grid.sync();
    enc::mma_gemm<WT, kBM, 128, kStages>({M, d, hid, p.h, wfc2 + di * hid,
                       p.sfc2 ? p.sfc2 + static_cast<size_t>(i) * hid : nullptr,  // (hid / d) x d
                       d, p.sp_fc2, enc::kPartial, nullptr, nullptr, p.partial}, smem);
    grid.sync();
    const bool last = i + 1 == p.depth;
    enc::row_pass<AT>({M, d, p.partial, p.sp_fc2, p.bfc2 + di, p.y, p.y,
                       last ? nullptr : p.ln1s + di + d, last ? nullptr : p.ln1b + di + d,
                       p.eps, p.xa}, smem);
    if (!last) grid.sync();
  }
}

// dynamic shared memory of the kernel: the larger of the product's ring and
// the attention's tiles
template <typename WT>
int smem_bytes(const EncParams& p) {
  const int attn = sizeof(WT) == sizeof(float)
                       ? bs::attn_smem_floats(p.T, kHeadDim) * static_cast<int>(sizeof(float))
                       : enc::AttnTiles<kHeadDim>::bytes(p.T);
  using Wide = enc::Tiles<WT, kBM, 128, kStages>;
  using Narrow = enc::Tiles<WT, kBM, 64, kStages>;
  const int gemm = Wide::kBytes > Narrow::kBytes ? Wide::kBytes : Narrow::kBytes;
  return attn > gemm ? attn : gemm;
}

template <typename WT>
int launch(const EncParams& p, cudaStream_t stream) {
  return bs::launch_cooperative(encoder_kernel<WT>, p, (smem_bytes<WT>(p) + 3) / 4, stream);
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
