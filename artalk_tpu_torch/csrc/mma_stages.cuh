// Stages of the two block-stack kernels (encoder_block_stack.cu,
// ar_block_stack.cu): the float32 packs' matrix product on the tensor cores,
// fed by a cp.async ring with its epilogue folded in, whose first weight
// tiles a CTA may issue before it waits at a grid barrier (bf16 and int8
// packs run wgmma_gemm.cuh's engine); the row passes that add the split
// partial sums, the bias and the residual and write the next product's
// operand (the encoder's affine LayerNorm, the AR blocks' AdaLN-modulated
// one); and the bf16 attention stages of both on the tensor cores.
//
// Operands. A product's A operand is prepared once by the stage that makes
// it (a row pass, an attention stage, the fc1 epilogue) in the operand type
// of the pack: bf16 for bf16 and int8 packs (the value the reference rounds
// to), float32 for float32 packs.
// Arithmetic of the float32 product: 3xTF32, mma.sync m16n8k8: each operand
// x = hi + lo (hi the TF32 rounding of x, lo that of the rest) and a product
// is hi.hi + (lo.hi + hi.lo), the cross terms in an accumulator of their own
// so that they round against their own size (lo.lo, below 2^-22 of it, is
// dropped).
// Every output element is computed from its own row alone, in a k order
// that depends on the product's shape and the split count only, so a row's
// result does not depend on the batch or on the row tile it falls in.

#pragma once

#include "wgmma_gemm.cuh"

namespace enc {

constexpr int kNT = 4;         // n8 tiles of a warp: a warp takes 32 columns
constexpr int kQRows = 128;    // query rows of an attention item: 8 warps of 16
constexpr int kKeyChunk = 32;  // keys per step of the attention's walk

// ---------------------------------------------------------------------------
// Products of float32 packs
// ---------------------------------------------------------------------------

// Tiles of BM rows, BN (64 or 32) columns and a ring of STAGES in shared
// memory: the depth of a step kBK, row pitches (in floats) padded so that
// the fragment loads of a warp hit distinct banks, and the warps' layout:
// BN / 32 warps across, each warp kMT m16 tiles by 32 columns; when BM has
// fewer m16 tiles than there are warp rows, only the first kActiveM warp
// rows multiply.
template <int BM, int BN, int STAGES>
struct Tiles {
  static constexpr int kBM = BM;
  static constexpr int kBN = BN;
  static constexpr int kStages = STAGES;
  static constexpr int kWarpsM = kWarps / (BN / 32);
  static constexpr int kMT = BM / (16 * kWarpsM) > 0 ? BM / (16 * kWarpsM) : 1;
  static constexpr int kActiveM = BM / 16 < kWarpsM ? BM / 16 : kWarpsM;
  static constexpr int kBK = 32;
  static constexpr int kAP = kBK + 4;   // A: [BM][kAP]
  // W: [kBK][kWP]; rows 8 floats longer, so that the (k, n) fragment loads
  // of a warp (8 k rows apart by 4) fall in 32 distinct banks
  static constexpr int kWP = BN + 8;
  static constexpr int kABytes = BM * kAP * 4;
  static constexpr int kWBytes = kBK * kWP * 4;
  static constexpr int kBytes = kStages * (kABytes + kWBytes);
};

// acc += hi.hi and small += lo.hi + hi.lo over the warp's slice of
// As[BM][32] @ Ws[32][BN] (3xTF32)
template <int kMT, int kWarpsM>
__device__ __forceinline__ void mma_step(const float* as, int ap, const float* ws, int wp,
                                         float (&acc)[kMT][kNT][4],
                                         float (&small)[kMT][kNT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp % kWarpsM) * kMT * 16 + g, n0 = (warp / kWarpsM) * kNT * 8 + g;
#pragma unroll
  for (int kk = 0; kk < 32 / 8; ++kk) {
    const int c = kk * 8 + t;
    uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      split_tf32(ws[c * wp + n0 + j * 8], bh[j][0], bl[j][0]);
      split_tf32(ws[(c + 4) * wp + n0 + j * 8], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const float* ar = as + (r0 + mt * 16) * ap + c;
      uint32_t ah[4], al[4];
      split_tf32(ar[0], ah[0], al[0]);
      split_tf32(ar[8 * ap], ah[1], al[1]);
      split_tf32(ar[4], ah[2], al[2]);
      split_tf32(ar[8 * ap + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        mma_tf32(small[mt][j], al, bh[j][0], bh[j][1]);
        mma_tf32(small[mt][j], ah, bl[j][0], bl[j][1]);
        mma_tf32(acc[mt][j], ah, bh[j][0], bh[j][1]);
      }
    }
  }
}

// The items of a product, (row tile, column tile, split) with the row tile
// fastest so that the CTAs reading one weight tile run together, walked by
// the whole grid; a CTA's first item is item blockIdx.x. N must be a
// multiple of BN and K / splits of 32 (the wrappers check); operand rows
// from M on are neither loaded nor written.
template <typename T>
struct Items {
  int row_tiles, items, split_len, nk;
  __device__ explicit Items(const MmaGemm& g)
      : row_tiles((g.M + T::kBM - 1) / T::kBM), items(row_tiles * (g.N / T::kBN) * g.splits),
        split_len(g.K / g.splits), nk(g.K / g.splits / T::kBK) {}
  __device__ int m0(int item) const { return (item % row_tiles) * T::kBM; }
  __device__ int split(int item, int splits) const { return (item / row_tiles) % splits; }
  __device__ int n0(int item, int splits) const { return item / row_tiles / splits * T::kBN; }
};

// the weight tile of rows [k0, k0 + kBK) and columns [n0, n0 + BN) into ring stage `stage`
template <typename T>
__device__ __forceinline__ void load_w(const MmaGemm& g, unsigned char* smem, int stage, int k0,
                                       int n0) {
  constexpr int kChunks = T::kBN * 4 / 16;
  float* ws = reinterpret_cast<float*>(smem + T::kStages * T::kABytes) + stage * (T::kBK * T::kWP);
  const float* w = static_cast<const float*>(g.w);
  for (int c = threadIdx.x; c < T::kBK * kChunks; c += kThreads) {
    const int r = c / kChunks, e = (c % kChunks) * 4;
    cp_async16(ws + r * T::kWP + e, w + static_cast<size_t>(k0 + r) * g.N + n0 + e, true);
  }
}

// the operand tile of rows [m0, m0 + BM) and columns [k0, k0 + kBK) into
// ring stage `stage`; rows from M on are left as they are (an output row
// depends on its own operand row only, and those rows are not written), so
// a level of a few tokens issues a few copies, not BM rows of zeros
template <typename T>
__device__ __forceinline__ void load_a(const MmaGemm& g, unsigned char* smem, int stage, int m0,
                                       int k0) {
  constexpr int kChunks = T::kBK * 4 / 16;
  float* as = reinterpret_cast<float*>(smem) + stage * (T::kBM * T::kAP);
  const float* a = static_cast<const float*>(g.a);
  const int rows = g.M - m0 < T::kBM ? g.M - m0 : T::kBM;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, e = (c % kChunks) * 4;
    cp_async16(as + r * T::kAP + e, a + static_cast<size_t>(m0 + r) * g.K + k0 + e, true);
  }
}

// Weights depend on no activation: before a grid barrier, a CTA issues the
// weight tiles of the first PF (at most STAGES - 1) steps of its first item
// of the next product (one cp.async group each), so that they stream in
// while it waits; that product is then run with prefetched = true and the
// same PF.
template <int BM, int BN, int STAGES, int PF>
__device__ void prefetch_weights(const MmaGemm& g, unsigned char* smem) {
  using T = Tiles<BM, BN, STAGES>;
  static_assert(PF < STAGES, "prefetch at most the ring's first STAGES - 1 steps");
  const Items<T> it(g);
  const int item = blockIdx.x;
  if (item >= it.items) return;
  const int k_begin = it.split(item, g.splits) * it.split_len, n0 = it.n0(item, g.splits);
#pragma unroll
  for (int s = 0; s < PF; ++s) {
    if (s < it.nk) load_w<T>(g, smem, s, k_begin + s * T::kBK, n0);
    cp_async_commit();
  }
}

template <int BM, int BN, int STAGES, int PF = 0>
__device__ void mma_gemm_f32(const MmaGemm& g, unsigned char* smem, bool prefetched = false) {
  using T = Tiles<BM, BN, STAGES>;
  constexpr int kBK = T::kBK, kMT = T::kMT, kWarpsM = T::kWarpsM, kS = T::kStages;
  float* as_ring = reinterpret_cast<float*>(smem);
  float* ws_ring = reinterpret_cast<float*>(smem + kS * T::kABytes);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const bool active = warp % kWarpsM < T::kActiveM;   // this warp's rows lie in the tile
  const Items<T> it(g);

  for (int item = blockIdx.x; item < it.items; item += gridDim.x) {
    const int m0 = it.m0(item), split = it.split(item, g.splits), n0 = it.n0(item, g.splits);
    const int k_begin = split * it.split_len;
    // the weight tiles of the first PF steps were issued before the barrier
    const bool have_w = prefetched && item == blockIdx.x;

    // acc: the product; small: the 3xTF32 cross terms
    float acc[kMT][kNT][4], small[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = small[mt][j][e] = 0.0f;

#pragma unroll
    for (int s = 0; s < kS - 1; ++s) {
      if (s < it.nk) {
        if (!have_w || s >= PF) load_w<T>(g, smem, s, k_begin + s * kBK, n0);
        load_a<T>(g, smem, s, m0, k_begin + s * kBK);
      }
      cp_async_commit();
    }
    for (int kt = 0; kt < it.nk; ++kt) {
      cp_async_wait<kS - 2>();
      __syncthreads();   // step kt has landed; step kt - 1's stage is free
      const int next = kt + kS - 1;
      if (next < it.nk) {
        load_w<T>(g, smem, next % kS, k_begin + next * kBK, n0);
        load_a<T>(g, smem, next % kS, m0, k_begin + next * kBK);
      }
      cp_async_commit();
      const int st = kt % kS;
      if (active)
        mma_step<kMT, kWarpsM>(as_ring + st * (T::kBM * T::kAP), T::kAP,
                               ws_ring + st * (kBK * T::kWP), T::kWP, acc, small);
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is free for the next item
    if (!active) continue;

#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          const int row = m0 + (warp % kWarpsM) * kMT * 16 + mt * 16 + gq + hlf * 8;
          if (row >= g.M) continue;
          const int n = n0 + (warp / kWarpsM) * kNT * 8 + j * 8 + 2 * t;
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) y[e] = acc[mt][j][hlf * 2 + e] + small[mt][j][hlf * 2 + e];
          if (g.epi == kPartial) {
            store2(g.partial + (static_cast<size_t>(split) * g.M + row) * g.N + n, y[0], y[1]);
            continue;
          }
          y[0] += __ldg(g.bias + n);
          y[1] += __ldg(g.bias + n + 1);
          if (g.epi == kGelu) {
            y[0] = bs::gelu_erf(y[0]);
            y[1] = bs::gelu_erf(y[1]);
          } else if (g.epi == kGeluTanh) {
            y[0] = bs::gelu_tanh(y[0]);
            y[1] = bs::gelu_tanh(y[1]);
          }
          store2(static_cast<float*>(g.out) + static_cast<size_t>(row) * g.N + n, y[0], y[1]);
        }
  }
}

// ---------------------------------------------------------------------------
// Row pass
// ---------------------------------------------------------------------------

// sum of v over the CTA, in a fixed order (red: kWarps doubles of shared memory)
__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// One CTA per row of d <= 4 * kThreads columns, four a thread: y = resid +
// (sum of the splits' partial sums + bias) (splits 0: y = resid), written to
// out unless it is null (it may alias resid); then, unless s is null, the
// row's LayerNorm (statistics once per row) in the operand type to a. The
// LayerNorm is taken in float64 and rounded once to float32: a bf16 operand
// that rounds the other way than the reference's moves a whole row of the
// next product, so the normalised row must be as close to exact as the
// reference's float32 one (which rounds like float64 on all but a few
// millionths of the values).
struct RowPass {
  int M, d;
  const float* partial;
  int splits;
  const float* bias;
  const float* resid;
  float* out;
  const float* s;
  const float* t;
  float eps;
  void* a;
};

template <typename AT>
__device__ void row_pass(const RowPass& r, unsigned char* smem) {
  double* red = reinterpret_cast<double*>(smem);
  const int c = 4 * threadIdx.x;
  const bool act = c < r.d;
  const size_t plane = static_cast<size_t>(r.M) * r.d;
  for (int row = blockIdx.x; row < r.M; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * r.d + c;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (act) {
      for (int sp = 0; sp < r.splits; ++sp) {
        const float4 p = *reinterpret_cast<const float4*>(r.partial + sp * plane + base);
        v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
      }
      const float4 x = *reinterpret_cast<const float4*>(r.resid + base);
      if (r.splits > 0) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(r.bias + c));
        v = make_float4(x.x + (v.x + b.x), x.y + (v.y + b.y), x.z + (v.z + b.z),
                        x.w + (v.w + b.w));
      } else {
        v = x;
      }
      if (r.out != nullptr) store4(r.out + base, v);
    }
    if (r.s == nullptr) continue;
    const double vd[4] = {v.x, v.y, v.z, v.w};
    const double mean = block_sum(act ? (vd[0] + vd[1]) + (vd[2] + vd[3]) : 0.0, red) / r.d;
    double dv[4], sq = 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dv[i] = vd[i] - mean;
      sq += dv[i] * dv[i];
    }
    const double rstd = 1.0 / sqrt(block_sum(act ? sq : 0.0, red) / r.d + r.eps);
    if (act) {
      const float4 s = __ldg(reinterpret_cast<const float4*>(r.s + c));
      const float4 t = __ldg(reinterpret_cast<const float4*>(r.t + c));
      store4(static_cast<AT*>(r.a) + base,
             make_float4(static_cast<float>(dv[0] * rstd * s.x + t.x),
                         static_cast<float>(dv[1] * rstd * s.y + t.y),
                         static_cast<float>(dv[2] * rstd * s.z + t.z),
                         static_cast<float>(dv[3] * rstd * s.w + t.w)));
    }
  }
}

// The sum of a row of d floats (shared memory, d a multiple of 4, at least
// 128) in the order of torch's CUDA reduction kernel for a contiguous row
// (ATen/native/cuda/Reduce.cuh, vectorized input) run with `width` threads:
// thread x adds the float4 vectors x, x + width, ... into four sums from 0,
// combined in order; then a tree through shared memory while the offset is
// at least 32, then warp shuffles down from 16 to 1. Every thread returns
// the sum; red holds kThreads + 1 floats.
__device__ float torch_row_sum(const float* row, int d, int width, float* red) {
  const int x = threadIdx.x;
  float t = 0.0f;
  if (x < width) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    for (int idx = x; 4 * idx + 3 < d; idx += width) {
      const float4 v = reinterpret_cast<const float4*>(row)[idx];
      a0 += v.x; a1 += v.y; a2 += v.z; a3 += v.w;
    }
    t = ((a0 + a1) + a2) + a3;
  }
  if (width > 32) {
    red[x] = t;
    for (int off = width / 2; off >= 32; off >>= 1) {
      __syncthreads();
      if (x < off) {
        t = t + red[x + off];
        red[x] = t;
      }
    }
  }
  __syncthreads();
  if (x < 32)
    for (int off = 16; off > 0; off >>= 1) t = t + __shfl_down_sync(0xffffffffu, t, off);
  if (x == 0) red[kThreads] = t;
  __syncthreads();
  const float sum = red[kThreads];
  __syncthreads();   // red and the row are free again
  return sum;
}

// The AR blocks' row pass, one CTA per row of d <= 4 * kThreads columns:
// y = resid + (sum of the splits' partial sums + bias) * gate (splits 0:
// y = resid), written to out unless it is null (it may alias resid); then,
// unless s is null, the AdaLN-modulated LayerNorm LN(y) * (1 + s) + t (no
// affine; gate, s and t are rows of the AdaLN parameters, of stride ld) in
// the operand type to a. The LayerNorm is the plain version's float32
// formula as torch computes it on the card, operation by operation:
// mean = sum(y) * fl(1/d), y - mean, var = sum((y - mean)^2) * fl(1/d),
// rsqrtf(var + eps), (y - mean) * rstd, each sum in the order torch's
// reduction takes with `width` threads (torch_row_sum; the wrapper picks the
// width torch picks for pn rows, so a row's operand does not depend on the
// batch). A float64 LayerNorm, correctly rounded, differs from torch's
// float32 one in about half of the values, and its bf16 operand in about 1 %
// of the rows; a whole q/k/v or fc1 row then moves (PERF.md §6). The
// gated residual and the modulation are float32 operations in the
// reference's order, uncontracted.
struct AdaRowPass {
  int M, d;
  const float* partial;
  int splits;
  const float* bias;
  const float* resid;
  const float* gate;
  float* out;
  const float* s;
  const float* t;
  int ld;
  float eps;
  int width;
  void* a;
};

__device__ __forceinline__ float4 load4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename AT>
__device__ void ada_row_pass(const AdaRowPass& r, unsigned char* smem) {
  float* row_s = reinterpret_cast<float*>(smem);   // [d]
  float* red = row_s + 4 * kThreads;                // [kThreads + 1]
  const int c = 4 * threadIdx.x;
  const bool act = c < r.d;
  const size_t plane = static_cast<size_t>(r.M) * r.d;
  const float inv_d = __fdiv_rn(1.0f, static_cast<float>(r.d));
  for (int row = blockIdx.x; row < r.M; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * r.d + c;
    const size_t arow = static_cast<size_t>(row) * r.ld + c;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f), t = s;
    if (act && r.s != nullptr) {   // with the residual: one latency for both
      s = load4f(r.s + arow);
      t = load4f(r.t + arow);
    }
    if (act) {
      const float4 x = load4f(r.resid + base);
      if (r.splits > 0) {
        float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int sp = 0; sp < r.splits; ++sp) {
          const float4 p = load4f(r.partial + sp * plane + base);
          y[0] += p.x; y[1] += p.y; y[2] += p.z; y[3] += p.w;
        }
        const float4 b = __ldg(reinterpret_cast<const float4*>(r.bias + c));
        const float4 g = load4f(r.gate + arow);
        const float xs[4] = {x.x, x.y, x.z, x.w}, bs4[4] = {b.x, b.y, b.z, b.w},
                    gs[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = __fadd_rn(xs[i], __fmul_rn(__fadd_rn(y[i], bs4[i]), gs[i]));
      } else {
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      }
      if (r.out != nullptr) store4(r.out + base, make_float4(v[0], v[1], v[2], v[3]));
      store4(row_s + c, make_float4(v[0], v[1], v[2], v[3]));
    }
    if (r.s == nullptr) continue;
    __syncthreads();
    const float mean = __fmul_rn(torch_row_sum(row_s, r.d, r.width, red), inv_d);
    float dv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) dv[i] = __fsub_rn(v[i], mean);
    if (act)
      store4(row_s + c, make_float4(__fmul_rn(dv[0], dv[0]), __fmul_rn(dv[1], dv[1]),
                                    __fmul_rn(dv[2], dv[2]), __fmul_rn(dv[3], dv[3])));
    __syncthreads();
    const float var = __fmul_rn(torch_row_sum(row_s, r.d, r.width, red), inv_d);
    const float rstd = rsqrtf(__fadd_rn(var, r.eps));
    if (act) {
      const float ss[4] = {s.x, s.y, s.z, s.w}, ts[4] = {t.x, t.y, t.z, t.w};
      float o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = __fadd_rn(__fmul_rn(__fmul_rn(dv[i], rstd), __fadd_rn(ss[i], 1.0f)), ts[i]);
      store4(static_cast<AT*>(r.a) + base, make_float4(o[0], o[1], o[2], o[3]));
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 attention on the tensor cores
// ---------------------------------------------------------------------------

// softmax(q k^T * scale) v over the T frames of each window, q, k, v the
// bf16 (rounded) columns of the q/k/v product, the output rounded to bf16 as
// the output projection's operand. As in the reference: the logits from the
// bf16 operands in float32, p = exp(l - max l) over all keys, the sum of the
// unrounded p, and P . V from p rounded to bf16, divided by the sum.
struct TcAttn {
  int B, T, H, d;
  const __nv_bfloat16* qkv;   // (B * T, 3d)
  float scale;
  __nv_bfloat16* out;         // (B * T, d)
};

template <int HD>
struct AttnTiles {
  static constexpr int kP = HD + 8;   // row pitch (bf16), 16 bytes of padding
  static __host__ __device__ int keys(int T) { return (T + kKeyChunk - 1) / kKeyChunk * kKeyChunk; }
  static __host__ __device__ int bytes(int T) { return (kQRows + 2 * keys(T)) * kP * 2; }
};

// rows [r0, r0 + rows) of one head's HD columns (src: the head's first
// column in the window's first row; rows of ld elements) into shared memory
// rows 0 .., rows >= T zero
template <int HD>
__device__ __forceinline__ void stage_head(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           size_t ld, int r0, int rows, int T) {
  constexpr int kChunks = HD / 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, e = (c % kChunks) * 8;
    const bool in = r0 + r < T;
    cp_async16(dst + r * AttnTiles<HD>::kP + e, src + (in ? (r0 + r) * ld + e : 0), in);
  }
}

// the logits of the warp's 16 query rows (A fragments qf) against keys
// k0 .. k0 + 31 of ks
template <int HD>
__device__ __forceinline__ void logits(float (&s)[4][4], const uint32_t (&qf)[HD / 16][4],
                                       const __nv_bfloat16* ks, int k0) {
  constexpr int kP = AttnTiles<HD>::kP;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, ks + (k0 + jp * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * kP + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
    }
}

// One warp's 16 query rows (qs: the first of them, bf16, pitch HD + 8)
// against keys [0, n) of ks and vs (bf16, `keys` rows, a whole number of
// kKeyChunk, rows from n on zero), walking the keys twice (the row max, then
// p, its sum and P . V): softmax(q k^T * scale) v as the reference computes
// it, the logits from the bf16 operands in float32, p = exp(l - max l) over
// all keys, the sum of the unrounded p, and P . V from p rounded to bf16 (a
// fresh sum per key chunk, added in float32), divided by the sum. Row r's
// output goes to dst + r * ld in bf16; rows from `rows` on are not written.
template <int HD>
__device__ void attend_warp(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                            const __nv_bfloat16* vs, int keys, int n, float scale,
                            __nv_bfloat16* dst, size_t ld, int rows) {
  constexpr int kP = AttnTiles<HD>::kP;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(qf[kk], qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * kP + kk * 16 + (lane >> 4) * 8);
  float s[4][4];
  // a thread holds keys 2t, 2t + 1 of each n8 tile, in rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY};
  for (int k0 = 0; k0 < keys; k0 += kKeyChunk) {
    logits<HD>(s, qf, ks, k0);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + nt * 8 + 2 * t + (e & 1) < n) m[e >> 1] = fmaxf(m[e >> 1], s[nt][e] * scale);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
  float z[2] = {0.0f, 0.0f};
  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
  for (int k0 = 0; k0 < keys; k0 += kKeyChunk) {
    logits<HD>(s, qf, ks, k0);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = k0 + nt * 8 + 2 * t + (e & 1) < n ? expf(s[nt][e] * scale - m[e >> 1])
                                                          : 0.0f;
        z[e >> 1] += p;
        s[nt][e] = p;
      }
    // this chunk's P . V from zero, added to o in float32
    float oc[HD / 8][4];
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oc[dt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vs + (k0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kP +
                              dp * 16 + (lane >> 4) * 8);
        mma_bf16(oc[2 * dp], pf, bv[0], bv[1]);
        mma_bf16(oc[2 * dp + 1], pf, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] += oc[dt][e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    z[r] += __shfl_xor_sync(0xffffffffu, z[r], 1);
    z[r] += __shfl_xor_sync(0xffffffffu, z[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (g + r * 8 >= rows) continue;
    __nv_bfloat16* row = dst + static_cast<size_t>(g + r * 8) * ld + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      store2(row + dt * 8, o[dt][2 * r] / z[r], o[dt][2 * r + 1] / z[r]);
  }
}

// Items (window, head, block of kQRows query rows): the block's q rows and
// the head's keys and values staged once, each warp 16 query rows.
template <int HD>
__device__ void tc_attention(const TcAttn& a, unsigned char* smem) {
  using L = AttnTiles<HD>;
  constexpr int kP = L::kP;
  const int keys = L::keys(a.T);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kQRows * kP;
  __nv_bfloat16* vs = ks + keys * kP;
  const int warp = threadIdx.x >> 5;
  const int qblocks = (a.T + kQRows - 1) / kQRows;
  const int items = a.B * a.H * qblocks;
  const size_t ld = 3 * static_cast<size_t>(a.d);

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int qb = item % qblocks;
    const int h = (item / qblocks) % a.H;
    const int b = item / (qblocks * a.H);
    const __nv_bfloat16* win = a.qkv + static_cast<size_t>(b) * a.T * ld + h * HD;
    stage_head<HD>(qs, win, ld, qb * kQRows, kQRows, a.T);
    stage_head<HD>(ks, win + a.d, ld, 0, keys, a.T);
    stage_head<HD>(vs, win + 2 * a.d, ld, 0, keys, a.T);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    const int r0 = qb * kQRows + warp * 16;
    if (r0 < a.T)
      attend_warp<HD>(qs + warp * 16 * kP, ks, vs, keys, a.T, a.scale,
                      a.out + (static_cast<size_t>(b) * a.T + r0) * a.d + h * HD, a.d,
                      a.T - r0);
    __syncthreads();   // before the next item restages shared memory
  }
}

// The AR blocks' attention for bf16 and int8 packs with a bf16 cache, on the
// tensor cores: pn new query rows of each batch row against [the cache's
// prefix rows | the pn new keys], one head at a time, as
// ar_block_stack_plain computes it: q^ = l2n(q) * qscale[h] and k^ = l2n(k)
// (l2n: x / max(|x|, 1e-12) in float32), then bf16 operands as attend_warp
// takes them (the cache is bf16 already). k^ and v go to k_out / v_out in
// bf16 (by the items of query block 0). Items (batch row, head, block of
// kArQRows query rows): the head's prefix keys and values staged once by
// cp.async, the new ones normalised and rounded by a warp a row.
constexpr int kArQRows = 64;   // 4 warps of 16 query rows

struct ArAttn {
  int B, T, H, d;                 // T = pn new tokens of each batch row
  int prefix;                     // cached keys before them (start)
  const __nv_bfloat16* kc;        // (B, cache_len, d) this block's caches
  const __nv_bfloat16* vc;
  long long cache_b_stride;       // cache_len * d
  const float* qkv;               // (B * T, 3d) q | k | v, float32
  const float* qscale;            // (H)
  __nv_bfloat16* out;             // (B * T, d)
  __nv_bfloat16* k_out;           // (B * T, d)
  __nv_bfloat16* v_out;
};

// Shared memory of ar_tc_attention: the query rows, the keys and values
// (which the merge of the warps' partial sums reuses), the warps' row maxima.
template <int HD>
__host__ __device__ inline int ar_attn_kv_bytes(int keys_total) {
  const int keys = (keys_total + kKeyChunk - 1) / kKeyChunk * kKeyChunk;
  const int kv = 2 * keys * AttnTiles<HD>::kP * 2;
  const int merge = kWarps * 16 * (HD + 1) * static_cast<int>(sizeof(float));
  return kv > merge ? kv : merge;
}
template <int HD>
__host__ __device__ inline int ar_attn_bytes(int keys_total) {
  return kArQRows * AttnTiles<HD>::kP * 2 + ar_attn_kv_bytes<HD>(keys_total) +
         kWarps * 16 * static_cast<int>(sizeof(float));
}

// attend_warp for up to kArQRows query rows with the keys split between
// warps: R tiles of 16 rows, W = 8 / R (rounded down to a power of two) warps
// a tile, warp `slice` of a tile taking key chunks slice, slice + W, ...
// The arithmetic is attend_warp's: the row max over all keys first (each
// warp's, then the tile's through shared memory), p = exp(l - max) with
// that max, and the warps' sums of p and P . V (each a fresh sum per key
// chunk) added in float32 in slice order. A level of a few tokens has one
// tile: all eight warps share its keys instead of one warp walking them.
template <int HD>
__device__ void attend_split(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                             const __nv_bfloat16* vs, int keys, int n, int rows,
                             __nv_bfloat16* dst, size_t ld, unsigned char* merge_smem,
                             float* part_m /* [kWarps][16] */) {
  constexpr int kP = AttnTiles<HD>::kP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (rows + 15) / 16;
  const int per = tiles == 1 ? 8 : tiles == 2 ? 4 : 2;   // warps a tile
  const int tile = warp / per, slice = warp % per;
  const bool live = tile < tiles;
  float* part_o = reinterpret_cast<float*>(merge_smem);   // [kWarps][16][HD]
  float* part_z = part_o + kWarps * 16 * HD;              // [kWarps][16]

  uint32_t qf[HD / 16][4];
  float s[4][4];
  float m[2] = {-INFINITY, -INFINITY};
  if (live) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldsm_x4(qf[kk], qs + (tile * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kP + kk * 16 +
                          (lane >> 4) * 8);
    for (int k0 = slice * kKeyChunk; k0 < keys; k0 += per * kKeyChunk) {
      logits<HD>(s, qf, ks, k0);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nt * 8 + 2 * t + (e & 1) < n) m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
    if (t == 0) {
      part_m[warp * 16 + g] = m[0];
      part_m[warp * 16 + g + 8] = m[1];
    }
  }
  __syncthreads();
  float z[2] = {0.0f, 0.0f};
  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
  if (live) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      for (int w = 0; w < per; ++w) m[r] = fmaxf(m[r], part_m[(tile * per + w) * 16 + g + 8 * r]);
    for (int k0 = slice * kKeyChunk; k0 < keys; k0 += per * kKeyChunk) {
      logits<HD>(s, qf, ks, k0);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = k0 + nt * 8 + 2 * t + (e & 1) < n ? expf(s[nt][e] - m[e >> 1]) : 0.0f;
          z[e >> 1] += p;
          s[nt][e] = p;
        }
      float oc[HD / 8][4];
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) oc[dt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, vs + (k0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kP +
                                dp * 16 + (lane >> 4) * 8);
          mma_bf16(oc[2 * dp], pf, bv[0], bv[1]);
          mma_bf16(oc[2 * dp + 1], pf, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] += oc[dt][e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      z[r] += __shfl_xor_sync(0xffffffffu, z[r], 1);
      z[r] += __shfl_xor_sync(0xffffffffu, z[r], 2);
    }
  }
  __syncthreads();   // every warp is done with the keys and values: merge over them
  if (live) {
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part_o[(warp * 16 + g + 8 * (e >> 1)) * HD + dt * 8 + 2 * t + (e & 1)] = o[dt][e];
    if (t == 0) {
      part_z[warp * 16 + g] = z[0];
      part_z[warp * 16 + g + 8] = z[1];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tiles * 16 * HD; i += kThreads) {
    const int tl = i / (16 * HD), r = (i / HD) % 16, c = i % HD;
    if (tl * 16 + r >= rows) continue;
    float os = 0.0f, zs = 0.0f;
    for (int w = 0; w < per; ++w) {
      os += part_o[((tl * per + w) * 16 + r) * HD + c];
      zs += part_z[(tl * per + w) * 16 + r];
    }
    dst[static_cast<size_t>(tl * 16 + r) * ld + c] = __float2bfloat16_rn(os / zs);
  }
}

// A warp's rows j = j0, j0 + kWarps, ... (kRowBatch of them, those below
// `rows`) of HD float32 values (src(j): the row's first value), loaded into
// registers by load_rows, so that one latency covers the batch (and hides
// behind other issue); store_rows then L2-normalises each (x / max(|x|,
// 1e-12), times scale) if asked and writes it as bf16 to dst(j) and, unless
// out(j) is null, to out(j).
constexpr int kRowBatch = 8;

template <int HD>
struct RowBatch {
  float v[kRowBatch][HD / 32];
};

template <int HD, typename Src>
__device__ __forceinline__ void load_rows(RowBatch<HD>& rb, int j0, int rows, Src src) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kRowBatch; ++u) {
    const int j = j0 + u * kWarps;
    if (j < rows) {
      const float* p = src(j);
#pragma unroll
      for (int w = 0; w < HD / 32; ++w) rb.v[u][w] = p[lane + 32 * w];
    }
  }
}

template <int HD, typename Dst, typename Out>
__device__ __forceinline__ void store_rows(const RowBatch<HD>& rb, int j0, int rows, Dst dst,
                                           Out out, bool l2n, float scale) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kRowBatch; ++u) {
    const int j = j0 + u * kWarps;
    if (j >= rows) continue;
    float ss = 0.0f;
#pragma unroll
    for (int w = 0; w < HD / 32; ++w) ss += rb.v[u][w] * rb.v[u][w];
    const float norm = l2n ? fmaxf(sqrtf(bs::warp_sum(ss)), 1e-12f) : 1.0f;
    __nv_bfloat16* d = dst(j);
    __nv_bfloat16* o = out(j);
#pragma unroll
    for (int w = 0; w < HD / 32; ++w) {
      const __nv_bfloat16 x = __float2bfloat16_rn(l2n ? rb.v[u][w] / norm * scale : rb.v[u][w]);
      d[lane + 32 * w] = x;
      if (o != nullptr) o[lane + 32 * w] = x;
    }
  }
}

template <int HD>
__device__ void ar_tc_attention(const ArAttn& a, unsigned char* smem) {
  constexpr int kP = AttnTiles<HD>::kP;
  constexpr int kChunks = HD / 8;   // 16-byte pieces of a head's row
  const int n = a.prefix + a.T;
  const int keys = (n + kKeyChunk - 1) / kKeyChunk * kKeyChunk;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kArQRows * kP;
  __nv_bfloat16* vs = ks + keys * kP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qblocks = (a.T + kArQRows - 1) / kArQRows;
  const int items = a.B * a.H * qblocks;
  const size_t ld = 3 * static_cast<size_t>(a.d);

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int qb = item % qblocks;
    const int h = (item / qblocks) % a.H;
    const int b = item / (qblocks * a.H);
    const int col = h * HD;
    // the new keys and values (a warp a row) and the block's query rows:
    // loaded first, so that their latency hides behind the prefix's copies
    const bool writer = qb == 0;
    const float* rows0 = a.qkv + static_cast<size_t>(b) * a.T * ld + col;
    const size_t out0 = static_cast<size_t>(b) * a.T * a.d + col;
    const int q_rows = a.T - qb * kArQRows < kArQRows ? a.T - qb * kArQRows : kArQRows;
    auto k_src = [&](int j) { return rows0 + j * ld + a.d; };
    auto v_src = [&](int j) { return rows0 + j * ld + 2 * a.d; };
    auto q_src = [&](int j) { return rows0 + (qb * kArQRows + j) * ld; };
    auto k_dst = [&](int j) { return ks + (a.prefix + j) * kP; };
    auto v_dst = [&](int j) { return vs + (a.prefix + j) * kP; };
    auto q_dst = [&](int j) { return qs + j * kP; };
    auto k_out = [&](int j) {
      return writer ? a.k_out + out0 + static_cast<size_t>(j) * a.d : nullptr;
    };
    auto v_out = [&](int j) {
      return writer ? a.v_out + out0 + static_cast<size_t>(j) * a.d : nullptr;
    };
    auto none = [](int) -> __nv_bfloat16* { return nullptr; };
    RowBatch<HD> kb, vb, qr;
    load_rows<HD>(kb, warp, a.T, k_src);
    load_rows<HD>(vb, warp, a.T, v_src);
    load_rows<HD>(qr, warp, q_rows, q_src);
    // the prefix keys and values from the cache; the padding rows zero
    const __nv_bfloat16* kc = a.kc + b * a.cache_b_stride + col;
    const __nv_bfloat16* vc = a.vc + b * a.cache_b_stride + col;
    for (int c = threadIdx.x; c < a.prefix * kChunks; c += kThreads) {
      const int r = c / kChunks, e = (c % kChunks) * 8;
      cp_async16(ks + r * kP + e, kc + static_cast<size_t>(r) * a.d + e, true);
      cp_async16(vs + r * kP + e, vc + static_cast<size_t>(r) * a.d + e, true);
    }
    for (int c = threadIdx.x; c < (keys - n) * kChunks; c += kThreads) {
      const int r = n + c / kChunks, e = (c % kChunks) * 8;
      *reinterpret_cast<uint4*>(ks + r * kP + e) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(vs + r * kP + e) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
    store_rows<HD>(kb, warp, a.T, k_dst, k_out, true, 1.0f);
    store_rows<HD>(vb, warp, a.T, v_dst, v_out, false, 1.0f);
    store_rows<HD>(qr, warp, q_rows, q_dst, none, true, a.qscale[h]);
    for (int j0 = warp + kRowBatch * kWarps; j0 < a.T; j0 += kRowBatch * kWarps) {
      load_rows<HD>(kb, j0, a.T, k_src);
      load_rows<HD>(vb, j0, a.T, v_src);
      store_rows<HD>(kb, j0, a.T, k_dst, k_out, true, 1.0f);
      store_rows<HD>(vb, j0, a.T, v_dst, v_out, false, 1.0f);
    }
    for (int j = q_rows + warp; j < kArQRows; j += kWarps)
      for (int e = lane; e < HD; e += 32) qs[j * kP + e] = __float2bfloat16_rn(0.0f);
    cp_async_wait<0>();
    __syncthreads();

    attend_split<HD>(qs, ks, vs, keys, n, q_rows,
                     a.out + (static_cast<size_t>(b) * a.T + qb * kArQRows) * a.d + col, a.d,
                     reinterpret_cast<unsigned char*>(ks),
                     reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ks) +
                                              ar_attn_kv_bytes<HD>(n)));
    __syncthreads();   // before the next item restages shared memory
  }
}

}  // namespace enc
