// Tensor-core stages of the encoder block stack (encoder_block_stack.cu): a
// matrix product fed by a cp.async ring with its epilogue folded in, a row
// pass that adds the split partial sums, the bias and the residual and
// writes the LayerNorm of the row as the next product's operand, and a
// bf16 attention stage. The AR stack keeps the CUDA-core stages of
// block_stack_common.cuh; this header is the encoder's own.
//
// Operands. A product's A operand is prepared once by the stage that makes
// it (the row pass, the attention, the q/k/v and fc1 epilogues) in the
// operand type of the pack: bf16 for bf16 and int8 packs (the value the
// reference rounds to), float32 for float32 packs. Weights stay in the
// pack's type in shared memory; int8 tiles are widened to bf16 there, which
// is exact.
// Arithmetic:
//   bf16 / int8: mma.sync m16n8k16 bf16 with a float32 accumulator; for int8
//     one accumulator per 1024-deep scale chunk, scaled and added in order;
//   float32: 3xTF32, mma.sync m16n8k8: each operand x = hi + lo (hi the TF32
//     rounding of x, lo that of the rest) and a product is hi.hi + (lo.hi +
//     hi.lo), the cross terms in an accumulator of their own so that they
//     round against their own size (lo.lo, below 2^-22 of it, is dropped).
// Every output element is computed from its own row alone, in a k order
// that depends on the product's shape and the split count only, so a
// window's result does not depend on the batch.

#pragma once

#include <type_traits>

#include "block_stack_common.cuh"
#include "mma_ptx.cuh"

namespace enc {

using namespace ptx;

constexpr int kThreads = bs::kThreads;
constexpr int kWarps = bs::kWarps;
constexpr int kBM = 128;       // rows of an output tile
constexpr int kNT = 4;         // n8 tiles of a warp: a warp takes 32 columns
constexpr int kStages = 4;     // depth of the cp.async ring
constexpr int kQRows = 128;    // query rows of an attention item: 8 warps of 16
constexpr int kKeyChunk = 32;  // keys per step of the attention's walk

enum Epi { kBias = 0, kGelu = 1, kPartial = 2 };

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// ---------------------------------------------------------------------------
// Products
// ---------------------------------------------------------------------------

// Tiles of a pack type WT and a tile width BN (128 or 64) in shared memory:
// the operand type A, the depth of a step kBK, row pitches (in elements)
// padded by 16 bytes so that the fragment loads of a warp hit distinct
// banks, and the warps' layout: BN / 32 warps across, each warp kMT m16
// tiles by 32 columns.
template <typename WT, int BN>
struct Tiles {
  using A = typename std::conditional<sizeof(WT) == 4, float, __nv_bfloat16>::type;
  static constexpr int kWarpsM = kWarps / (BN / 32);
  static constexpr int kMT = kBM / (16 * kWarpsM);
  static constexpr int kBK = sizeof(WT) == 4 ? 32 : 64;
  static constexpr int kAP = kBK + 16 / static_cast<int>(sizeof(A));   // A: [kBM][kAP]
  // W: [kBK][kWP] in WT; float32 rows 8 floats longer, so that the (k, n)
  // fragment loads of a warp (8 k rows apart by 4) fall in 32 distinct banks
  static constexpr int kWP = BN + (sizeof(WT) == 4 ? 8 : 16 / static_cast<int>(sizeof(WT)));
  static constexpr int kCP = BN + 8;                 // int8: widened W, [kBK][kCP] bf16
  static constexpr int kABytes = kBM * kAP * static_cast<int>(sizeof(A));
  static constexpr int kWBytes = kBK * kWP * static_cast<int>(sizeof(WT));
  static constexpr int kConvBytes = sizeof(WT) == 1 ? kBK * kCP * 2 : 0;
  static constexpr int kBytes = kStages * (kABytes + kWBytes) + kConvBytes;
};

// out = epi(A[M, K] @ W[K, N] + bias) for A and W of the pack's operand and
// weight types; with splits > 1 (kPartial) the float32 partial sums of each
// split go to partial[split][M][N] for the row pass to add. An int8 split
// lies within one scale chunk (the wrapper's splits see to it), so its sum
// is scaled once, at the end.
struct MmaGemm {
  int M, N, K;
  const void* a;        // (M, K) operand rows, row stride K
  const void* w;        // (K, N) in the pack's type
  const float* scales;  // int8 packs: (K / chunk, N); else unused
  int chunk;
  int splits;
  int epi;
  const float* bias;    // (N), kBias and kGelu
  void* out;            // (M, N) in the operand type, kBias and kGelu
  float* partial;       // kPartial
};

// acc += the warp's (16 kMT) x 32 slice of As[kBM][64] @ Ws[64][BN] (bf16);
// warp w takes rows (w % kWarpsM) 16 kMT and columns (w / kWarpsM) 32
template <int kMT, int kWarpsM>
__device__ __forceinline__ void mma_step(const __nv_bfloat16* as, int ap,
                                         const __nv_bfloat16* ws, int wp,
                                         float (&acc)[kMT][kNT][4], float (&)[kMT][kNT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (warp % kWarpsM) * kMT * 16, c0 = (warp / kWarpsM) * kNT * 8;
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk) {
    uint32_t a[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
      ldsm_x4(a[mt], as + (r0 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ap + kk * 16 +
                         (lane >> 4) * 8);
#pragma unroll
    for (int dp = 0; dp < kNT / 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, ws + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * wp + c0 +
                           dp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        mma_bf16(acc[mt][2 * dp], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * dp + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// acc += hi.hi and small += lo.hi + hi.lo over the warp's slice of
// As[kBM][32] @ Ws[32][BN] (3xTF32)
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

// int8 tile [kBK][kWP] -> bf16 [kBK][kCP], four values a thread at a time
template <int BN>
__device__ __forceinline__ void widen_int8(const int8_t* src, __nv_bfloat16* dst) {
  using T = Tiles<int8_t, BN>;
  for (int i = threadIdx.x; i < T::kBK * BN / 4; i += kThreads) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    const char4 v = *reinterpret_cast<const char4*>(src + r * T::kWP + c);
    uint2 o;
    o.x = pack_bf16(static_cast<float>(v.x), static_cast<float>(v.y));
    o.y = pack_bf16(static_cast<float>(v.z), static_cast<float>(v.w));
    *reinterpret_cast<uint2*>(dst + r * T::kCP + c) = o;
  }
}

// The items of a product, (row tile, column tile, split) with the row tile
// fastest so that the CTAs reading one weight tile run together, walked by
// the whole grid. N must be a multiple of BN and K / splits of 64 (the
// wrapper checks); rows >= M read as 0 and are not written.
template <typename WT, int BN>
__device__ void mma_gemm(const MmaGemm& g, unsigned char* smem) {
  using T = Tiles<WT, BN>;
  using AT = typename T::A;
  constexpr bool kInt8 = sizeof(WT) == 1;
  constexpr int kBK = T::kBK, kBN = BN, kMT = T::kMT, kWarpsM = T::kWarpsM;
  constexpr int kAChunks = kBK * static_cast<int>(sizeof(AT)) / 16;   // per row
  constexpr int kWChunks = kBN * static_cast<int>(sizeof(WT)) / 16;
  AT* as_ring = reinterpret_cast<AT*>(smem);
  WT* ws_ring = reinterpret_cast<WT*>(smem + kStages * T::kABytes);
  __nv_bfloat16* wconv = reinterpret_cast<__nv_bfloat16*>(smem + kStages * (T::kABytes +
                                                                             T::kWBytes));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int row_tiles = (g.M + kBM - 1) / kBM;
  const int items = row_tiles * (g.N / kBN) * g.splits;
  const int split_len = g.K / g.splits;
  const int nk = split_len / kBK;
  const AT* a = static_cast<const AT*>(g.a);
  const WT* w = static_cast<const WT*>(g.w);

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int m0 = (item % row_tiles) * kBM;
    const int rest = item / row_tiles;
    const int split = rest % g.splits;
    const int n0 = (rest / g.splits) * kBN;
    const int k_begin = split * split_len;

    auto load = [&](int stage, int k0) {
      AT* as = as_ring + stage * (kBM * T::kAP);
      for (int c = tid; c < kBM * kAChunks; c += kThreads) {
        const int r = c / kAChunks, e = (c % kAChunks) * (16 / static_cast<int>(sizeof(AT)));
        const bool in = m0 + r < g.M;
        cp_async16(as + r * T::kAP + e, a + (in ? static_cast<size_t>(m0 + r) * g.K + k0 + e : 0),
                   in);
      }
      WT* ws = ws_ring + stage * (kBK * T::kWP);
      for (int c = tid; c < kBK * kWChunks; c += kThreads) {
        const int r = c / kWChunks, e = (c % kWChunks) * (16 / static_cast<int>(sizeof(WT)));
        cp_async16(ws + r * T::kWP + e, w + static_cast<size_t>(k0 + r) * g.N + n0 + e, true);
      }
    };

    // acc: the product; small: the 3xTF32 cross terms (float32 packs)
    float acc[kMT][kNT][4], small[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = small[mt][j][e] = 0.0f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load(s, k_begin + s * kBK);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // step kt has landed; step kt - 1's stage is free
      const int next = kt + kStages - 1;
      if (next < nk) load(next % kStages, k_begin + next * kBK);
      cp_async_commit();
      const int st = kt % kStages;
      const AT* as = as_ring + st * (kBM * T::kAP);
      const WT* ws = ws_ring + st * (kBK * T::kWP);
      if constexpr (sizeof(WT) == sizeof(float)) {
        mma_step<kMT, kWarpsM>(as, T::kAP, ws, T::kWP, acc, small);
      } else {
        // bf16 / int8: each 64-deep step's sum from zero, added to the
        // running sum in float32: accumulated in the tensor cores across
        // the whole contraction, the sum rounds differently enough from a
        // float32 one to flip more bf16 roundings downstream (PERF.md, PR 7)
        float part[kMT][kNT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.0f;
        if constexpr (kInt8) {
          widen_int8<BN>(reinterpret_cast<const int8_t*>(ws), wconv);
          __syncthreads();
          mma_step<kMT, kWarpsM>(as, T::kAP, wconv, T::kCP, part, small);
        } else {
          mma_step<kMT, kWarpsM>(as, T::kAP, ws, T::kWP, part, small);
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is free for the next item

    const float* sc = kInt8 ? g.scales + static_cast<size_t>(k_begin / g.chunk) * g.N : nullptr;
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
          for (int e = 0; e < 2; ++e) {
            const int i = hlf * 2 + e;
            if constexpr (kInt8)
              y[e] = acc[mt][j][i] * __ldg(sc + n + e);
            else if constexpr (sizeof(WT) == sizeof(float))
              y[e] = acc[mt][j][i] + small[mt][j][i];
            else
              y[e] = acc[mt][j][i];
          }
          if (g.epi == kPartial) {
            store2(g.partial + (static_cast<size_t>(split) * g.M + row) * g.N + n, y[0], y[1]);
          } else {
            y[0] += __ldg(g.bias + n);
            y[1] += __ldg(g.bias + n + 1);
            if (g.epi == kGelu) {
              y[0] = bs::gelu_erf(y[0]);
              y[1] = bs::gelu_erf(y[1]);
            }
            store2(static_cast<AT*>(g.out) + static_cast<size_t>(row) * g.N + n, y[0], y[1]);
          }
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

// Items (window, head, block of kQRows query rows): the block's q rows and
// the head's keys and values staged once, each warp 16 query rows walking
// the keys twice (the row max, then p, its sum and P . V).
template <int HD>
__device__ void tc_attention(const TcAttn& a, unsigned char* smem) {
  using L = AttnTiles<HD>;
  constexpr int kP = L::kP;
  const int keys = L::keys(a.T);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kQRows * kP;
  __nv_bfloat16* vs = ks + keys * kP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
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

    const int r0 = warp * 16;
    if (qb * kQRows + r0 < a.T) {
      uint32_t qf[HD / 16][4];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldsm_x4(qf[kk], qs + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kP + kk * 16 +
                            (lane >> 4) * 8);
      float s[4][4];
      // a thread holds keys 2t, 2t + 1 of each n8 tile, in rows g and g + 8
      float m[2] = {-INFINITY, -INFINITY};
      for (int k0 = 0; k0 < keys; k0 += kKeyChunk) {
        logits<HD>(s, qf, ks, k0);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + nt * 8 + 2 * t + (e & 1) < a.T)
              m[e >> 1] = fmaxf(m[e >> 1], s[nt][e] * a.scale);
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
            const float p = k0 + nt * 8 + 2 * t + (e & 1) < a.T
                                ? expf(s[nt][e] * a.scale - m[e >> 1]) : 0.0f;
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
        const int row = qb * kQRows + r0 + g + r * 8;
        if (row >= a.T) continue;
        __nv_bfloat16* dst = a.out + (static_cast<size_t>(b) * a.T + row) * a.d + h * HD + 2 * t;
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt)
          store2(dst + dt * 8, o[dt][2 * r] / z[r], o[dt][2 * r + 1] / z[r]);
      }
    }
    __syncthreads();   // before the next item restages shared memory
  }
}

}  // namespace enc
