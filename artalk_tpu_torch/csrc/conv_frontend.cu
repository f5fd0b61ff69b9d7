// The wav2vec2 conv front of the "layer" layout (XLS-R) on Hopper (sm_90a),
// bound through ctypes: the seven feature convolutions, each with its bias,
// channel LayerNorm and erf-GELU, and the grouped positional convolution with
// its bias, erf-GELU and the residual add, on bf16 values.
//
// Replaces no Pallas kernel: the JAX package leaves these convolutions to
// XLA. It replaces cuDNN's float32 convolution of bf16 values (the eager
// path's F.conv1d on float32 copies, ops/conv_frontend.conv1d) and the
// elementwise passes around it. Value for value it computes that path's
// arithmetic: each output the float32 sum of bf16 x bf16 products (exact in
// float32), rounded once to bf16; + the bf16 bias, rounded; the LayerNorm over
// the 512 channels with float32 statistics, (x - mean) * rsqrt(var + eps)
// rounded, * scale rounded, + bias rounded; erf-GELU in float32, rounded. The
// positional conv: the same sum and bias, erf-GELU, then the bf16 residual
// add. Only the order of each float32 sum differs.
//
// What bounds it on this card (H100 SXM: 989 TFLOP/s bf16 on the tensor
// cores, 3.35 TB/s): per 4-s window (64,000 samples) the six convolutions
// after the first are 19.5 GFLOP and the positional conv 3.34, so at a stream
// tick's 140 windows about 3.2 TFLOP (3.3 ms); the activations, read once and
// written once in bf16, are about 9 GB a tick (2.7 ms).
//
// What the design does about it:
// - conv0 (one input channel, k 10, stride 5: 0.13 GFLOP a window, but the
//   largest output, 12,799 x 512) is a CUDA-core kernel of its own, one warp a
//   time step, the 512 channels' LayerNorm in warp shuffles: it is bound by
//   its bf16 output and its epilogue's arithmetic.
// - conv1..conv6 are implicit GEMMs with no im2col: in the channels-last
//   layout, output step t of a conv of stride s reads rows s t .. s t + k - 1
//   of the input, so the contraction step of tap j and channels c0 .. c0 + 63
//   is a 64 x 64 box of the input viewed as (B, T / s, s, 512) at (b, t0 + j /
//   s, j % s, c0): TMA loads it straight from the activation. The weights are
//   packed once as (512, k * 512), K-major.
// - An output tile is 64 time steps by all 512 channels, two consumer
//   warpgroups of wgmma.m64n256k16 (64 x 256 float32 sums each), so the
//   LayerNorm's statistics need one exchange of 64 x 2 partial sums through
//   shared memory and no second pass over device memory.
// - A producer warp keeps a ring of 3 stages (a 64 x 64 activation box and
//   the 512 x 64 weight box, 72 KB) in flight with TMA and mbarriers; the
//   consumers keep one wgmma group in flight and release each stage as the
//   group that read it retires. CTAs are persistent over (row, time tile)
//   items, so the producer loads the next item while the consumers run the
//   epilogue.
// - The positional conv is the same GEMM per group: 16 groups of 64 channels,
//   K = 128 taps x 64 channels; a tap's box is rows t0 + j - 64 .. of the
//   projected features (TMA fills the rows outside with zeros: the padding).
//   A CTA item is 128 steps of one group, two warpgroups of m64n64k16, an
//   8-stage ring.
// No sum crosses rows, and each row's work is the same at any batch, so a
// row's result does not depend on the batch.

#include "wgmma_gemm.cuh"

// Field orders and types must match the ctypes mirrors in ops/conv_frontend.py.
struct Conv0Params {
  const __nv_bfloat16* x;     // (B, S) the z-normed audio
  const __nv_bfloat16* w;     // (512, k)
  const __nv_bfloat16* bias;  // (512) conv bias, LayerNorm scale and bias
  const __nv_bfloat16* lns;
  const __nv_bfloat16* lnb;
  __nv_bfloat16* y;           // (B, rows, 512)
  int B, S, T, rows, k, stride;
  float eps;
};

struct ConvParams {
  const __nv_bfloat16* x;     // (B, in_rows, 512), in_rows a multiple of stride
  const __nv_bfloat16* w;     // (512, k * 512): w[o][j * 512 + c]
  const __nv_bfloat16* bias;
  const __nv_bfloat16* lns;
  const __nv_bfloat16* lnb;
  __nv_bfloat16* y;           // (B, rows, 512)
  int B, in_rows, T, rows, k, stride;
  float eps;
};

struct PosParams {
  const __nv_bfloat16* x;     // (B, T, d) the projected features, also the residual
  const __nv_bfloat16* w;     // (d, k * 64): w[o][j * 64 + c], c within o's group
  const __nv_bfloat16* bias;  // (d)
  __nv_bfloat16* y;           // (B, T, d)
  int B, T, d, k;
};

struct ConvMaps {
  CUtensorMap x, w;
};

namespace {

using namespace enc;

constexpr int kC = 512;          // channels of every feature conv
constexpr int kMaxK0 = 16;       // conv0's largest kernel
constexpr int kBK = 64;          // contraction rows of a step
constexpr int kTile = 64;        // feature convs: time steps of an output tile
constexpr int kATile = kTile * kBK * 2;
constexpr int kBTile = 256 * kBK * 2;             // one warpgroup's 256 channels
constexpr int kStage = kATile + 2 * kBTile;       // 72 KB
constexpr int kStages = 3;
constexpr int kConvSmem = kStages * kStage + 256 * 4 + 2 * kStages * 8;
constexpr int kConvThreads = 288;                 // two consumer warpgroups, one producer warp
constexpr int kGroup = 64;                        // positional conv: channels of a group
constexpr int kPosTile = 128;                     // time steps of an item (64 a warpgroup)
constexpr int kPosA = kPosTile * kBK * 2;
constexpr int kPosB = kGroup * kBK * 2;
constexpr int kPosStage = kPosA + kPosB;          // 24 KB
constexpr int kPosStages = 8;
constexpr int kPosSmem = kPosStages * kPosStage + 2 * kPosStages * 8;

__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float2 load_bf16x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the channel LayerNorm's affine step and the GELU of one normalised value
__device__ __forceinline__ float norm_gelu(float d, float rstd, float s, float n) {
  float y = rb(d * rstd);
  y = rb(y * s);
  y = rb(y + n);
  return rb(bs::gelu_erf(y));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// d (64 x N float32, a warpgroup's fragment) = [d +] a . b, a (64 x 16) and
// b (16 x N) bf16 K-major tiles in shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---------------------------------------------------------------------------
// conv0: one input channel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) conv0_kernel(const __grid_constant__ Conv0Params p) {
  __shared__ float ws[kMaxK0 * kC];
  __shared__ float vb[kC], vs[kC], vn[kC];
  for (int i = threadIdx.x; i < p.k * kC; i += blockDim.x) {
    const int j = i / kC, c = i % kC;
    ws[i] = __bfloat162float(p.w[c * p.k + j]);
  }
  for (int c = threadIdx.x; c < kC; c += blockDim.x) {
    vb[c] = __bfloat162float(p.bias[c]);
    vs[c] = __bfloat162float(p.lns[c]);
    vn[c] = __bfloat162float(p.lnb[c]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const long long total = static_cast<long long>(p.B) * p.T;
  // a warp a time step; lane l holds channels 2 l + 64 q (+1), q < 8
  for (long long item = static_cast<long long>(blockIdx.x) * warps + (threadIdx.x >> 5);
       item < total; item += static_cast<long long>(gridDim.x) * warps) {
    const int b = static_cast<int>(item / p.T), t = static_cast<int>(item % p.T);
    const __nv_bfloat16* xs =
        p.x + static_cast<size_t>(b) * p.S + static_cast<size_t>(t) * p.stride;
    float xv[kMaxK0];
#pragma unroll
    for (int j = 0; j < kMaxK0; ++j) xv[j] = j < p.k ? __bfloat162float(xs[j]) : 0.0f;
    float v[16], sum = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * lane + 64 * q + e;
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxK0; ++j)
          if (j < p.k) acc = fmaf(xv[j], ws[j * kC + c], acc);
        v[2 * q + e] = rb(rb(acc) + vb[c]);
        sum += v[2 * q + e];
      }
    const float mean = bs::warp_sum(sum) * (1.0f / kC);
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      v[i] -= mean;
      sq += v[i] * v[i];
    }
    const float rstd = rsqrtf(bs::warp_sum(sq) * (1.0f / kC) + p.eps);
    __nv_bfloat16* dst = p.y + (static_cast<size_t>(b) * p.rows + t) * kC;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = 2 * lane + 64 * q;
      const float y0 = norm_gelu(v[2 * q], rstd, vs[c], vn[c]);
      const float y1 = norm_gelu(v[2 * q + 1], rstd, vs[c + 1], vn[c + 1]);
      *reinterpret_cast<uint32_t*>(dst + c) = pack_bf16(y0, y1);
    }
  }
}

// ---------------------------------------------------------------------------
// conv1 .. conv6: implicit GEMM, 64 steps x 512 channels a tile
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kConvThreads, 1)
    conv_kernel(const __grid_constant__ ConvParams p, const __grid_constant__ ConvMaps maps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + kStages * kStage);   // [2][2][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 256);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (p.T + kTile - 1) / kTile, items = p.B * tiles;
  const int nk = p.k * kC / kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);   // one arrival a consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {
    // the producer: one thread issues every load, up to kStages steps ahead
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int b = item / tiles, t0 = (item % tiles) * kTile;
        for (int ks = 0; ks < nk; ++ks) {
          mbar_wait(empty + stage, phase ^ 1);
          unsigned char* st = smem + stage * kStage;
          mbar_expect_tx(full + stage, kStage);
          const int k0 = ks * kBK, j = k0 / kC;
          tma_load_4d(st, &maps.x, full + stage, k0 % kC, j % p.stride, t0 + j / p.stride, b);
          tma_load_2d(st + kATile, &maps.w, full + stage, k0, 0);
          tma_load_2d(st + kATile + kBTile, &maps.w, full + stage, k0, 256);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes channels 256 wg .. 256 wg + 255; this
  // thread holds rows r0 and r0 + 8 of the tile, channels 8 i + 2 tq (+1)
  const int wg = warp >> 2, wq = warp & 3, gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * wq + gq;
  const bool leader = (tid & 127) == 0;
  float acc[128];
  int stage = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / tiles, t0 = (item % tiles) * kTile;
    int prev = 0;
    for (int ks = 0; ks < nk; ++ks) {
      mbar_wait(full + stage, phase);
      const unsigned char* st = smem + stage * kStage;
      const uint64_t da = sw128_desc(st), db = sw128_desc(st + kATile + wg * kBTile);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n256k16_ss(acc, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
      wgmma_commit();
      // one group in flight: the group before has read its stage
      if (ks > 0) {
        wgmma_wait<1>();
        if (leader) mbar_arrive(empty + prev);
      }
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) fence_reg(acc[i]);
    if (leader) mbar_arrive(empty + prev);

    // epilogue: the rounded sum + bias, the LayerNorm over 512 channels (the
    // two warpgroups' partial sums through shared memory), GELU, the store
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float2 bb = load_bf16x2(p.bias + 256 * wg + 8 * i + 2 * tq);
      acc[4 * i] = rb(rb(acc[4 * i]) + bb.x);
      acc[4 * i + 1] = rb(rb(acc[4 * i + 1]) + bb.y);
      acc[4 * i + 2] = rb(rb(acc[4 * i + 2]) + bb.x);
      acc[4 * i + 3] = rb(rb(acc[4 * i + 3]) + bb.y);
      s0 += acc[4 * i] + acc[4 * i + 1];
      s1 += acc[4 * i + 2] + acc[4 * i + 3];
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (tq == 0) {
      red[64 * wg + r0] = s0;
      red[64 * wg + r0 + 8] = s1;
    }
    named_sync(1, 256);
    const float m0 = (red[r0] + red[64 + r0]) * (1.0f / kC);
    const float m1 = (red[r0 + 8] + red[64 + r0 + 8]) * (1.0f / kC);
    float q0 = 0.0f, q1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[4 * i] -= m0;
      acc[4 * i + 1] -= m0;
      acc[4 * i + 2] -= m1;
      acc[4 * i + 3] -= m1;
      q0 += acc[4 * i] * acc[4 * i] + acc[4 * i + 1] * acc[4 * i + 1];
      q1 += acc[4 * i + 2] * acc[4 * i + 2] + acc[4 * i + 3] * acc[4 * i + 3];
    }
    q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
    q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
    q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
    q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
    if (tq == 0) {
      red[128 + 64 * wg + r0] = q0;
      red[128 + 64 * wg + r0 + 8] = q1;
    }
    named_sync(1, 256);
    const float rstd0 = rsqrtf((red[128 + r0] + red[192 + r0]) * (1.0f / kC) + p.eps);
    const float rstd1 = rsqrtf((red[128 + r0 + 8] + red[192 + r0 + 8]) * (1.0f / kC) + p.eps);
    const int ta = t0 + r0, tb = ta + 8;
    __nv_bfloat16* ya = p.y + (static_cast<size_t>(b) * p.rows + ta) * kC + 256 * wg + 2 * tq;
    __nv_bfloat16* yb = ya + 8 * kC;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 256 * wg + 8 * i + 2 * tq;
      const float2 sc = load_bf16x2(p.lns + c), nb = load_bf16x2(p.lnb + c);
      if (ta < p.T)
        *reinterpret_cast<uint32_t*>(ya + 8 * i) =
            pack_bf16(norm_gelu(acc[4 * i], rstd0, sc.x, nb.x),
                      norm_gelu(acc[4 * i + 1], rstd0, sc.y, nb.y));
      if (tb < p.T)
        *reinterpret_cast<uint32_t*>(yb + 8 * i) =
            pack_bf16(norm_gelu(acc[4 * i + 2], rstd1, sc.x, nb.x),
                      norm_gelu(acc[4 * i + 3], rstd1, sc.y, nb.y));
    }
  }
}

// ---------------------------------------------------------------------------
// the positional conv: per group a GEMM of 128 steps x 64 channels an item
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kConvThreads, 1)
    pos_kernel(const __grid_constant__ PosParams p, const __grid_constant__ ConvMaps maps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kPosStages * kPosStage);
  uint64_t* empty = full + kPosStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int groups = p.d / kGroup, tiles = (p.T + kPosTile - 1) / kPosTile;
  const int items = p.B * tiles * groups, pad = p.k / 2;
  if (tid == 0) {
    for (int s = 0; s < kPosStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int g = item % groups, t0 = (item / groups % tiles) * kPosTile;
        const int b = item / (groups * tiles);
        for (int j = 0; j < p.k; ++j) {
          mbar_wait(empty + stage, phase ^ 1);
          unsigned char* st = smem + stage * kPosStage;
          mbar_expect_tx(full + stage, kPosStage);
          tma_load_3d(st, &maps.x, full + stage, g * kGroup, t0 + j - pad, b);
          tma_load_2d(st + kPosA, &maps.w, full + stage, j * kGroup, g * kGroup);
          if (++stage == kPosStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3, gq = lane >> 2, tq = lane & 3;
  const int r0 = 64 * wg + 16 * wq + gq;
  const bool leader = (tid & 127) == 0;
  float acc[32];
  int stage = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int g = item % groups, t0 = (item / groups % tiles) * kPosTile;
    const int b = item / (groups * tiles);
    int prev = 0;
    for (int j = 0; j < p.k; ++j) {
      mbar_wait(full + stage, phase);
      const unsigned char* st = smem + stage * kPosStage;
      const uint64_t da = sw128_desc(st + wg * (kPosA / 2)), db = sw128_desc(st + kPosA);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss(acc, da + 2 * kk, db + 2 * kk, j > 0 || kk > 0);
      wgmma_commit();
      if (j > 0) {
        wgmma_wait<1>();
        if (leader) mbar_arrive(empty + prev);
      }
      prev = stage;
      if (++stage == kPosStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(acc[i]);
    if (leader) mbar_arrive(empty + prev);

    // the rounded sum + bias, GELU, + the residual
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + r0 + 8 * h;
      if (t >= p.T) continue;
      const size_t row = (static_cast<size_t>(b) * p.T + t) * p.d + g * kGroup + 2 * tq;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = g * kGroup + 8 * i + 2 * tq;
        const float2 bb = load_bf16x2(p.bias + c), xr = load_bf16x2(p.x + row + 8 * i);
        const float y0 = rb(bs::gelu_erf(rb(rb(acc[4 * i + 2 * h]) + bb.x)));
        const float y1 = rb(bs::gelu_erf(rb(rb(acc[4 * i + 2 * h + 1]) + bb.y)));
        *reinterpret_cast<uint32_t*>(p.y + row + 8 * i) = pack_bf16(xr.x + y0, xr.y + y1);
      }
    }
  }
}

// the activation (B, rows, 512) as (B, rows / s, s, 512), read as 64 x 1 x 64
// boxes (64 steps, one phase, 64 channels) with the 128-byte swizzle
bool input_map(CUtensorMap* map, const void* base, int B, int rows, int s) {
  const EncodeTiled fn = encode_tiled();
  const cuuint64_t dims[4] = {kC, static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(rows / s),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {kC * 2ull, static_cast<cuuint64_t>(s) * kC * 2,
                                 static_cast<cuuint64_t>(rows) * kC * 2};
  const cuuint32_t box[4] = {64, 1, kTile, 1}, one[4] = {1, 1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a K-major matrix (n, k) in bf16, read as 64-wide boxes of box_rows rows
bool kmajor_map(CUtensorMap* map, const void* base, int n, int k, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)}, one[2] = {1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the projected features (B, T, d), read as 64-channel x 128-step boxes
bool features_map(CUtensorMap* map, const void* base, int B, int T, int d) {
  const EncodeTiled fn = encode_tiled();
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(T) * d * 2};
  const cuuint32_t box[3] = {64, kPosTile, 1}, one[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

template <typename Kernel, typename Params>
int launch_persistent(Kernel kernel, const Params& p, const ConvMaps& maps, int items, int smem,
                      cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaGetLastError());
  kernel<<<items < sms ? items : sms, kConvThreads, smem, stream>>>(p, maps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, one launch each. Each returns 0 on success, a
// cudaError_t code, or enc::kNoTensorMap (-2) when a tensor map cannot be
// made. None synchronises or allocates.
extern "C" int artalk_conv0(const Conv0Params* p, void* stream) {
  const long long total = static_cast<long long>(p->B) * p->T;
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaGetLastError());
  const long long want = (total + 7) / 8;
  const int grid = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  conv0_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int artalk_conv_layer(const ConvParams* p, void* stream) {
  ConvMaps maps{};
  if (!input_map(&maps.x, p->x, p->B, p->in_rows, p->stride) ||
      !kmajor_map(&maps.w, p->w, kC, p->k * kC, 256))
    return enc::kNoTensorMap;
  const int items = p->B * ((p->T + kTile - 1) / kTile);
  return launch_persistent(conv_kernel, *p, maps, items, kConvSmem,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int artalk_pos_conv(const PosParams* p, void* stream) {
  ConvMaps maps{};
  if (!features_map(&maps.x, p->x, p->B, p->T, p->d) ||
      !kmajor_map(&maps.w, p->w, p->d, p->k * kGroup, kGroup))
    return enc::kNoTensorMap;
  const int items = p->B * ((p->T + kPosTile - 1) / kPosTile) * (p->d / kGroup);
  return launch_persistent(pos_kernel, *p, maps, items, kPosSmem,
                           static_cast<cudaStream_t>(stream));
}
