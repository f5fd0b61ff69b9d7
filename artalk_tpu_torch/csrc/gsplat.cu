// 32-channel gaussian splat compositing for Hopper (sm_90a), bound through ctypes.
//
// Replaces the Pallas TPU kernel artalk_tpu/ops/gsplat.py:_splat_kernel
// (launched by rasterize_gaussians() at its pl.pallas_call). The instance
// lists come from the plain-torch prepass (ops/gsplat.py:_build_instances):
// for each 16x128-pixel tile of the JAX kernel, the gaussians whose clamped
// bounding box meets it, front to back by the rank of a stable depth argsort.
// For every pixel centre (x + 0.5, y + 0.5) of a tile, in list order:
//   power = -0.5 * (ca dx dx + cc dy dy) - cb dx dy,  dx = px - mx, dy = py - my
//   alpha = min(0.99, opacity * exp(power)), skipped when power > 0 or
//           alpha < 1/255
//   C += c * alpha * T;  T *= 1 - alpha
// on a black background, 32 channels, output (32, size, size) float32. The
// colors are float32 or bfloat16 (then widened; products and sums in float32).
//
// Stopping differs from the JAX kernel: JAX stops a whole tile after a
// 512-gaussian chunk once every pixel has T <= T_EPS; here each pixel stops as
// soon as its own T <= T_EPS (1e-4). The images differ by at most
// T_EPS * max|c| per channel.
//
// The power is evaluated uncontracted in the plain version's (and JAX's)
// order with __fmul_rn / __fadd_rn and exp is expf (no fast math), so the
// alpha thresholds decide as the plain version does.
//
// What bounds it on this card: the (pixel, instance) alpha evaluations, 14
// FLOP each, and the 32-channel accumulation of those that pass, 67 FLOP
// each (chip_smoke.py counts the composites from the run's instance lists);
// the bytes (38 values per gaussian read once, 4 MB per channel plane
// written) are far below. A JAX tile's list holds every splat whose clamped
// box meets any of its 16x128 pixels, so a 16x16 block of it finds that most
// of the list cannot reach any of its pixels (on the random-init avatar,
// about 8 px splats, 4.9 instances a gaussian).
// What the design does about it: one thread per pixel, 32 float32
// accumulators in registers; a JAX tile is split over 8 CTAs of 16x16 pixels
// that all walk the tile's list, so a dense tile keeps 8 SMs busy instead of
// one. The list is walked in batches of 256 instances: each thread tests one
// instance against the block (reaches_block: a conservative box around the
// region where alpha can reach 1/255), the survivors are compacted in list
// order (ballot and prefix sum), only their geometry and colors are staged in
// shared memory (colors one row per warp, coalesced), and the pixels
// composite only them, reading shared memory as broadcasts. An instance is
// culled only when power > 0 or alpha < 1/255 at every pixel of the block, so
// the image equals that of the whole list bit for bit. A CTA leaves as soon
// as none of its pixels is live (__syncthreads_or), which makes the dense
// tiles cheap once their pixels saturate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 16;         // the JAX tile, the unit of the instance lists
constexpr int kTileW = 128;
constexpr int kBlockW = 16;        // a CTA covers 16x16 pixels of a tile
constexpr int kSubBlocks = kTileW / kBlockW;
constexpr int kThreads = kBlockW * kTileH;
constexpr int kBatch = kThreads;   // instances staged per step
constexpr int kChannels = 32;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
// Slack of the culling box (reaches_block; ops/gsplat.py:block_culling is the
// plain version of the rule): kCullRel times the conic's conditioning
// (ca + cc)^2 / det widens the threshold of the quadratic form for the
// rounding of its uncontracted evaluation (a few float32 ulps of its largest
// term, which is at most that conditioning times the form's value),
// kCullTau (in units of the form) for logf, expf and the opacity product, and
// kCullPx pixels for the rounding of the box's edges. A conic whose
// conditioning exceeds 1 / kCullRel, or that is not positive definite or not
// finite, is never culled.
constexpr float kCullRel = 1.0f / 65536.0f;
constexpr float kCullTau = 1e-4f;
constexpr float kCullPx = 1.0f / 64.0f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// May the gaussian (g: mx my ca cb, h: cc opacity) pass the alpha cut at any
// pixel centre of the 16x16 block whose top-left pixel is (x0, y0)? alpha >=
// 1/255 needs opacity >= 1/255 and Q = ca dx^2 + 2 cb dx dy + cc dy^2 <= 2 tau,
// tau = ln(255 opacity); that ellipse lies within |dx| <= sqrt(2 tau cc / det)
// and |dy| <= sqrt(2 tau ca / det), det = ca cc - cb^2 > 0.
__device__ __forceinline__ bool reaches_block(float4 g, float2 h, float x0, float y0) {
  if (!(isfinite(g.x) && isfinite(g.y) && isfinite(g.z) && isfinite(g.w) && isfinite(h.x) &&
        isfinite(h.y)))
    return true;
  if (h.y < kAlphaEps) return false;
  const float det = g.z * h.x - g.w * g.w;
  const float tr = g.z + h.x;
  if (!(g.z > 0.0f && h.x > 0.0f && det > 0.0f && kCullRel * tr * tr <= det)) return true;
  const float thr = (2.0f * (logf(h.y) - logf(kAlphaEps)) + kCullTau) *
                    (1.0f + kCullRel * tr * tr / det);
  const float hx = sqrtf(thr * h.x / det) + kCullPx;
  const float hy = sqrtf(thr * g.z / det) + kCullPx;
  return g.x + hx >= x0 + 0.5f && g.x - hx <= x0 + (kBlockW - 0.5f) &&
         g.y + hy >= y0 + 0.5f && g.y - hy <= y0 + (kTileH - 0.5f);
}

template <typename ColorT>
__global__ void __launch_bounds__(kThreads)
splat_kernel(const float4* __restrict__ geo,       // (N, 8): mx my ca cb | cc opacity 0 0
             const ColorT* __restrict__ colors,    // (N, 32)
             const int32_t* __restrict__ inst,     // (P,) gaussian of each instance
             const int32_t* __restrict__ offsets,  // (num_tiles + 1,)
             int size, float* __restrict__ out) {  // (32, size, size)
  __shared__ float4 s_geo[kBatch];                 // mx my ca cb of the survivors
  __shared__ float2 s_geo2[kBatch];                // cc opacity
  __shared__ int32_t s_idx[kBatch];
  __shared__ int32_t s_count[kThreads / 32];       // survivors per warp
  __shared__ __align__(16) float s_col[kBatch][kChannels];

  const int tiles_x = size / kTileW;
  const int tile = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bx = (tile % tiles_x) * kTileW + blockIdx.x * kBlockW;
  const int by = (tile / tiles_x) * kTileH;
  const int x = bx + tid % kBlockW;
  const int y = by + tid / kBlockW;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const int start = offsets[tile];
  const int end = offsets[tile + 1];

  float acc[kChannels];
#pragma unroll
  for (int c = 0; c < kChannels; ++c) acc[c] = 0.0f;
  float trans = 1.0f;
  bool live = true;

  for (int base = start; base < end; base += kBatch) {
    // every thread reaches this barrier; it also ends the reads of the last batch
    if (!__syncthreads_or(live)) break;
    // cull: one instance per thread, the survivors compacted in list order
    bool keep = false;
    float4 ga, gb;
    int gi = 0;
    if (base + tid < end) {
      gi = inst[base + tid];
      ga = geo[2 * gi];
      gb = geo[2 * gi + 1];
      keep = reaches_block(ga, make_float2(gb.x, gb.y), static_cast<float>(bx),
                           static_cast<float>(by));
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int pos = __popc(ballot & ((1u << lane) - 1u)), nb = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const int c = s_count[w];
      pos += w < warp ? c : 0;
      nb += c;
    }
    if (keep) {
      s_geo[pos] = ga;
      s_geo2[pos] = make_float2(gb.x, gb.y);
      s_idx[pos] = gi;
    }
    __syncthreads();
    for (int i = warp; i < nb; i += kThreads / 32)
      s_col[i][lane] = widen(colors[static_cast<size_t>(s_idx[i]) * kChannels + lane]);
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < nb; ++i) {
      const float4 g = s_geo[i];
      const float2 h = s_geo2[i];
      const float dx = __fsub_rn(px, g.x);
      const float dy = __fsub_rn(py, g.y);
      const float quad = __fadd_rn(__fmul_rn(__fmul_rn(g.z, dx), dx),
                                   __fmul_rn(__fmul_rn(h.x, dy), dy));
      const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(g.w, dx), dy));
      if (power > 0.0f) continue;
      const float alpha = fminf(0.99f, __fmul_rn(h.y, expf(power)));
      if (alpha < kAlphaEps) continue;
      const float w = __fmul_rn(alpha, trans);
      const float4* c4 = reinterpret_cast<const float4*>(s_col[i]);
#pragma unroll
      for (int k = 0; k < kChannels / 4; ++k) {
        const float4 c = c4[k];
        acc[4 * k + 0] = fmaf(c.x, w, acc[4 * k + 0]);
        acc[4 * k + 1] = fmaf(c.y, w, acc[4 * k + 1]);
        acc[4 * k + 2] = fmaf(c.z, w, acc[4 * k + 2]);
        acc[4 * k + 3] = fmaf(c.w, w, acc[4 * k + 3]);
      }
      trans = __fmul_rn(trans, __fsub_rn(1.0f, alpha));
      if (trans <= kTEps) {
        live = false;
        break;
      }
    }
  }
  const size_t plane = static_cast<size_t>(size) * size;
  const size_t o = static_cast<size_t>(y) * size + x;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) out[c * plane + o] = acc[c];
}

}  // namespace

// Plain C entry point: pointers to device memory, the CUDA stream to launch on.
// size must be a multiple of 128. Returns cudaGetLastError() after the launch
// (0 on success); it does not synchronise and allocates nothing.
extern "C" int artalk_gsplat(const float* geo, const void* colors, int colors_bf16,
                             const int32_t* inst, const int32_t* offsets, int size,
                             float* out, void* stream) {
  const dim3 grid(kSubBlocks, (size / kTileW) * (size / kTileH));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* g = reinterpret_cast<const float4*>(geo);
  if (colors_bf16)
    splat_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        g, static_cast<const __nv_bfloat16*>(colors), inst, offsets, size, out);
  else
    splat_kernel<float><<<grid, kThreads, 0, s>>>(
        g, static_cast<const float*>(colors), inst, offsets, size, out);
  return static_cast<int>(cudaGetLastError());
}
