// Shared device code of the two block-stack kernels (ar_block_stack.cu,
// encoder_block_stack.cu): the attention stage on the CUDA cores (the AR
// blocks' attention against the KV cache, and the float32 encoder pack's),
// the cooperative launch, and the small helpers both use.
//
// Both kernels are one cooperative launch per call. Every stage hands out
// work items (output tiles, or attention rows of one head) round-robin over
// the CTAs of the grid, and the kernel separates the stages with a grid-wide
// barrier. Activations and intermediates live in global scratch that the
// wrapper allocates; at these sizes (at most a few MB) it stays in L2.
//
// Numerics of the attention: fp32 FMA; for bf16 and int8 weight packs q, k,
// p and v are rounded to bf16 first and accumulated in fp32, which is what
// the Pallas kernels do with their bf16 compute dtype.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace bs {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 128;

// error code of the entry points when the grid cannot be co-resident
constexpr int kNotCoResident = -1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// four consecutive elements (16 or 8 bytes, aligned) as floats
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo); v[2] = __low2float(hi); v[3] = __high2float(hi);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// Softmax attention of T new query rows per batch row against
// [prefix cached keys | the T new keys], one head at a time.
struct Attn {
  int B, T, H, hd, d;
  int prefix;              // cached keys before the new ones (AR: start; encoder: 0)
  const void* kc;          // (B, cache_len, d) of this block, cache type; null when prefix == 0
  const void* vc;
  long long cache_b_stride;  // elements between batch rows of the cache
  const float* q;          // (B * T, ld) rows; written earlier in this kernel
  const float* k;
  const float* v;
  int ld;
  int l2norm;              // AR: q and k L2-normalised, q scaled by qscale[h]
  const float* qscale;     // (H)
  float logit_scale;       // encoder: logits * logit_scale
  int round;               // round q, k, p and v to bf16 before the products
  void* out;               // (B * T, d) in the output type OT
  void* k_out;             // AR: (B, T, d) normalised new keys in the cache type; else null
  void* v_out;
};

// rows x hd elements (row stride `stride`, 4-aligned) into shared memory of
// row pitch `pitch`, as floats, bf16-rounded if asked; four per load, several
// loads in flight per thread
template <typename T>
__device__ void stage_rows(float* dst, int pitch, const T* src, long long stride, int rows,
                           int hd, bool round) {
  const int per_row = hd / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int j = i / per_row, c = (i % per_row) * 4;
    float v[4];
    load4(src + j * stride + c, v);
    for (int u = 0; u < 4; ++u) dst[j * pitch + c + u] = round ? round_bf16(v[u]) : v[u];
  }
}

inline __host__ __device__ int attn_smem_floats(int keys, int hd) {
  return keys * (hd + 1) + kWarps * keys + kWarps * hd;
}

template <typename CT, typename OT = float>
__device__ void attention(const Attn& a, float* smem) {
  const int L = a.prefix + a.T, hd = a.hd, pitch = hd + 1;
  float* kv = smem;                    // [L][hd + 1]: keys, then values
  float* ps = kv + L * pitch;          // [kWarps][L]: logits, then probabilities
  float* qs = ps + kWarps * L;         // [kWarps][hd]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_chunks = (a.T + kWarps - 1) / kWarps;
  const int items = a.B * a.H * q_chunks;
  const CT* kc = static_cast<const CT*>(a.kc);
  const CT* vc = static_cast<const CT*>(a.vc);
  auto rnd = [&](float x) { return a.round ? round_bf16(x) : x; };

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int qc = item % q_chunks;
    const int h = (item / q_chunks) % a.H;
    const int b = item / (q_chunks * a.H);
    const int col0 = h * hd;
    const bool writer = qc == 0 && a.k_out != nullptr;

    // keys: the cached prefix, then the new keys (normalised in the AR stack)
    if (a.prefix > 0)
      stage_rows(kv, pitch, kc + b * a.cache_b_stride + col0, a.d, a.prefix, hd, a.round);
    for (int j = warp; j < a.T; j += kWarps) {
      const float* src = a.k + static_cast<size_t>(b * a.T + j) * a.ld + col0;
      float vals[kMaxHeadDim / 32];
      float ss = 0.0f;
      for (int c = lane, u = 0; c < hd; c += 32, ++u) {
        vals[u] = src[c];
        ss += vals[u] * vals[u];
      }
      float norm = 1.0f;
      if (a.l2norm) norm = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
      for (int c = lane, u = 0; c < hd; c += 32, ++u) {
        const float kn = a.l2norm ? vals[u] / norm : vals[u];
        kv[(a.prefix + j) * pitch + c] = rnd(kn);
        if (writer) {
          const size_t o = static_cast<size_t>(b * a.T + j) * a.d + col0 + c;
          static_cast<CT*>(a.k_out)[o] = from_f<CT>(kn);
          static_cast<CT*>(a.v_out)[o] =
              from_f<CT>(a.v[static_cast<size_t>(b * a.T + j) * a.ld + col0 + c]);
        }
      }
    }
    // this warp's query row
    const int qi = qc * kWarps + warp;
    const bool live = qi < a.T;
    if (live) {
      const float* src = a.q + static_cast<size_t>(b * a.T + qi) * a.ld + col0;
      float vals[kMaxHeadDim / 32];
      float ss = 0.0f;
      for (int c = lane, u = 0; c < hd; c += 32, ++u) {
        vals[u] = src[c];
        ss += vals[u] * vals[u];
      }
      float norm = 1.0f;
      if (a.l2norm) norm = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
      for (int c = lane, u = 0; c < hd; c += 32, ++u)
        qs[warp * hd + c] = rnd(a.l2norm ? vals[u] / norm * a.qscale[h] : vals[u]);
    }
    __syncthreads();

    float z = 0.0f;
    if (live) {
      float* p = ps + warp * L;
      const float* qrow = qs + warp * hd;
      float m = -INFINITY;
      for (int j = lane; j < L; j += 32) {
        const float* krow = kv + j * pitch;
        float dot = 0.0f;
        for (int c = 0; c < hd; ++c) dot = fmaf(qrow[c], krow[c], dot);
        const float l = a.l2norm ? dot : dot * a.logit_scale;
        p[j] = l;
        m = fmaxf(m, l);
      }
      m = warp_max(m);
      for (int j = lane; j < L; j += 32) {
        const float e = expf(p[j] - m);
        z += e;
        p[j] = rnd(e);
      }
      z = warp_sum(z);
    }
    __syncthreads();  // every warp is done with the keys

    if (a.prefix > 0)
      stage_rows(kv, pitch, vc + b * a.cache_b_stride + col0, a.d, a.prefix, hd, a.round);
    stage_rows(kv + a.prefix * pitch, pitch, a.v + static_cast<size_t>(b) * a.T * a.ld + col0,
               a.ld, a.T, hd, a.round);
    __syncthreads();

    if (live) {
      const float* p = ps + warp * L;
      OT* dst = static_cast<OT*>(a.out) + static_cast<size_t>(b * a.T + qi) * a.d + col0;
      for (int c = lane; c < hd; c += 32) {
        float o = 0.0f;
        for (int j = 0; j < L; ++j) o = fmaf(p[j], kv[j * pitch + c], o);
        dst[c] = from_f<OT>(o / z);
      }
    }
    __syncthreads();  // before the next item overwrites shared memory
  }
}

// Dynamic shared memory, grid size and cooperative launch of a block-stack
// kernel(params, maps): as many CTAs as can be co-resident, at most two per SM.
template <typename Kernel, typename Params, typename Maps>
int launch_cooperative(Kernel kernel, const Params& params, const Maps& maps, int smem_floats,
                       cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(smem_floats) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem))
      != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return kNotCoResident;
  Params copy = params;
  Maps maps_copy = maps;
  void* args[] = {&copy, &maps_copy};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(sms * (per_sm < 2 ? per_sm : 2)), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bs
