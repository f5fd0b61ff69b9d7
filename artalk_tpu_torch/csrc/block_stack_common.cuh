// Shared device code of the two block-stack kernels (ar_block_stack.cu,
// encoder_block_stack.cu): a persistent-grid matrix product stage with the
// LayerNorm of its input rows and its epilogue folded in, an attention stage,
// and the small helpers both use.
//
// Both kernels are one cooperative launch per call. Every stage hands out
// work items (output tiles, or attention rows of one head) round-robin over
// the CTAs of the grid, and the kernel separates the stages with a grid-wide
// barrier. Activations and intermediates live in global scratch that the
// wrapper allocates; at these sizes (at most a few MB) it stays in L2.
//
// Numerics: products are plain fp32 FMA (no TF32, no tensor cores). For bf16
// and int8 weight packs both operands of every product are rounded to bf16
// first and accumulated in fp32, which is what the Pallas kernels do with
// their bf16 compute dtype; int8 weights are exact in bf16 and the per-output
// scale multiplies the fp32 result of each scale chunk of the contraction.

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
constexpr int kTM = 32;   // rows of an output tile
constexpr int kTN = 64;   // columns of an output tile
constexpr int kTK = 32;   // contraction step
constexpr int kApitch = kTM + 1;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxLnWidth = 1024;  // LayerNorm rows are held in registers, 32 a lane

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

enum Epilogue { kStore = 0, kGeluTanh = 1, kGeluErf = 2, kResidual = 3 };

// out[M, N] = epilogue(A[M, K] @ W[K, N] + bias), W row-major in the pack's type.
struct Gemm {
  int M, N, K;
  const float* a;  // (M, K), row stride lda; written earlier in this kernel
  int lda;
  // ln != 0: A = (a - mean) * rstd * (s + s_add) + t over each row of a, with
  // s and t of row stride st_ld (0: one row for all rows)
  int ln;
  float eps;
  const float* s;
  const float* t;
  int st_ld;
  float s_add;
  int round_a;          // round A to bf16 before the product
  const void* w;        // (K, N)
  const float* bias;    // (N)
  const float* scales;  // int8 packs: (K / scale_chunk, N); else null
  int scale_chunk;
  int splits;           // contraction splits; > 1: partial sums, then a reduction pass
  float* partial;       // (splits, M, N) scratch when splits > 1
  int epi;
  float* out;           // (M, N), row stride ldo; may alias resid
  int ldo;
  const float* resid;   // kResidual: out = resid + (y + bias) * gate
  int ld_resid;
  const float* gate;    // null: gate 1
  int ld_gate;
};

constexpr int gemm_smem_floats() { return kTK * kTN + kTK * kApitch + 2 * kTM; }

__device__ __forceinline__ void epilogue(const Gemm& g, int row, int n, float y) {
  y += g.bias[n];
  float* o = g.out + static_cast<size_t>(row) * g.ldo + n;
  switch (g.epi) {
    case kGeluTanh: *o = gelu_tanh(y); break;
    case kGeluErf: *o = gelu_erf(y); break;
    case kResidual: {
      const float gate = g.gate != nullptr ? g.gate[static_cast<size_t>(row) * g.ld_gate + n]
                                           : 1.0f;
      *o = g.resid[static_cast<size_t>(row) * g.ld_resid + n] + y * gate;
      break;
    }
    default: *o = y;
  }
}

// The items of a product: (row tile, column tile, contraction split), walked
// by the whole grid. N must be a multiple of kTN and K of kTK * splits (the
// wrappers check). Each thread owns 2 rows x 4 columns of a 32 x 64 tile; the
// next contraction step's operands are loaded into registers while the
// current one is multiplied out of shared memory.
template <typename WT>
__device__ void gemm_items(const Gemm& g, float* smem) {
  float* Ws = smem;                      // [kTK][kTN]
  float* As = Ws + kTK * kTN;            // [kTK][kApitch], A transposed
  float* mean_s = As + kTK * kApitch;    // [kTM]
  float* rstd_s = mean_s + kTM;          // [kTM]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int row_tiles = (g.M + kTM - 1) / kTM;
  const int col_tiles = g.N / kTN;
  const int items = row_tiles * col_tiles * g.splits;
  const int split_len = g.K / g.splits;
  const WT* w = static_cast<const WT*>(g.w);
  constexpr int kAPer = kTM * kTK / kThreads;  // A elements per thread and step
  constexpr int kWPer = kTK * kTN / kThreads;  // W elements per thread and step

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int m0 = (item % row_tiles) * kTM;
    const int rest = item / row_tiles;
    const int split = rest % g.splits;
    const int n0 = (rest / g.splits) * kTN;
    const int k_begin = split * split_len, k_end = k_begin + split_len;
    if (g.ln) {
      for (int r = warp; r < kTM; r += kWarps) {
        const int row = m0 + r;
        float mean = 0.0f, rstd = 0.0f;
        if (row < g.M) {
          const float* x = g.a + static_cast<size_t>(row) * g.lda;
          float xv[kMaxLnWidth / 32];
          float sum = 0.0f;
#pragma unroll
          for (int u = 0; u < kMaxLnWidth / 32; ++u) {
            xv[u] = lane + 32 * u < g.K ? x[lane + 32 * u] : 0.0f;
            sum += xv[u];
          }
          mean = warp_sum(sum) / static_cast<float>(g.K);
          float sq = 0.0f;
#pragma unroll
          for (int u = 0; u < kMaxLnWidth / 32; ++u) {
            const float c = lane + 32 * u < g.K ? xv[u] - mean : 0.0f;
            sq += c * c;
          }
          rstd = rsqrtf(warp_sum(sq) / static_cast<float>(g.K) + g.eps);
        }
        if (lane == 0) {
          mean_s[r] = mean;
          rstd_s[r] = rstd;
        }
      }
      __syncthreads();
    }
    float a_reg[kAPer], s_reg[kAPer], t_reg[kAPer];
    WT w_reg[kWPer];
    auto load = [&](int k0) {
#pragma unroll
      for (int u = 0; u < kAPer; ++u) {
        const int i = tid + u * kThreads, row = m0 + i / kTK, col = k0 + i % kTK;
        a_reg[u] = s_reg[u] = t_reg[u] = 0.0f;
        if (row < g.M) {
          a_reg[u] = g.a[static_cast<size_t>(row) * g.lda + col];
          if (g.ln) {
            const size_t o = static_cast<size_t>(row) * g.st_ld + col;
            s_reg[u] = g.s[o];
            t_reg[u] = g.t[o];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kWPer; ++u) {
        const int i = tid + u * kThreads;
        w_reg[u] = w[static_cast<size_t>(k0 + i / kTN) * g.N + n0 + i % kTN];
      }
    };
    load(k_begin);
    float acc[2][4] = {}, tot[2][4] = {};
    for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
#pragma unroll
      for (int u = 0; u < kAPer; ++u) {
        const int i = tid + u * kThreads, m = i / kTK, k = i % kTK, row = m0 + m;
        float v = a_reg[u];
        if (row < g.M) {
          if (g.ln) v = (v - mean_s[m]) * rstd_s[m] * (s_reg[u] + g.s_add) + t_reg[u];
          if (g.round_a) v = round_bf16(v);
        }
        As[k * kApitch + m] = v;
      }
#pragma unroll
      for (int u = 0; u < kWPer; ++u) Ws[tid + u * kThreads] = to_f(w_reg[u]);
      __syncthreads();
      if (k0 + kTK < k_end) load(k0 + kTK);
#pragma unroll 8
      for (int kk = 0; kk < kTK; ++kk) {
        const float a0 = As[kk * kApitch + ty * 2];
        const float a1 = As[kk * kApitch + ty * 2 + 1];
        const float4 wv = *reinterpret_cast<const float4*>(Ws + kk * kTN + tx * 4);
        acc[0][0] = fmaf(a0, wv.x, acc[0][0]);
        acc[0][1] = fmaf(a0, wv.y, acc[0][1]);
        acc[0][2] = fmaf(a0, wv.z, acc[0][2]);
        acc[0][3] = fmaf(a0, wv.w, acc[0][3]);
        acc[1][0] = fmaf(a1, wv.x, acc[1][0]);
        acc[1][1] = fmaf(a1, wv.y, acc[1][1]);
        acc[1][2] = fmaf(a1, wv.z, acc[1][2]);
        acc[1][3] = fmaf(a1, wv.w, acc[1][3]);
      }
      __syncthreads();
      // int8: scale each scale chunk's sum (a split never straddles a chunk)
      if (g.scales != nullptr && ((k0 + kTK) % g.scale_chunk == 0 || k0 + kTK == k_end)) {
        const float* sc = g.scales + static_cast<size_t>(k0 / g.scale_chunk) * g.N + n0 + tx * 4;
        for (int i = 0; i < 2; ++i)
          for (int j = 0; j < 4; ++j) {
            tot[i][j] += acc[i][j] * sc[j];
            acc[i][j] = 0.0f;
          }
      }
    }
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + ty * 2 + i;
      if (row >= g.M) continue;
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        const float y = g.scales != nullptr ? tot[i][j] : acc[i][j];
        if (g.splits > 1)
          g.partial[(static_cast<size_t>(split) * g.M + row) * g.N + n] = y;
        else
          epilogue(g, row, n, y);
      }
    }
  }
}

// One product stage, ending in a grid-wide barrier (none after the kernel's
// last stage, `last`). With splits, the partial sums are added in split order
// after a barrier, so each output's arithmetic depends only on its own row.
template <typename WT>
__device__ void gemm(const Gemm& g, float* smem, cg::grid_group& grid, bool last = false) {
  gemm_items<WT>(g, smem);
  if (g.splits > 1) {
    grid.sync();
    const size_t total = static_cast<size_t>(g.M) * g.N;
    for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; e < total;
         e += static_cast<size_t>(gridDim.x) * kThreads) {
      float y = 0.0f;
      for (int sp = 0; sp < g.splits; ++sp) y += g.partial[sp * total + e];
      epilogue(g, static_cast<int>(e / g.N), static_cast<int>(e % g.N), y);
    }
  }
  if (!last) grid.sync();
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
  float* out;              // (B * T, d)
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

template <typename CT>
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
      float* dst = a.out + static_cast<size_t>(b * a.T + qi) * a.d + col0;
      for (int c = lane; c < hd; c += 32) {
        float o = 0.0f;
        for (int j = 0; j < L; ++j) o = fmaf(p[j], kv[j * pitch + c], o);
        dst[c] = o / z;
      }
    }
    __syncthreads();  // before the next item overwrites shared memory
  }
}

// Dynamic shared memory, grid size and cooperative launch of a block-stack
// kernel: as many CTAs as can be co-resident, at most two per SM.
template <typename Kernel, typename Params>
int launch_cooperative(Kernel kernel, const Params& params, int smem_floats, cudaStream_t stream) {
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
  void* args[] = {&copy};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(sms * (per_sm < 2 ? per_sm : 2)), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bs
