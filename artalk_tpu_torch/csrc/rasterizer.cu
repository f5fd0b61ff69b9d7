// Mesh z-buffer rasterizer for Hopper (sm_90a), bound through ctypes: a
// setup kernel and a per-tile raster kernel, launched back to back.
//
// Replaces the Pallas TPU kernel artalk_tpu/ops/rasterizer.py:_raster_kernel
// (launched by rasterize() at its pl.pallas_call) and the XLA setup before it
// (face_planes, chunk_bboxes). Same semantics:
//   for every pixel centre (x + 0.5, y + 0.5) and face f, evaluate the affine
//   planes w0, w1 and z; the face covers the pixel when w0 >= 0, w1 >= 0,
//   w0 + w1 <= 1 and z > 0; the winner is the lexicographic minimum of the key
//   (z_bits & ~0xFF, face_id). Output zbuf is the winner's truncated z (BIG for
//   background) and face_id its id (-1 for background). A 128-face chunk whose
//   vertex bounding box misses a 32x8 tile is skipped for it, as in the TPU
//   kernel; that is part of the function (a face's rounded planes may report
//   coverage beyond its chunk's box, and the chunk test then drops it).
// Chunk ids and lanes of the TPU kernel are face_id / 128 and face_id % 128, so
// one 64-bit key (truncated z bits high, face id low) reproduces its tie-break
// (lowest chunk, then lowest lane) exactly.
//
// What bounds it on this card: the bytes, the 8-byte output per pixel and the
// vertices and faces read once (0.0007 ms at 512x512 for the FLAME head), then
// the plane evaluations of the (pixel, face) pairs that can matter.
// What the design does about it:
//   setup_kernel, one CTA per 128-face chunk, one thread per face: the plane
//     table row (a0 a1 az, in face_planes' operation order with
//     __fmul_rn / __fsub_rn / __fadd_rn / __frcp_rn, so nvcc contracts nothing
//     and the rows equal the plain version's bit for bit), the face's cull box
//     and, by a block reduction, the chunk's vertex box (min and max are exact,
//     so the order of the reduction does not matter). Padding faces index
//     vertex 0 and are degenerate.
//   raster_kernel, one CTA per 32x8 tile, one thread per pixel: the CTA tests
//     256 chunk boxes at a time (one a thread) and lists the survivors with
//     __ballot_sync; then, for the faces of the surviving chunks, 256 at a time,
//     each thread tests one face's cull box against the tile and the survivors
//     are compacted, in face order, into a shared-memory list with their
//     planes; each pixel walks the list (every thread of a warp reads the same
//     face: a broadcast) and keeps its minimum key in a register. The minimum
//     over a set that holds every face whose rounded planes can cover a pixel
//     of the tile is the same number, so the output equals that of evaluating
//     every face of every surviving chunk.
//
// The cull box (ops/rasterizer.cull_boxes is its plain version, and says why it
// is safe) bounds where the rounded evaluation can report coverage: the
// barycentric triangle of the face's own float32 planes, widened by a bound on
// the evaluation's rounding error over the image, mapped back to pixels in
// float64 and rounded outward to float32. A sliver's planes may be far from its
// vertices (a 1e-3 px edge puts w0's line several pixels off it), so its box
// reaches beyond its vertices; a degenerate face (w0 = -1 everywhere) gets an
// empty box, and a face whose map cannot be inverted a box of everything.
// Plane evaluation rounds exactly like the plain version and the JAX kernel,
// ((px * ax) + (py * ay)) + c, with __fmul_rn / __fadd_rn.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFaceChunk = 128;  // cull granularity, as chunk_bboxes defines it
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kWarps = kThreads / 32;
constexpr int kPlaneStride = 9;  // a0x a0y a0c a1x a1y a1c azx azy azc
constexpr int kListCap = 512;    // faces listed in shared memory before a walk
constexpr float kBig = 3.4e38f;
// the cull box's bounds (ops/rasterizer.py: _EVAL_ERR, _SUM_SLACK, _UNDERFLOW, _MAP_ERR)
constexpr double kEvalErr = 0x1p-22;
constexpr double kSumSlack = 0x1p-23;
constexpr double kUnderflow = 0x1p-120;
constexpr double kMapErr = 0x1p-48;

__device__ __forceinline__ float plane(float px, float py, const float* p) {
  return __fadd_rn(__fadd_rn(__fmul_rn(px, p[0]), __fmul_rn(py, p[1])), p[2]);
}

// box [xmin, xmax, ymin, ymax] against the tile's edges, as the TPU kernel
// tests a chunk: pixel centres lie half a pixel inside the edges
__device__ __forceinline__ bool overlaps(float4 b, float x0, float y0) {
  return b.y >= x0 && b.x <= x0 + kTileW && b.w >= y0 && b.z <= y0 + kTileH;
}

// Position of this thread's entry among those of the CTA with `keep`, in
// thread order; returns the CTA's count (the same in every thread).
__device__ __forceinline__ int compact(bool keep, int& pos, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned mask = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) s_warp[warp] = __popc(mask);
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  pos = base + __popc(mask & ((1u << lane) - 1u));
  __syncthreads();  // s_warp is free for the next call
  return total;
}

// min and max that keep a NaN, as torch's amin / amax do
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

// The cull box of one face from its planes (ops/rasterizer.cull_boxes, in the
// same float64 operation order, uncontracted).
__device__ float4 cull_box(bool ok, const float* p, int height, int width) {
  if (!ok) return make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  const double a = p[0], b = p[1], c = p[2], d = p[3], e = p[4], f = p[5];
  const double W = width, H = height;
  const double e0 = __dadd_rn(__dmul_rn(kEvalErr, __dadd_rn(__dadd_rn(
      __dmul_rn(fabs(a), W), __dmul_rn(fabs(b), H)), fabs(c))), kUnderflow);
  const double e1 = __dadd_rn(__dmul_rn(kEvalErr, __dadd_rn(__dadd_rn(
      __dmul_rn(fabs(d), W), __dmul_rn(fabs(e), H)), fabs(f))), kUnderflow);
  const double far0 = __dadd_rn(__dadd_rn(__dadd_rn(1.0, kSumSlack), e0), __dmul_rn(2.0, e1));
  const double far1 = __dadd_rn(__dadd_rn(__dadd_rn(1.0, kSumSlack), __dmul_rn(2.0, e0)), e1);
  const double u0[3] = {-e0, far0, -e0};
  const double u1[3] = {-e1, -e1, far1};
  const double det = __dsub_rn(__dmul_rn(a, e), __dmul_rn(b, d));
  double xlo = INFINITY, xhi = -INFINITY, ylo = INFINITY, yhi = -INFINITY;
  bool finite = det != 0.0 && isfinite(det);
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const double r0 = __dsub_rn(u0[v], c), r1 = __dsub_rn(u1[v], f);
    const double x = __ddiv_rn(__dsub_rn(__dmul_rn(e, r0), __dmul_rn(b, r1)), det);
    const double y = __ddiv_rn(__dsub_rn(__dmul_rn(a, r1), __dmul_rn(d, r0)), det);
    const double m0 = __dadd_rn(fabs(u0[v]), fabs(c)), m1 = __dadd_rn(fabs(u1[v]), fabs(f));
    const double mx = __ddiv_rn(__dmul_rn(kMapErr, __dadd_rn(__dmul_rn(fabs(e), m0),
                                                              __dmul_rn(fabs(b), m1))), fabs(det));
    const double my = __ddiv_rn(__dmul_rn(kMapErr, __dadd_rn(__dmul_rn(fabs(a), m1),
                                                              __dmul_rn(fabs(d), m0))), fabs(det));
    finite = finite && isfinite(x) && isfinite(y) && isfinite(mx) && isfinite(my);
    xlo = fmin(xlo, __dsub_rn(x, mx));
    xhi = fmax(xhi, __dadd_rn(x, mx));
    ylo = fmin(ylo, __dsub_rn(y, my));
    yhi = fmax(yhi, __dadd_rn(y, my));
  }
  if (!finite) return make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
  return make_float4(__double2float_rd(xlo), __double2float_ru(xhi), __double2float_rd(ylo),
                     __double2float_ru(yhi));
}

template <typename IT>
__global__ void __launch_bounds__(kFaceChunk)
setup_kernel(const float* __restrict__ verts,  // (V, 3) x_pix y_pix z_cam
             const IT* __restrict__ faces,      // (F, 3)
             int num_verts, int num_faces, int height, int width,
             float* __restrict__ planes,        // (num_chunks * 128, 9)
             float* __restrict__ boxes,         // (num_chunks * 128, 4) cull boxes
             float* __restrict__ chunk_box) {   // (num_chunks, 4) xmin xmax ymin ymax
  __shared__ float s_red[4][kFaceChunk / 32];
  const int face = blockIdx.x * kFaceChunk + threadIdx.x;
  int idx[3] = {0, 0, 0};  // padding faces index vertex 0
  if (face < num_faces) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const long long i = static_cast<long long>(faces[3 * static_cast<size_t>(face) + k]);
      if (i < 0 || i >= num_verts) __trap();  // torch's indexing would assert
      idx[k] = static_cast<int>(i);
    }
  }
  const float x0 = verts[3 * idx[0]], y0 = verts[3 * idx[0] + 1], z0 = verts[3 * idx[0] + 2];
  const float x1 = verts[3 * idx[1]], y1 = verts[3 * idx[1] + 1], z1 = verts[3 * idx[1] + 2];
  const float x2 = verts[3 * idx[2]], y2 = verts[3 * idx[2] + 1], z2 = verts[3 * idx[2] + 2];

  // face_planes, operation by operation
  const float area = __fsub_rn(__fmul_rn(__fsub_rn(x1, x0), __fsub_rn(y2, y0)),
                               __fmul_rn(__fsub_rn(x2, x0), __fsub_rn(y1, y0)));
  const bool ok = fabsf(area) > 1e-12f;
  const float inv = ok ? __frcp_rn(area) : 0.0f;  // torch: area.reciprocal() * 1.0
  const float a0x = __fmul_rn(__fsub_rn(y1, y2), inv);
  const float a0y = __fmul_rn(__fsub_rn(x2, x1), inv);
  const float a0c = __fmul_rn(__fsub_rn(__fmul_rn(x1, y2), __fmul_rn(x2, y1)), inv);
  const float a1x = __fmul_rn(__fsub_rn(y2, y0), inv);
  const float a1y = __fmul_rn(__fsub_rn(x0, x2), inv);
  const float a1c = __fmul_rn(__fsub_rn(__fmul_rn(x2, y0), __fmul_rn(x0, y2)), inv);
  const float dz0 = __fsub_rn(z0, z2), dz1 = __fsub_rn(z1, z2);
  const float azx = __fadd_rn(__fmul_rn(a0x, dz0), __fmul_rn(a1x, dz1));
  const float azy = __fadd_rn(__fmul_rn(a0y, dz0), __fmul_rn(a1y, dz1));
  const float azc = __fadd_rn(__fadd_rn(__fmul_rn(a0c, dz0), __fmul_rn(a1c, dz1)), z2);
  const float row[kPlaneStride] = {ok ? a0x : 0.0f, ok ? a0y : 0.0f, ok ? a0c : -1.0f,
                                   ok ? a1x : 0.0f, ok ? a1y : 0.0f, ok ? a1c : 0.0f,
                                   azx, azy, azc};
  float* dst = planes + static_cast<size_t>(face) * kPlaneStride;
#pragma unroll
  for (int k = 0; k < kPlaneStride; ++k) dst[k] = row[k];
  reinterpret_cast<float4*>(boxes)[face] = cull_box(ok, row, height, width);

  // the chunk's vertex box: warp, then block reduction
  float v[4] = {min_nan(min_nan(x0, x1), x2), max_nan(max_nan(x0, x1), x2),
                min_nan(min_nan(y0, y1), y2), max_nan(max_nan(y0, y1), y2)};
  for (int o = 16; o > 0; o >>= 1) {
    v[0] = min_nan(v[0], __shfl_xor_sync(0xffffffffu, v[0], o));
    v[1] = max_nan(v[1], __shfl_xor_sync(0xffffffffu, v[1], o));
    v[2] = min_nan(v[2], __shfl_xor_sync(0xffffffffu, v[2], o));
    v[3] = max_nan(v[3], __shfl_xor_sync(0xffffffffu, v[3], o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
    for (int k = 0; k < 4; ++k) s_red[k][warp] = v[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kFaceChunk / 32; ++w) {
      v[0] = min_nan(v[0], s_red[0][w]);
      v[1] = max_nan(v[1], s_red[1][w]);
      v[2] = min_nan(v[2], s_red[2][w]);
      v[3] = max_nan(v[3], s_red[3][w]);
    }
    reinterpret_cast<float4*>(chunk_box)[blockIdx.x] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ planes, const float* __restrict__ boxes,
              const float* __restrict__ chunk_box, int num_chunks, int height, int width,
              float* __restrict__ zbuf, int32_t* __restrict__ face_id) {
  __shared__ float s_planes[kListCap * kPlaneStride];
  __shared__ int s_ids[kListCap];
  __shared__ int s_chunks[kThreads];
  __shared__ int s_warp[kWarps];

  const int tid = threadIdx.x;
  const int x = blockIdx.x * kTileW + (tid % kTileW);
  const int y = blockIdx.y * kTileH + (tid / kTileW);
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const float tile_x0 = static_cast<float>(blockIdx.x * kTileW);
  const float tile_y0 = static_cast<float>(blockIdx.y * kTileH);

  unsigned long long best = ~0ULL;
  int listed = 0;  // uniform across the CTA
  auto walk = [&]() {
    __syncthreads();  // the list is written
    for (int f = 0; f < listed; ++f) {
      const float* p = s_planes + f * kPlaneStride;
      const float w0 = plane(px, py, p);
      const float w1 = plane(px, py, p + 3);
      const float z = plane(px, py, p + 6);
      if (w0 >= 0.0f && w1 >= 0.0f && __fadd_rn(w0, w1) <= 1.0f && z > 0.0f) {
        const unsigned long long key =
            (static_cast<unsigned long long>(__float_as_uint(z) & 0xFFFFFF00u) << 32) |
            static_cast<unsigned int>(s_ids[f]);
        best = key < best ? key : best;
      }
    }
    __syncthreads();  // every pixel is done with the list
    listed = 0;
  };

  for (int c0 = 0; c0 < num_chunks; c0 += kThreads) {
    // this window's chunks whose vertex box overlaps the tile, in order
    const int c = c0 + tid;
    const bool hit = c < num_chunks &&
                     overlaps(reinterpret_cast<const float4*>(chunk_box)[c], tile_x0, tile_y0);
    int pos;
    const int hits = compact(hit, pos, s_warp);
    if (hit) s_chunks[pos] = c;
    __syncthreads();
    // their faces, 256 at a time: those whose cull box overlaps the tile are listed
    for (int i0 = 0; i0 < hits * kFaceChunk; i0 += kThreads) {
      const int i = i0 + tid;
      bool keep = false;
      int face = 0;
      float p[kPlaneStride];
      if (i < hits * kFaceChunk) {
        face = s_chunks[i / kFaceChunk] * kFaceChunk + i % kFaceChunk;
        keep = overlaps(reinterpret_cast<const float4*>(boxes)[face], tile_x0, tile_y0);
        const float* src = planes + static_cast<size_t>(face) * kPlaneStride;
#pragma unroll
        for (int k = 0; k < kPlaneStride; ++k) p[k] = src[k];
      }
      const int kept = compact(keep, pos, s_warp);
      if (keep) {
        s_ids[listed + pos] = face;
#pragma unroll
        for (int k = 0; k < kPlaneStride; ++k) s_planes[(listed + pos) * kPlaneStride + k] = p[k];
      }
      listed += kept;
      if (listed > kListCap - kThreads) walk();
    }
  }
  if (listed > 0) walk();
  if (x < width && y < height) {
    const size_t o = static_cast<size_t>(y) * width + x;
    const bool hit = best != ~0ULL;
    zbuf[o] = hit ? __uint_as_float(static_cast<unsigned int>(best >> 32)) : kBig;
    face_id[o] = hit ? static_cast<int32_t>(best & 0xFFFFFFFFu) : -1;
  }
}

int launch_setup(const float* verts, const void* faces, int index_bytes, int num_verts,
                 int num_faces, int height, int width, float* planes, float* boxes,
                 float* chunk_box, cudaStream_t stream) {
  const int num_chunks = (num_faces + kFaceChunk - 1) / kFaceChunk;
  if (num_chunks == 0) return 0;
  if (index_bytes == 8)
    setup_kernel<int64_t><<<num_chunks, kFaceChunk, 0, stream>>>(
        verts, static_cast<const int64_t*>(faces), num_verts, num_faces, height, width, planes,
        boxes, chunk_box);
  else
    setup_kernel<int32_t><<<num_chunks, kFaceChunk, 0, stream>>>(
        verts, static_cast<const int32_t*>(faces), num_verts, num_faces, height, width, planes,
        boxes, chunk_box);
  return static_cast<int>(cudaGetLastError());
}

int launch_raster(const float* planes, const float* boxes, const float* chunk_box,
                  int num_chunks, int height, int width, float* zbuf, int32_t* face_id,
                  cudaStream_t stream) {
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  raster_kernel<<<grid, kThreads, 0, stream>>>(planes, boxes, chunk_box, num_chunks, height,
                                                width, zbuf, face_id);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points: pointers to device memory, the CUDA stream to launch
// on. Each returns cudaGetLastError() after its launches (0 on success); none
// synchronises or allocates. faces are int32 (index_bytes 4) or int64 (8).

// The setup kernel alone: planes, cull boxes and chunk boxes.
extern "C" int artalk_rasterize_setup(const float* verts, const void* faces, int index_bytes,
                                      int num_verts, int num_faces, int height, int width,
                                      float* planes, float* boxes, float* chunk_box,
                                      void* stream) {
  return launch_setup(verts, faces, index_bytes, num_verts, num_faces, height, width, planes,
                      boxes, chunk_box, static_cast<cudaStream_t>(stream));
}

// The raster kernel alone, from the setup's outputs.
extern "C" int artalk_rasterize_tiles(const float* planes, const float* boxes,
                                      const float* chunk_box, int num_chunks, int height,
                                      int width, float* zbuf, int32_t* face_id, void* stream) {
  return launch_raster(planes, boxes, chunk_box, num_chunks, height, width, zbuf, face_id,
                       static_cast<cudaStream_t>(stream));
}

// Both, as rasterize() launches them; planes / boxes / chunk_box are scratch.
extern "C" int artalk_rasterize(const float* verts, const void* faces, int index_bytes,
                                int num_verts, int num_faces, int height, int width,
                                float* planes, float* boxes, float* chunk_box, float* zbuf,
                                int32_t* face_id, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_setup(verts, faces, index_bytes, num_verts, num_faces, height, width,
                               planes, boxes, chunk_box, s);
  if (err != 0) return err;
  return launch_raster(planes, boxes, chunk_box, (num_faces + kFaceChunk - 1) / kFaceChunk,
                       height, width, zbuf, face_id, s);
}
