// Mesh z-buffer rasterizer for Hopper (sm_90a), bound through ctypes.
//
// Replaces the Pallas TPU kernel artalk_tpu/ops/rasterizer.py:_raster_kernel
// (launched by rasterize() at its pl.pallas_call). Same semantics:
//   for every pixel centre (x + 0.5, y + 0.5) and face f, evaluate the affine
//   planes w0, w1 and z; the face covers the pixel when w0 >= 0, w1 >= 0,
//   w0 + w1 <= 1 and z > 0; the winner is the lexicographic minimum of the key
//   (z_bits & ~0xFF, face_id). Output zbuf is the winner's truncated z (BIG for
//   background) and face_id its id (-1 for background).
// Chunk ids and lanes of the TPU kernel are face_id / 128 and face_id % 128, so
// one 64-bit key (truncated z bits high, face id low) reproduces its tie-break
// (lowest chunk, then lowest lane) exactly. The TPU kernel's 256-chunk cap and
// its final f32 bitcast argmin existed only to pack that key into 32 bits
// under Mosaic; they are gone.
//
// What bounds it on this card: the per-pixel plane evaluations over the faces
// of the chunks whose bounding box overlaps the pixel's tile (about 9 FLOPs and
// 4 compares per pixel-face pair). Memory traffic is negligible: 36 bytes per
// face read once per overlapping tile, 8 bytes written per pixel.
// What the design does about it: one thread per pixel in a 32x8 tile; the block
// culls 128-face chunks against the tile with the precomputed chunk bounding
// boxes (spatially ordered faces make most chunks miss), stages a surviving
// chunk's planes in shared memory (every thread of a warp reads the same face:
// a broadcast, no bank conflicts) and keeps the running minimum key in a
// register. No atomics, no inter-block communication.
//
// Plane evaluation must round exactly like the plain version and the JAX
// kernel, ((px * ax) + (py * ay)) + c: nvcc would contract it into FMAs and move
// coverage decisions on shared edges, so it uses __fmul_rn / __fadd_rn.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFaceChunk = 128;  // cull granularity, as chunk_bboxes defines it
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kPlaneStride = 9;  // a0x a0y a0c a1x a1y a1c azx azy azc
constexpr float kBig = 3.4e38f;

__device__ __forceinline__ float plane(float px, float py, const float* p) {
  return __fadd_rn(__fadd_rn(__fmul_rn(px, p[0]), __fmul_rn(py, p[1])), p[2]);
}

__global__ void __launch_bounds__(kTileW * kTileH)
raster_kernel(const float* __restrict__ planes,  // (num_chunks * 128, 9)
              const float* __restrict__ bbox,    // (num_chunks, 4) xmin xmax ymin ymax
              int num_chunks, int height, int width,
              float* __restrict__ zbuf, int32_t* __restrict__ face_id) {
  __shared__ float s_planes[kFaceChunk * kPlaneStride];

  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const float tile_x0 = static_cast<float>(blockIdx.x * kTileW);
  const float tile_y0 = static_cast<float>(blockIdx.y * kTileH);
  const float tile_x1 = tile_x0 + static_cast<float>(kTileW);
  const float tile_y1 = tile_y0 + static_cast<float>(kTileH);

  unsigned long long best = ~0ULL;
  for (int c = 0; c < num_chunks; ++c) {
    const float* bb = bbox + 4 * c;
    // uniform across the block, so the barriers below are reached by all
    if (!(bb[1] >= tile_x0 && bb[0] <= tile_x1 && bb[3] >= tile_y0 && bb[2] <= tile_y1))
      continue;
    __syncthreads();  // the previous chunk's readers are done with s_planes
    const float* src = planes + static_cast<size_t>(c) * kFaceChunk * kPlaneStride;
    for (int i = tid; i < kFaceChunk * kPlaneStride; i += kTileW * kTileH)
      s_planes[i] = src[i];
    __syncthreads();
#pragma unroll 4
    for (int f = 0; f < kFaceChunk; ++f) {
      const float* p = s_planes + f * kPlaneStride;
      const float w0 = plane(px, py, p);
      const float w1 = plane(px, py, p + 3);
      const float z = plane(px, py, p + 6);
      if (w0 >= 0.0f && w1 >= 0.0f && __fadd_rn(w0, w1) <= 1.0f && z > 0.0f) {
        const unsigned long long key =
            (static_cast<unsigned long long>(__float_as_uint(z) & 0xFFFFFF00u) << 32) |
            static_cast<unsigned int>(c * kFaceChunk + f);
        best = key < best ? key : best;
      }
    }
  }
  if (x < width && y < height) {
    const size_t o = static_cast<size_t>(y) * width + x;
    const bool hit = best != ~0ULL;
    zbuf[o] = hit ? __uint_as_float(static_cast<unsigned int>(best >> 32)) : kBig;
    face_id[o] = hit ? static_cast<int32_t>(best & 0xFFFFFFFFu) : -1;
  }
}

}  // namespace

// Plain C entry point: pointers to device memory, the CUDA stream to launch on.
// Returns cudaGetLastError() after the launch (0 on success); it does not
// synchronise and allocates nothing.
extern "C" int artalk_rasterize(const float* planes, const float* bbox, int num_chunks,
                                int height, int width, float* zbuf, int32_t* face_id,
                                void* stream) {
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  raster_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      planes, bbox, num_chunks, height, width, zbuf, face_id);
  return static_cast<int>(cudaGetLastError());
}
