// Ascending sort of int32 keys by a bitonic network for Hopper (sm_90a),
// bound through ctypes.
//
// Replaces the Pallas TPU kernel tools/exp_pallas_sort.py:_bitonic_kernel
// (lines 61-112, launched by bitonic_sort() at its pl.pallas_call): a
// payload-free ascending sort of int32 keys, compared as signed integers, by
// the bitonic compare-exchange network. For k = 2, 4, ..., P and j = k/2, ...,
// 1, the keys at i and i ^ j are exchanged so that the smaller one comes first
// where bit k of the global index i is 0 and last where it is 1. In the port it
// sorts the instance keys of the splat prepass (ops/gsplat.py:_build_instances;
// jax.lax.sort in artalk_tpu/ops/gsplat.py).
//
// Unlike the TPU kernel, any length n is taken: the first launch reads the n
// keys and pads the scratch buffer (P = the next power of two >= max(n, 2),
// allocated by the wrapper) with INT32_MAX, which sorts last; the sorted keys
// are the buffer's first n. Nothing is allocated here.
//
// Launches, all on the caller's stream (separate launches on one stream give
// the grid-wide barrier that a global substage needs; a cooperative launch
// with grid barriers was not chosen, as it would cap the grid at the CTAs that
// fit on the card at once and loop inside each CTA):
//   1. tile_sort: each CTA sorts a tile of kTile = 2048 keys in shared memory
//      through every stage k <= kTile, the direction from bit k of the global
//      index, so neighbouring tiles come out in alternate order;
//   2. for each stage k > kTile: one global_substage launch per j >= kTile
//      (thread t exchanges one pair i, i ^ j in device memory), then one
//      tile_merge launch that finishes the substages j < kTile of stage k in
//      shared memory.
// At P = 2^20 that is 1 + 45 + 9 = 55 launches, at 2^21 66; the entry point
// reports the number it issued.
//
// What bounds it on this card: any sort must read and write each key once,
// 8 bytes per key at 3.35 TB/s (2.1 us for 879,296 keys). The network moves
// far more: each global substage reads and writes all P keys (45 passes of
// 8 MB at P = 2^20), each tile launch once more, and does P/2 * log2(P) *
// (log2(P) + 1) / 2 compare-exchanges. What the design does about it: the
// log2(kTile) * (log2(kTile) + 1) / 2 = 66 substages of the first launch and
// the 11 last substages of every later stage run in shared memory, so device
// memory sees 1 + 2 * (number of stages above the tile) + the global
// substages' passes instead of one per substage. A radix sort (CUB's, which
// torch.sort calls) moves each key a few times; that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;            // keys per shared-memory tile
constexpr int kTileThreads = kTile / 2;  // one compare-exchange pair per thread
constexpr int kGlobalThreads = 256;

// Compare-exchange of s[i] and s[i + j] (i has bit j clear): ascending where
// bit k of the global index gi of i is 0, descending where it is 1.
__device__ __forceinline__ void exchange(int32_t* s, int i, int j, int gi, int k) {
  const int32_t a = s[i];
  const int32_t b = s[i + j];
  const bool ascending = (gi & k) == 0;
  if ((a > b) == ascending) {
    s[i] = b;
    s[i + j] = a;
  }
}

// Every substage j = j_top, j_top / 2, ..., 1 of stage k on the shared tile.
__device__ __forceinline__ void tile_substages(int32_t* s, int tile, int base, int k,
                                               int j_top) {
  for (int j = j_top; j >= 1; j >>= 1) {
    for (int t = threadIdx.x; t < tile / 2; t += blockDim.x) {
      const int i = 2 * t - (t & (j - 1));   // the pair's lower index: bit j clear
      exchange(s, i, j, base + i, k);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kTileThreads)
tile_sort(const int32_t* __restrict__ src, int n, int32_t* __restrict__ keys, int tile) {
  __shared__ int32_t s[kTile];
  const int base = blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x)
    s[i] = base + i < n ? src[base + i] : INT32_MAX;
  __syncthreads();
  for (int k = 2; k <= tile; k <<= 1) tile_substages(s, tile, base, k, k >> 1);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) keys[base + i] = s[i];
}

__global__ void __launch_bounds__(kTileThreads)
tile_merge(int32_t* __restrict__ keys, int k) {
  __shared__ int32_t s[kTile];
  const int base = blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) s[i] = keys[base + i];
  __syncthreads();
  tile_substages(s, kTile, base, k, kTile / 2);
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) keys[base + i] = s[i];
}

__global__ void __launch_bounds__(kGlobalThreads)
global_substage(int32_t* __restrict__ keys, int pairs, int k, int j) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const int i = 2 * t - (t & (j - 1));
  exchange(keys, i, j, i, k);
}

}  // namespace

// Plain C entry point: src holds n keys (device memory), keys is the scratch
// buffer of p = a power of two >= max(n, 2) keys (device memory; p <= 2^30),
// sorted in place on the given CUDA stream. *launches (host memory) receives
// the number of kernels launched. Returns the first nonzero
// cudaGetLastError() after a launch (0 on success); it does not synchronise
// and allocates nothing.
extern "C" int artalk_sort_keys(const int32_t* src, int n, int32_t* keys, int p,
                                void* stream, int* launches) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = p < kTile ? p : kTile;
  const int tile_threads = tile / 2 < kTileThreads ? tile / 2 : kTileThreads;
  *launches = 0;
  tile_sort<<<p / tile, tile_threads, 0, s>>>(src, n, keys, tile);
  ++*launches;
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int pairs = p / 2;
  const int blocks = (pairs + kGlobalThreads - 1) / kGlobalThreads;
  for (int64_t k = 2 * kTile; k <= p; k <<= 1) {   // 64-bit: k reaches 2p
    for (int j = static_cast<int>(k >> 1); j >= kTile; j >>= 1) {
      global_substage<<<blocks, kGlobalThreads, 0, s>>>(keys, pairs, static_cast<int>(k), j);
      ++*launches;
      err = static_cast<int>(cudaGetLastError());
      if (err != 0) return err;
    }
    tile_merge<<<p / kTile, kTileThreads, 0, s>>>(keys, static_cast<int>(k));
    ++*launches;
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}
