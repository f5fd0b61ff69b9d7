// Ascending sort of int32 keys by an LSD radix sort for Hopper (sm_90a),
// bound through ctypes.
//
// Replaces the Pallas TPU kernel tools/exp_pallas_sort.py:_bitonic_kernel
// (lines 61-112, launched by bitonic_sort() at its pl.pallas_call): a
// payload-free ascending sort of int32 keys, compared as signed integers. In
// the port it sorts the instance keys of the splat prepass
// (ops/gsplat.py:_build_instances; jax.lax.sort in artalk_tpu/ops/gsplat.py).
// The TPU kernel is a bitonic network because a TPU core has no scatter; a
// sort's output is a permutation, so any algorithm that sorts gives the same
// keys, and on this card a radix sort moves each key a few times where the
// network moved it once per substage.
//
// The key's sign bit is flipped, so that signed order becomes the unsigned
// order of u = key ^ 0x80000000; u is sorted by its four 8-bit digits, least
// significant first, each pass a stable counting sort. Any length n is taken
// and nothing is padded. Launches, all on the caller's stream (the entry
// point reports them):
//   1. radix_init: zero the digit histograms and the tile counters;
//   2. radix_histogram: the histogram of every digit position in one read of
//      the keys (shared-memory counts per CTA, added to device memory); it
//      also zeroes the look-back status words of the passes;
//   3. radix_pass, once per digit (4 launches): a "onesweep" pass. Each CTA
//      takes the next tile of kTile keys (its tile number from an atomic
//      counter, so a tile's predecessors have all started), ranks its keys
//      by digit in shared memory (per-warp digit counters and
//      __match_any_sync: a stable rank in input order), publishes its digit
//      counts, and finds the keys of every earlier tile by decoupled
//      look-back over their published counts (kWindow tiles a read). The
//      keys are reordered by digit in shared memory and written to their
//      places in runs per digit.
// A pass whose digit is the same for every key (a histogram bin holding all n
// keys) returns at once on the device: the avatar's keys are below 2^25, so
// their top digit is constant and three passes remain. The passes ping-pong
// between the output and a scratch buffer, chosen from the count of passes
// that remain so that the last one writes the output; if none remains (all
// keys equal) the last pass launch copies the input. 6 launches a sort.
//
// What bounds it on this card: the bytes. Any sort reads and writes each key
// once, 8 bytes a key at 3.35 TB/s (2.1 us for 879,296 keys); this one reads
// the keys 1 + (passes) times and writes them (passes) times, about 28 MB at
// 879,296 keys with three passes (8 us). What the design does about it: one
// read for all histograms, one launch per pass with the cross-tile scan done by
// look-back inside it (no separate scan or scatter launches), and no padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBits = 8;
constexpr int kDigits = 1 << kBits;
constexpr int kPasses = 32 / kBits;
constexpr int kThreads = 256;                // one thread per digit in the scans
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 15;                   // keys per thread
constexpr int kTile = kThreads * kItems;     // keys per CTA of a pass
constexpr int kHistThreads = 256;
constexpr int kWindow = 16;                  // earlier tiles read at once in the look-back
constexpr uint32_t kFlagAggregate = 1u << 30;   // the tile's own counts
constexpr uint32_t kFlagPrefix = 1u << 31;      // counts of this and every earlier tile
constexpr uint32_t kValueMask = kFlagAggregate - 1;
constexpr uint32_t kSign = 0x80000000u;

static_assert(kThreads == kDigits, "one thread per digit");

__device__ __forceinline__ uint32_t digit_of(int32_t key, int pass) {
  return ((static_cast<uint32_t>(key) ^ kSign) >> (pass * kBits)) & (kDigits - 1);
}

// Exclusive prefix sum of one value per thread over the CTA (kThreads).
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  uint32_t before = 0;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  __syncthreads();  // s_warp may be reused by the caller
  return before + x - v;
}

__global__ void radix_init(uint32_t* __restrict__ meta, int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) meta[i] = 0;
}

// hist[pass][digit] += the keys of this CTA's grid-stride share; also zeroes
// the passes' status words (read only by the later launches).
__global__ void __launch_bounds__(kHistThreads)
radix_histogram(const int32_t* __restrict__ keys, int n, uint32_t* __restrict__ hist,
                uint32_t* __restrict__ status, long long status_words) {
  __shared__ uint32_t s_hist[kPasses][kDigits];
  for (int i = threadIdx.x; i < kPasses * kDigits; i += blockDim.x) (&s_hist[0][0])[i] = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = first; i < status_words; i += stride) status[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    const unsigned active = __ballot_sync(0xffffffffu, valid);
    const int32_t key = valid ? keys[i] : 0;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const uint32_t d = digit_of(key, p);
      // a digit shared by the whole warp (a constant or clustered digit) is
      // one shared-memory add, not 32 on one address
      const uint32_t first_d = __shfl_sync(0xffffffffu, d, __ffs(active) - 1);
      if (active == 0xffffffffu && __all_sync(0xffffffffu, d == first_d)) {
        if (lane == 0) atomicAdd(&s_hist[p][d], 32u);
      } else if (valid) {
        atomicAdd(&s_hist[p][d], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPasses * kDigits; i += blockDim.x) {
    const uint32_t c = (&s_hist[0][0])[i];
    if (c) atomicAdd(&hist[i], c);
  }
}

__global__ void __launch_bounds__(kThreads)
radix_pass(const int32_t* __restrict__ input, int32_t* __restrict__ out,
           int32_t* __restrict__ tmp, int n, int pass, const uint32_t* __restrict__ hist,
           uint32_t* __restrict__ counter, uint32_t* __restrict__ status) {
  __shared__ uint32_t s_warp_hist[kWarps][kDigits];  // per-warp counts, then offsets
  __shared__ uint32_t s_tile_excl[kDigits];   // this tile's keys of smaller digits
  __shared__ uint32_t s_dst_base[kDigits];    // output index of this tile's first key of d
  __shared__ uint32_t s_scan[kWarps];
  __shared__ int32_t s_keys[kTile];
  __shared__ int s_tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t d_self = tid;   // the digit this thread scans

  // Which passes run: a digit that is the same for every key is skipped.
  int remaining = 0, before = 0;
  bool run_this = false;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const bool constant = __syncthreads_or(hist[p * kDigits + d_self] == static_cast<uint32_t>(n));
    if (!constant) {
      if (p < pass) ++before;
      if (p == pass) run_this = true;
      ++remaining;
    }
  }
  if (!run_this) {
    if (pass == kPasses - 1 && remaining == 0) {   // all keys equal: the output is the input
      for (long long i = static_cast<long long>(blockIdx.x) * kThreads + tid; i < n;
           i += static_cast<long long>(gridDim.x) * kThreads)
        out[i] = input[i];
    }
    return;
  }
  // Passes that run are numbered 0 .. remaining - 1; pass j writes the output
  // when remaining - 1 - j is even, the scratch buffer otherwise.
  const int32_t* src = before == 0 ? input : (((remaining - before) & 1) ? tmp : out);
  int32_t* dst = ((remaining - 1 - before) & 1) ? tmp : out;

  if (tid == 0) s_tile = static_cast<int>(atomicAdd(&counter[pass], 1u));
  for (int i = tid; i < kWarps * kDigits; i += kThreads) (&s_warp_hist[0][0])[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  const long long tile_base = static_cast<long long>(tile) * kTile;

  // keys in input order: warp w holds tile keys [w * 32 * kItems, ...), item i
  // of lane l is key w * 32 * kItems + i * 32 + l (coalesced loads)
  int32_t keys[kItems];
  uint32_t digits[kItems], ranks[kItems];
  const long long warp_base = tile_base + static_cast<long long>(warp) * 32 * kItems;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long idx = warp_base + i * 32 + lane;
    keys[i] = idx < n ? src[idx] : 0;
    digits[i] = idx < n ? digit_of(keys[i], pass) : kDigits;   // kDigits: no key
  }

  // stable rank within the warp: peers of one digit counted in lane order
  const unsigned lanemask_lt = (1u << lane) - 1;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const uint32_t d = digits[i];
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int leader = __ffs(peers) - 1;
    uint32_t base = 0;
    if (lane == leader && d < kDigits) {
      base = s_warp_hist[warp][d];
      s_warp_hist[warp][d] = base + __popc(peers);
    }
    base = __shfl_sync(0xffffffffu, base, leader);
    ranks[i] = base + __popc(peers & lanemask_lt);
    __syncwarp();
  }
  __syncthreads();

  // per digit: warp offsets within the tile and the tile's count
  uint32_t count = 0;
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = s_warp_hist[w][d_self];
    s_warp_hist[w][d_self] = count;
    count += c;
  }

  // publish this tile's count of d_self, then look back for the earlier tiles'
  volatile uint32_t* my_status =
      status + (static_cast<long long>(pass) * gridDim.x + tile) * kDigits + d_self;
  *my_status = count | (tile == 0 ? kFlagPrefix : kFlagAggregate);
  // The look-back reads kWindow earlier tiles' words at once (one latency
  // for the window), then adds them from the nearest back, waiting on a word
  // not yet published, until a tile's inclusive count ends the walk. All
  // tiles of a pass run at once, so a walk one tile at a time would take
  // about tiles / 2 dependent reads of L2.
  uint32_t prefix = 0;
  if (tile > 0) {
    const volatile uint32_t* column =
        status + static_cast<long long>(pass) * gridDim.x * kDigits + d_self;
    bool done = false;
    for (int t = tile - 1; !done; t -= kWindow) {
      uint32_t words[kWindow];
#pragma unroll
      for (int j = 0; j < kWindow; ++j)   // past tile 0: an inclusive count of 0
        words[j] = t - j >= 0 ? column[static_cast<long long>(t - j) * kDigits] : kFlagPrefix;
#pragma unroll
      for (int j = 0; j < kWindow; ++j) {
        if (!done) {
          uint32_t word = words[j];
          while ((word & (kFlagAggregate | kFlagPrefix)) == 0)
            word = column[static_cast<long long>(t - j) * kDigits];
          prefix += word & kValueMask;
          done = (word & kFlagPrefix) != 0;
        }
      }
    }
    *my_status = (prefix + count) | kFlagPrefix;
  }

  // global start of digit d_self: every key of a smaller digit
  const uint32_t total = hist[pass * kDigits + d_self];
  const uint32_t global_excl = block_exclusive_scan(total, s_scan);
  const uint32_t tile_excl = block_exclusive_scan(count, s_scan);
  s_tile_excl[d_self] = tile_excl;
  s_dst_base[d_self] = global_excl + prefix;
  __syncthreads();

  // reorder the tile by digit in shared memory
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const uint32_t d = digits[i];
    if (d < kDigits) s_keys[s_tile_excl[d] + s_warp_hist[warp][d] + ranks[i]] = keys[i];
  }
  __syncthreads();

  // write runs of equal digits to their places
  const long long left = n - tile_base;
  const int valid = left < kTile ? static_cast<int>(left) : kTile;
  for (int j = tid; j < valid; j += kThreads) {
    const int32_t key = s_keys[j];
    const uint32_t d = digit_of(key, pass);
    dst[s_dst_base[d] + (j - s_tile_excl[d])] = key;
  }
}

}  // namespace

// 32-bit words of the device scratch the entry point needs for n keys, beside the
// n-key ping-pong buffer: 4 x 256 histogram words, 4 tile counters and
// 4 x tiles x 256 look-back status words.
extern "C" long long artalk_sort_meta_words(int n) {
  const long long tiles = (static_cast<long long>(n) + kTile - 1) / kTile;
  return kPasses * kDigits + kPasses + kPasses * tiles * kDigits;
}

// Plain C entry point: keys holds n >= 1 keys (device memory; n < 2^30), out
// receives them sorted, tmp is a scratch buffer of n keys and meta one of
// artalk_sort_meta_words(n) 32-bit words (device memory, contents unused), on
// the given CUDA stream. *launches (host memory) receives the number of
// kernels launched. Returns the first nonzero cudaGetLastError() after a
// launch (0 on success); it does not synchronise and allocates nothing.
extern "C" int artalk_sort_keys(const int32_t* keys, int n, int32_t* out, int32_t* tmp,
                                uint32_t* meta, void* stream, int* launches) {
  *launches = 0;
  if (n < 1 || n >= static_cast<int>(kValueMask)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kTile - 1) / kTile;
  uint32_t* hist = meta;
  uint32_t* counter = meta + kPasses * kDigits;
  uint32_t* status = counter + kPasses;
  const long long status_words = static_cast<long long>(kPasses) * tiles * kDigits;

  radix_init<<<1, 1024, 0, s>>>(meta, kPasses * kDigits + kPasses);
  ++*launches;
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  int hist_blocks = (n + kHistThreads * 16 - 1) / (kHistThreads * 16);
  hist_blocks = hist_blocks < 1 ? 1 : (hist_blocks > 528 ? 528 : hist_blocks);
  radix_histogram<<<hist_blocks, kHistThreads, 0, s>>>(keys, n, hist, status, status_words);
  ++*launches;
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  for (int p = 0; p < kPasses; ++p) {
    radix_pass<<<tiles, kThreads, 0, s>>>(keys, out, tmp, n, p, hist, counter, status);
    ++*launches;
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}
