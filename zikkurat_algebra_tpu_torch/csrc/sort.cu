// Kernel K3: the MSM's grouping sort, a stable LSD radix sort of int32 keys
// along each row, carrying R int32 payload rows.
//
// Replaces: zikkurat_algebra_tpu/ops/pallas_sort.py, `_build_local`
// (pallas_call at :107) reached from `sort_key_val_pallas` (:132), with
// `_local_sort_kernel`, `_local_merge_kernel` and the XLA cross-tile passes
// (:117).  The TPU kernel is a bitonic network (unstable, n a power of two)
// because a TPU has no scatter.  Here the sort is a counting sort by 8-bit
// digits, least significant first, ceil(key_bits / 8) passes, which needs
// scattered stores and is stable; any n >= 1 is accepted.
//
// The design follows Onesweep (Adinets and Merrill 2022, arXiv 2206.01784).
// Keys (wc, n) are non-negative and below 2^key_bits (the wrapper checks);
// payload (R, wc, n).  One call makes 3 + passes launches:
//   1. upsweep: each CTA reads 8192 keys of one row once and counts every
//      pass's digit in shared memory, then adds its counts into the row's
//      (passes, 256) histogram with one global atomic per bin;
//   2. scan:    one CTA per (row, pass) turns the 256 counts into the
//      exclusive start of each digit in the row;
//   3. one kernel per pass.  A CTA takes the next tile of its row (3840
//      keys, 15 per thread) from a per-row atomic counter, so every tile
//      before it belongs to a CTA that is already running and the look-back
//      below always progresses.  Each warp ranks its 480 contiguous keys
//      with __match_any_sync and a per-warp digit counter in shared memory
//      (input order within a warp, then warp order: stable).  Thread d then
//      publishes the tile's count of digit d (flag A, or P for tile 0) and
//      looks back over the earlier tiles' words until it meets an inclusive
//      prefix (flag P), publishing its own.  The keys go to shared memory in
//      the tile's sorted order and leave it in that order, so consecutive
//      threads store consecutive addresses of a digit's run; each payload
//      row follows through the same slots.
// Passes ping-pong between two buffer pairs so that the last pass writes
// the output and the input is left as it is.  The scratch (histograms, tile
// counters, look-back words) is zeroed by one memset per call.
//
// Bound on the H100: bytes.  The function reads keys and payload once and
// writes them once; this design reads the keys once more (the upsweep) and
// each pass reads and writes keys and payload once, plus 8 bytes of
// look-back word per (tile, digit).  Nothing else goes through device
// memory: histograms, ranks and the reordering stay in shared memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRadix = 256;
constexpr int kThreads = 256;              // == kRadix: one digit per thread
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 15;             // keys per thread in a pass tile
constexpr int kWarpKeys = 32 * kPerThread; // contiguous positions per warp
constexpr int kTile = kThreads * kPerThread;
constexpr int kUpTile = 8192;              // positions per upsweep CTA
constexpr int kMaxPasses = 4;              // key_bits <= 31

// Look-back word: the count in the low 32 bits, the state above them.
constexpr unsigned long long kFlagA = 1ull << 32;  // this tile's count only
constexpr unsigned long long kFlagP = 2ull << 32;  // count through this tile

// Exclusive prefix sum of v over the CTA's kThreads threads.  s_warp holds
// kWarps words; every thread must call.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  uint32_t before = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    if (i < warp) before += s_warp[i];
  }
  __syncthreads();
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads)
upsweep_kernel(const int32_t* __restrict__ keys, uint32_t* __restrict__ hist,
               int n, int passes) {
  __shared__ uint32_t h[kMaxPasses][kRadix];
  for (int i = threadIdx.x; i < kMaxPasses * kRadix; i += kThreads) {
    (&h[0][0])[i] = 0u;
  }
  __syncthreads();
  const int32_t* kw = keys + static_cast<long long>(blockIdx.y) * n;
  const long long start = static_cast<long long>(blockIdx.x) * kUpTile;
  const long long end = min(start + kUpTile, static_cast<long long>(n));
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const uint32_t k = static_cast<uint32_t>(kw[i]);
    for (int p = 0; p < passes; ++p) {
      atomicAdd(&h[p][(k >> (8 * p)) & (kRadix - 1)], 1u);
    }
  }
  __syncthreads();
  uint32_t* hw = hist + static_cast<long long>(blockIdx.y) * passes * kRadix;
  for (int p = 0; p < passes; ++p) {
    const uint32_t c = h[p][threadIdx.x];
    if (c) atomicAdd(&hw[p * kRadix + threadIdx.x], c);
  }
}

// One CTA per (pass, row): counts -> exclusive start of each digit.
__global__ void __launch_bounds__(kThreads)
scan_kernel(uint32_t* __restrict__ hist, int passes) {
  __shared__ uint32_t s_warp[kWarps];
  uint32_t* h = hist +
      (static_cast<long long>(blockIdx.y) * passes + blockIdx.x) * kRadix;
  h[threadIdx.x] = block_exclusive_scan(h[threadIdx.x], s_warp);
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// At most 64 registers, so that 4 CTAs (1024 threads) share an SM.
__global__ void __launch_bounds__(kThreads, 4)
pass_kernel(const int32_t* __restrict__ kin, const int32_t* __restrict__ pin,
            int32_t* __restrict__ kout, int32_t* __restrict__ pout,
            const uint32_t* __restrict__ starts,
            unsigned long long* __restrict__ status,
            uint32_t* __restrict__ tile_ctr, int wc, int n, int ntiles, int R,
            int pass, int passes) {
  __shared__ uint32_t s_whist[kWarps][kRadix];  // per-warp digit counters
  __shared__ int32_t s_buf[kTile];              // one row, in sorted order
  __shared__ uint32_t s_loff[kRadix];           // digit's start in the tile
  __shared__ uint32_t s_goff[kRadix];           // row position - tile slot
  __shared__ uint32_t s_warp[kWarps];
  __shared__ int s_tile;

  const int w = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(&tile_ctr[w], 1u));
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads) {
    (&s_whist[0][0])[i] = 0u;
  }
  __syncthreads();
  const int tile = s_tile;
  const long long row = static_cast<long long>(w) * n;
  const int shift = 8 * pass;
  const long long base =
      static_cast<long long>(tile) * kTile + warp * kWarpKeys + lane;

  // Load warp-striped (coalesced); -1 marks a position past the row's end.
  int32_t key[kPerThread];
  uint32_t slot[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const long long pos = base + 32 * i;
    key[i] = pos < n ? kin[row + pos] : -1;
  }
  // Rank inside the warp: earlier rounds, then lower lanes, come first.
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const bool valid = key[i] >= 0;
    const uint32_t d =
        valid ? (static_cast<uint32_t>(key[i]) >> shift) & (kRadix - 1)
              : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const uint32_t before = valid ? s_whist[warp][d] : 0u;
    __syncwarp();
    if (valid && (peers & lt) == 0u) s_whist[warp][d] = before + __popc(peers);
    __syncwarp();
    slot[i] = before + __popc(peers & lt);
  }
  __syncthreads();

  // Thread dig: the warps' counts of digit dig become exclusive prefixes.
  const int dig = threadIdx.x;
  uint32_t cnt = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    const uint32_t c = s_whist[v][dig];
    s_whist[v][dig] = cnt;
    cnt += c;
  }
  // Decoupled look-back over the earlier tiles of this row.  The last tile
  // has no successor and publishes nothing.
  unsigned long long* st =
      status + static_cast<long long>(w) * (ntiles - 1) * kRadix + dig;
  if (tile < ntiles - 1) {
    store_word(st + static_cast<long long>(tile) * kRadix,
               (tile == 0 ? kFlagP : kFlagA) | cnt);
  }
  uint32_t excl = 0;
  for (int j = tile - 1; j >= 0;) {
    const unsigned long long v = load_word(st + static_cast<long long>(j) *
                                                    kRadix);
    const unsigned long long state = v & ~0xffffffffull;
    if (state == 0) continue;                   // not published yet
    excl += static_cast<uint32_t>(v);
    if (state == kFlagP) break;
    --j;
  }
  if (tile > 0 && tile < ntiles - 1) {
    store_word(st + static_cast<long long>(tile) * kRadix,
               kFlagP | (excl + cnt));
  }
  const uint32_t loff = block_exclusive_scan(cnt, s_warp);
  s_loff[dig] = loff;
  s_goff[dig] =
      starts[(static_cast<long long>(w) * passes + pass) * kRadix + dig] +
      excl - loff;
  __syncthreads();

  // Keys into the tile's sorted order, then out in that order.
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (key[i] >= 0) {
      const uint32_t d = (static_cast<uint32_t>(key[i]) >> shift) &
                         (kRadix - 1);
      slot[i] += s_whist[warp][d] + s_loff[d];
      s_buf[slot[i]] = key[i];
    }
  }
  __syncthreads();
  const int tile_len = static_cast<int>(
      min(static_cast<long long>(kTile),
          n - static_cast<long long>(tile) * kTile));
  uint32_t gpos[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int s = i * kThreads + threadIdx.x;
    if (s < tile_len) {
      const int32_t k = s_buf[s];
      const uint32_t d = (static_cast<uint32_t>(k) >> shift) & (kRadix - 1);
      gpos[i] = s_goff[d] + s;
      kout[row + gpos[i]] = k;
    }
  }
  const long long pstride = static_cast<long long>(wc) * n;
  for (int r = 0; r < R; ++r) {
    __syncthreads();                            // s_buf is free again
    const int32_t* pr = pin + r * pstride + row;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (key[i] >= 0) s_buf[slot[i]] = pr[base + 32 * i];
    }
    __syncthreads();
    int32_t* po = pout + r * pstride + row;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int s = i * kThreads + threadIdx.x;
      if (s < tile_len) po[gpos[i]] = s_buf[s];
    }
  }
}

struct Layout {
  int ntiles, passes;
  long long hist_words, ctr_words, status_words, bytes;
};

Layout layout(int wc, int n, int key_bits) {
  Layout l;
  l.ntiles = (n + kTile - 1) / kTile;
  l.passes = (key_bits + 7) / 8;
  l.hist_words = static_cast<long long>(wc) * l.passes * kRadix;
  l.ctr_words = static_cast<long long>(wc) * l.passes;
  l.status_words = static_cast<long long>(l.passes) * wc * (l.ntiles - 1) *
                   kRadix;
  const long long head = (4 * (l.hist_words + l.ctr_words) + 7) / 8 * 8;
  l.bytes = head + 8 * l.status_words;
  return l;
}

bool valid_args(int wc, int n, int R, int key_bits) {
  return wc >= 1 && n >= 1 && R >= 0 && key_bits >= 1 && key_bits <= 31 &&
         wc <= 65535;
}

}  // namespace

// Bytes of scratch that zk_sort_key_val needs (0 for invalid arguments).
extern "C" long long zk_sort_scratch_bytes(int wc, int n, int key_bits) {
  if (!valid_args(wc, n, 0, key_bits)) return 0;
  return layout(wc, n, key_bits).bytes;
}

// Occupancy of the pass kernel: resident CTAs per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and CTAs per pass.
extern "C" int zk_sort_occupancy(int wc, int n, int* blocks_per_sm,
                                 long long* ctas) {
  if (!valid_args(wc, n, 0, 8)) return static_cast<int>(cudaErrorInvalidValue);
  *ctas = static_cast<long long>(wc) * layout(wc, n, 8).ntiles;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, pass_kernel, kThreads, 0));
}

// C entry point bound with ctypes.  Sorts keys (wc, n) with payload
// (R, wc, n) into kout / pout, using kt / pt as the second buffer pair and
// `scratch` (zk_sort_scratch_bytes) as scratch.  Returns a cudaError_t
// (0 = every launch accepted).
extern "C" int zk_sort_key_val(const void* keys, const void* payload,
                               void* kout, void* pout, void* kt, void* pt,
                               void* scratch, int wc, int n, int R,
                               int key_bits, void* stream) {
  if (!valid_args(wc, n, R, key_bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(wc, n, key_bits);
  auto hist = static_cast<uint32_t*>(scratch);
  uint32_t* ctr = hist + l.hist_words;
  auto status = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + (l.bytes - 8 * l.status_words));
  cudaError_t e = cudaMemsetAsync(scratch, 0, l.bytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  upsweep_kernel<<<dim3((n + kUpTile - 1) / kUpTile, wc), kThreads, 0, s>>>(
      static_cast<const int32_t*>(keys), hist, n, l.passes);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_kernel<<<dim3(l.passes, wc), kThreads, 0, s>>>(hist, l.passes);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int32_t* ksrc = static_cast<const int32_t*>(keys);
  const int32_t* psrc = static_cast<const int32_t*>(payload);
  const long long per_pass = static_cast<long long>(wc) * (l.ntiles - 1) *
                             kRadix;
  for (int pass = 0; pass < l.passes; ++pass) {
    // the last pass writes the output buffers, the one before the others
    const bool to_out = ((l.passes - 1 - pass) % 2) == 0;
    auto kdst = static_cast<int32_t*>(to_out ? kout : kt);
    auto pdst = static_cast<int32_t*>(to_out ? pout : pt);
    pass_kernel<<<dim3(l.ntiles, wc), kThreads, 0, s>>>(
        ksrc, psrc, kdst, pdst, hist, status + pass * per_pass,
        ctr + static_cast<long long>(pass) * wc, wc, n, l.ntiles, R, pass,
        l.passes);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ksrc = kdst;
    psrc = pdst;
  }
  return 0;
}
