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
// Keys (wc, n) are non-negative and below 2^key_bits (the wrapper checks);
// payload (R, wc, n).  Each pass has three launches:
//   1. hist:    per (tile of 2048 positions, row) a 256-bin histogram in
//               shared memory, written to counts[row, digit, tile];
//   2. scan:    per row, an exclusive scan of counts over (digit, tile), so
//               counts[row, d, t] becomes where tile t's first element of
//               digit d lands;
//   3. scatter: per (tile, row), the tile's elements in input order, 256 at
//               a time: __match_any_sync ranks equal digits inside a warp,
//               per-warp digit counts in shared memory rank them across the
//               block's warps, and a running base per digit carries over to
//               the next 256.  Equal digits keep their input order.
// Passes ping-pong between two buffer pairs so that the last pass writes
// the output and the input is left as it is.
//
// Bound on the H100: bytes.  The function reads keys and payload once and
// writes them once; each pass here reads and writes both, plus the counts
// (256 words per tile).  The design keeps the histogram and the ranking in
// shared memory and moves only keys and payload through device memory; the
// points themselves never move (K2 and K4 gather them by index).  Not tuned.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRadix = 256;
constexpr int kTile = 2048;
constexpr int kThreads = 256;          // == kRadix: one bin per thread
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ counts,
            int n, int ntiles, int shift) {
  __shared__ int h[kRadix];
  const int t = blockIdx.x;
  const int w = blockIdx.y;
  h[threadIdx.x] = 0;
  __syncthreads();
  const int32_t* kw = keys + static_cast<long long>(w) * n;
  const int start = t * kTile;
  const int end = min(start + kTile, n);
  for (int i = start + threadIdx.x; i < end; i += kThreads) {
    atomicAdd(&h[(kw[i] >> shift) & (kRadix - 1)], 1);
  }
  __syncthreads();
  counts[(static_cast<long long>(w) * kRadix + threadIdx.x) * ntiles + t] =
      h[threadIdx.x];
}

// One block per row: exclusive scan of the row's kRadix * ntiles counts.
__global__ void __launch_bounds__(1024)
scan_kernel(int32_t* __restrict__ counts, int len) {
  __shared__ int s[1024];
  int32_t* c = counts + static_cast<long long>(blockIdx.x) * len;
  const int per = (len + blockDim.x - 1) / blockDim.x;
  const int beg = min(static_cast<int>(threadIdx.x) * per, len);
  const int end = min(beg + per, len);
  int sum = 0;
  for (int i = beg; i < end; ++i) sum += c[i];
  s[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {     // Hillis-Steele
    const int v = threadIdx.x >= off ? s[threadIdx.x - off] : 0;
    __syncthreads();
    s[threadIdx.x] += v;
    __syncthreads();
  }
  int run = s[threadIdx.x] - sum;
  for (int i = beg; i < end; ++i) {
    const int v = c[i];
    c[i] = run;
    run += v;
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int32_t* __restrict__ kin, const int32_t* __restrict__ pin,
               int32_t* __restrict__ kout, int32_t* __restrict__ pout,
               const int32_t* __restrict__ counts, int wc, int n, int ntiles,
               int R, int shift) {
  __shared__ int base[kRadix];
  __shared__ int wcnt[kWarps][kRadix];
  const int t = blockIdx.x;
  const int w = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  base[threadIdx.x] =
      counts[(static_cast<long long>(w) * kRadix + threadIdx.x) * ntiles + t];
  const long long row = static_cast<long long>(w) * n;
  const long long pstride = static_cast<long long>(wc) * n;
  const int start = t * kTile;
  const int end = min(start + kTile, n);
  for (int c0 = start; c0 < end; c0 += kThreads) {
    for (int j = threadIdx.x; j < kWarps * kRadix; j += kThreads) {
      (&wcnt[0][0])[j] = 0;
    }
    __syncthreads();
    const int i = c0 + threadIdx.x;
    const bool valid = i < end;
    const int key = valid ? kin[row + i] : 0;
    // lanes past the end form a group of their own (digit kRadix)
    const int d = valid ? (key >> shift) & (kRadix - 1) : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (valid && rank == 0) wcnt[warp][d] = __popc(peers);
    __syncthreads();
    if (valid) {
      int pos = base[d] + rank;
      for (int v = 0; v < warp; ++v) pos += wcnt[v][d];
      kout[row + pos] = key;
      for (int r = 0; r < R; ++r) {
        pout[r * pstride + row + pos] = pin[r * pstride + row + i];
      }
    }
    __syncthreads();
    int s = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) s += wcnt[v][threadIdx.x];
    base[threadIdx.x] += s;
    __syncthreads();
  }
}

}  // namespace

// C entry point bound with ctypes.  Sorts keys (wc, n) with payload
// (R, wc, n) into kout / pout, using kt / pt as the second buffer pair and
// counts (wc, 256, ceil(n / 2048)) as scratch.  Returns a cudaError_t
// (0 = every launch accepted).
extern "C" int zk_sort_key_val(const void* keys, const void* payload,
                               void* kout, void* pout, void* kt, void* pt,
                               void* counts, int wc, int n, int R,
                               int key_bits, void* stream) {
  if (wc < 1 || n < 1 || R < 0 || key_bits < 1 || key_bits > 31 ||
      wc > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int ntiles = (n + kTile - 1) / kTile;
  const int passes = (key_bits + 7) / 8;
  auto C = static_cast<int32_t*>(counts);
  const int32_t* ksrc = static_cast<const int32_t*>(keys);
  const int32_t* psrc = static_cast<const int32_t*>(payload);
  for (int pass = 0; pass < passes; ++pass) {
    // the last pass writes the output buffers, the one before the others
    const bool to_out = ((passes - 1 - pass) % 2) == 0;
    auto kdst = static_cast<int32_t*>(to_out ? kout : kt);
    auto pdst = static_cast<int32_t*>(to_out ? pout : pt);
    const int shift = 8 * pass;
    const dim3 grid(ntiles, wc);
    hist_kernel<<<grid, kThreads, 0, s>>>(ksrc, C, n, ntiles, shift);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    scan_kernel<<<wc, 1024, 0, s>>>(C, kRadix * ntiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    scatter_kernel<<<grid, kThreads, 0, s>>>(ksrc, psrc, kdst, pdst, C, wc, n,
                                             ntiles, R, shift);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ksrc = kdst;
    psrc = pdst;
  }
  return 0;
}
