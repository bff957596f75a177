// Kernel K5: stages s0+1 .. s0+k of a radix-2 decimation-in-time NTT in
// ONE launch, in place, on a (W, B, S, lanes) limb-plane tensor, the
// stages run in shared memory.
//
// Replaces: zikkurat_algebra_tpu/ops/pallas_field.py, `_build_butterfly`
// (pallas_call at :130) reached from `butterfly_pallas` (:143), body
// `_butterfly_kernel` (:112): hi = u + v tw, lo = u - v tw on (L, N)
// radix-2^15 planes with lazy limbs, which ops/ntt.py:380 calls once per
// stage on operands it has gathered and broadcast to n/2.  Here stage s
// (half = 2^(s-1)) pairs row j of each block of 2 half rows of the S axis
// (u, j < half) with row j + half (v); u becomes u + v T_s[j] and v
// becomes u - v T_s[j], both canonical mod p (CIOS and add/sub of
// field.cuh), T_s the stage's (W, half) table.  `lanes` columns share each
// butterfly's twiddle: 1 for the radix-2 transform, the row length for
// the four-step column passes.
//
// Bound on the H100.  W = 8: operations.  A 2^20 transform needs one
// Montgomery product (4 W^2 + W = 264 multiply-adds) per pair per stage
// whose twiddle is not one: 20 stages of 2^19 pairs less the 2^20 - 1
// pairs with twiddle index 0 (every pair of stage 1), 9 2^20 + 1
// products, 0.149 ms at the card's integer rate, against 0.030 ms for one
// read and one write of x and one read of the stage tables.  W = 2:
// operations too (18 per product, 0.010 ms; bytes 0.0075 ms).  One launch
// per stage (this kernel's first design) moved x through device memory 20
// times.
//
// Design: stages s0+1 .. s0+k only combine rows whose indices differ in
// bits s0 .. s0+k-1, so the 2^k rows r_hi 2^(s0+k) + t 2^s0 + r_lo,
// t < 2^k, close under them: a GROUP.  A CTA loads a tile of whole groups
// into shared memory, runs the k stages there and writes the tile back:
// one round trip through device memory per pass.  The tile is 2^log_g
// groups x 2^k rows x C consecutive columns of the span L = 2^(s0 +
// log2 lanes) that separates a group's rows (column = r_lo lanes + lane).
// When L fits (the first pass of the radix-2 transform, L = 1), C = L and
// the tile is one contiguous run of memory; else C = 2^(log_tile - k)
// consecutive columns, and ops/kernel_ntt.py's `pass_plan` keeps C >= 32,
// so every limb plane moves in runs of at least 128 bytes.  The tile
// holds 2^log_tile elements, a launch argument (ops/kernel_ntt.py
// `TILE_LOG`): 2^10 at W = 8 (32 KB; 3 CTAs of 256 threads per SM), 2^13
// at W = 2 (64 KB; one CTA of 1024 threads); a 2^20
// transform is 3 passes (10 + 5 + 5 stages) at W = 8 and 2 (13 + 7) at
// W = 2.  Within a pass the stages run in ROUNDS of kRadixLog stages
// between two __syncthreads(): a thread takes the 2^kRadixLog rows of a
// group that those stages combine into registers, runs the stages there
// and stores them back (W = 2: 3 stages per round; W = 8: 1, as two
// spill).  Shared memory keeps limb planes ([W][tile]) under an XOR
// swizzle (swz) that spreads a warp's rows over the 32 banks.  Twiddles
// are read from the stage tables in device memory (L1 / L2), W words per
// butterfly, consecutive for consecutive columns; stage 1's product is
// skipped where its twiddle is one.  The bound above also counts the
// products by twiddle index 0 of later stages as free; the kernel does
// them.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

// The threads of a CTA, the CTAs per SM the register cap leaves room for
// and the stages a thread runs per round (on 2^kRadixLog rows in registers
// between two __syncthreads()), per width.  The tile's size is a launch
// argument.
template <int W> struct Cfg;
template <> struct Cfg<8> {
  static constexpr int kThreads = 256, kMinCtas = 3;
  static constexpr int kRadixLog = 1;   // stages a thread runs per round
};
template <> struct Cfg<2> {
  static constexpr int kThreads = 1024, kMinCtas = 1;
  static constexpr int kRadixLog = 3;
};
constexpr int kMaxStages = 16;        // the stage tables a launch takes

struct Tables {
  const int32_t* tw[kMaxStages];      // stage s0 + 1 + i: (W, 2^(s0 + i))
};

// Tile word a is kept at a ^ M(a >> 5), M the XOR of 31, 21, 25 and 17
// for bits 5, 6, 7 and 8 of a.  A round of radix 2^R (R <= 4) gives each
// of a warp's 32 threads the 2^R rows that differ in tile bits b0 ..
// b0 + R - 1; where b0 < 5 the warp's row c of every group spans up to
// 32 2^R words, and M spreads them over 32 banks, for every R <= 4, b0
// and c; aligned runs of 32 words stay aligned runs.
__device__ __forceinline__ int swz(int a) {
  return a ^ (((a >> 5) & 1) * 31) ^ (((a >> 6) & 1) * 21) ^
         (((a >> 7) & 1) * 25) ^ (((a >> 8) & 1) * 17);
}

template <int W>
__device__ __forceinline__ void lds(uint32_t (&r)[W], const uint32_t* sm,
                                    int tile, int i) {
#pragma unroll
  for (int l = 0; l < W; ++l) r[l] = sm[l * tile + i];
}

template <int W>
__device__ __forceinline__ void sts(uint32_t* sm, const uint32_t (&r)[W],
                                    int tile, int i) {
#pragma unroll
  for (int l = 0; l < W; ++l) sm[l * tile + i] = r[l];
}

// Entry j of a stage table of `half` entries.
template <int W>
__device__ __forceinline__ void twiddle(uint32_t (&w)[W],
                                        const int32_t* __restrict__ tw,
                                        uint32_t half, uint32_t j) {
#pragma unroll
  for (int l = 0; l < W; ++l)
    w[l] = static_cast<uint32_t>(__ldg(tw + l * half + j));
}

// u, v <- u + v w, u - v w; with `unit` (w is one) the product is skipped.
template <int W>
__device__ __forceinline__ void butterfly(uint32_t (&u)[W], uint32_t (&v)[W],
                                          const uint32_t (&w)[W],
                                          const uint32_t (&p)[W], uint32_t n0,
                                          bool unit) {
  if (!unit) zk::mont_mul<W>(v, v, w, p, n0);
  uint32_t t[W];
  zk::sub_mod<W>(t, u, v, p);
  zk::add_mod<W>(u, u, v, p);
  zk::copy<W>(v, t);
}

// Stages st .. st + R - 1 on the tile: each thread takes groups of the
// 2^R rows that differ in tile bits b0 = st + log_c .. b0 + R - 1, holds
// them in registers and runs the R stages on them.  Stage st + q pairs
// rows c and c + 2^q (bit q of c clear) with entry (jl + (c mod 2^q) 2^st)
// 2^s0 + r of its table, jl the group's tile bits log_c .. b0 - 1 and r
// its column's row bits.  Rounds of R run while R stages are left, then
// smaller ones.
template <int W, int R>
__device__ __forceinline__ void rounds(uint32_t* sm, int tile,
                                       const Tables& tabs,
                                       const uint32_t (&p)[W], uint32_t n0,
                                       bool unit1, int st, int k, int s0,
                                       int log_c, int log_lanes,
                                       long long col0) {
  constexpr int G = 1 << R;
  const int cmask = (1 << log_c) - 1;
  for (; st + R <= k; st += R) {
    const int b0 = st + log_c;
    for (int g = threadIdx.x; g < (tile >> R); g += Cfg<W>::kThreads) {
      const int base = ((g >> b0) << (b0 + R)) | (g & ((1 << b0) - 1));
      const uint32_t jl = (g >> log_c) & ((1 << st) - 1);
      const uint32_t r = static_cast<uint32_t>((col0 + (g & cmask)) >>
                                               log_lanes);
      uint32_t xs[G][W];
#pragma unroll
      for (int c = 0; c < G; ++c)
        lds<W>(xs[c], sm, tile, swz(base | (c << b0)));
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int32_t* __restrict__ tw = tabs.tw[st + q];
        const uint32_t half = 1u << (s0 + st + q);
        const bool unit = unit1 && st + q == 0;
#pragma unroll
        for (int c = 0; c < G; ++c) {
          if (c & (1 << q)) continue;
          uint32_t w[W];
          twiddle<W>(w, tw, half,
                     ((jl + ((c & ((1 << q) - 1)) << st)) << s0) | r);
          butterfly<W>(xs[c], xs[c | (1 << q)], w, p, n0, unit);
        }
      }
#pragma unroll
      for (int c = 0; c < G; ++c)
        sts<W>(sm, xs[c], tile, swz(base | (c << b0)));
    }
    __syncthreads();
  }
  if constexpr (R > 1)
    rounds<W, R - 1>(sm, tile, tabs, p, n0, unit1, st, k, s0, log_c,
                     log_lanes, col0);
}

template <int W>
__global__ void __launch_bounds__(Cfg<W>::kThreads, Cfg<W>::kMinCtas)
ntt_pass_kernel(int32_t* __restrict__ x, const __grid_constant__ Tables tabs,
                const int32_t* __restrict__ pp,
                const int32_t* __restrict__ one, uint32_t n0, long long n,
                int s0, int k, int log_lanes, int log_span, int log_c,
                int log_g, long long outer, int log_cb) {
  constexpr int kThreads = Cfg<W>::kThreads;
  extern __shared__ uint32_t sm[];            // [W][tile], swizzled
  const int log_tile = log_g + k + log_c;
  const int tile = 1 << log_tile;
  const int cmask = (1 << log_c) - 1;
  const int tmask = (1 << k) - 1;
  const long long col0 =
      (static_cast<long long>(blockIdx.x) & ((1LL << log_cb) - 1)) << log_c;
  const long long g0 =
      (static_cast<long long>(blockIdx.x) >> log_cb) << log_g;

  // tile index q = (g, t, c) <-> element ((g0 + g) 2^k + t) L + col0 + c
#pragma unroll 4
  for (int q = threadIdx.x; q < tile; q += kThreads) {
    const long long g = g0 + (q >> (log_c + k));
    if (g >= outer) continue;
    const long long e = ((g << k) + ((q >> log_c) & tmask)) << log_span;
    const long long ec = e + col0 + (q & cmask);
    const int sq = swz(q);
#pragma unroll
    for (int l = 0; l < W; ++l)
      sm[l * tile + sq] = static_cast<uint32_t>(x[l * n + ec]);
  }
  uint32_t p[W];
#pragma unroll
  for (int l = 0; l < W; ++l) p[l] = static_cast<uint32_t>(__ldg(pp + l));
  // stage 1's table is one entry; where it is one (R mod p), as in every
  // NTT, its products are skipped: v * one = v exactly.
  bool unit1 = s0 == 0;
#pragma unroll
  for (int l = 0; l < W; ++l)
    unit1 = unit1 && __ldg(tabs.tw[0] + l) == __ldg(one + l);
  __syncthreads();

  rounds<W, Cfg<W>::kRadixLog>(sm, tile, tabs, p, n0, unit1, 0, k, s0,
                                log_c, log_lanes, col0);

#pragma unroll 4
  for (int q = threadIdx.x; q < tile; q += kThreads) {
    const long long g = g0 + (q >> (log_c + k));
    if (g >= outer) continue;
    const long long e = ((g << k) + ((q >> log_c) & tmask)) << log_span;
    const long long ec = e + col0 + (q & cmask);
    const int sq = swz(q);
#pragma unroll
    for (int l = 0; l < W; ++l)
      x[l * n + ec] = static_cast<int32_t>(sm[l * tile + sq]);
  }
}

// The tile of one launch: log2 of its columns C, of its groups, of the
// column blocks across the span, the groups in all, and the CTAs.
struct Shape {
  int log_c, log_g, log_cb;
  long long outer, ctas;
};

Shape shape(int log_tile, long long nbatch, int log_rows, int log_lanes,
            int s0, int k) {
  Shape sh;
  const int span = s0 + log_lanes;
  sh.log_c = span < log_tile - k ? span : log_tile - k;
  sh.log_cb = span - sh.log_c;
  sh.outer = nbatch << (log_rows - s0 - k);
  sh.log_g = log_tile - k - sh.log_c;
  while (sh.log_g > 0 && (1LL << (sh.log_g - 1)) >= sh.outer) --sh.log_g;
  sh.ctas = ((sh.outer + (1LL << sh.log_g) - 1) >> sh.log_g) << sh.log_cb;
  return sh;
}

// Lets ntt_pass_kernel<W> take `bytes` of dynamic shared memory, above
// the default 48 KB.  The attribute belongs to the kernel on a device, so
// it is raised only when a launch needs more than before (no host time
// between the passes); CUDA refuses more than the device's cap.
template <int W>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed[64] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess || (dev < 64 && bytes <= allowed[dev])) return rc;
  rc = cudaFuncSetAttribute(ntt_pass_kernel<W>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(bytes));
  if (rc == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return rc;
}

size_t tile_bytes(int W, int log_tile) {
  return sizeof(uint32_t) * W << log_tile;
}

template <int W>
cudaError_t occupancy(int log_tile, int* per_sm) {
  const size_t smem = tile_bytes(W, log_tile);
  const cudaError_t rc = allow_smem<W>(smem);
  if (rc != cudaSuccess) return rc;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, ntt_pass_kernel<W>, Cfg<W>::kThreads, smem);
}

template <int W>
cudaError_t launch(int32_t* x, const Tables& tabs, const int32_t* p,
                   const int32_t* one, uint32_t n0, long long nbatch,
                   int log_rows, int log_lanes, int s0, int k, int log_tile,
                   cudaStream_t stream) {
  const Shape sh = shape(log_tile, nbatch, log_rows, log_lanes, s0, k);
  const size_t smem = tile_bytes(W, sh.log_g + k + sh.log_c);
  const cudaError_t rc = allow_smem<W>(smem);
  if (rc != cudaSuccess) return rc;
  const long long n = nbatch << (log_rows + log_lanes);
  ntt_pass_kernel<W><<<static_cast<unsigned>(sh.ctas), Cfg<W>::kThreads, smem,
                       stream>>>(x, tabs, p, one, n0, n, s0, k, log_lanes,
                                 s0 + log_lanes, sh.log_c, sh.log_g, sh.outer,
                                 sh.log_cb);
  return cudaGetLastError();
}

}  // namespace

// C entry points bound with ctypes, instantiated for the widths of the
// fields with an FFT domain: W = 8 (the Fr of BN128, BLS12-381 and
// BLS12-377) and W = 2 (goldilocks).  x is (W, nbatch, 2^log_rows,
// 2^log_lanes); tw[i] the (W, 2^(s0+i)) table of stage s0 + 1 + i, for
// i < k; p the modulus and one = R mod p, W limbs each.  Runs stages
// s0 + 1 .. s0 + k, 1 <= k <= min(16, log_tile), on tiles of at most
// 2^log_tile elements (4 W 2^log_tile bytes of shared memory).
// Returns a cudaError_t (0 = launched).
extern "C" int zk_ntt_stages(void* x, const void* const* tw, const void* p,
                             const void* one, uint32_t n0, int W,
                             long long nbatch,
                             int log_rows, int log_lanes, int s0, int k,
                             int log_tile, void* stream) {
  // 4 W 2^20 bytes lie above any card's shared memory
  if (k < 1 || k > kMaxStages || k > log_tile || log_tile > 20 || s0 < 0 ||
      s0 + k > log_rows || nbatch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Tables tabs{};
  for (int i = 0; i < k; ++i) tabs.tw[i] = static_cast<const int32_t*>(tw[i]);
  auto st = static_cast<cudaStream_t>(stream);
  auto X = static_cast<int32_t*>(x);
  auto P = static_cast<const int32_t*>(p);
  auto O = static_cast<const int32_t*>(one);
  switch (W) {
    case 2:
      return launch<2>(X, tabs, P, O, n0, nbatch, log_rows, log_lanes, s0, k,
                       log_tile, st);
    case 8:
      return launch<8>(X, tabs, P, O, n0, nbatch, log_rows, log_lanes, s0, k,
                       log_tile, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Resident CTAs per SM of a full tile of 2^log_tile elements.
extern "C" int zk_ntt_stages_occupancy(int W, int log_tile, int* per_sm) {
  if (log_tile < 1 || log_tile > 20)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (W) {
    case 2: return static_cast<int>(occupancy<2>(log_tile, per_sm));
    case 8: return static_cast<int>(occupancy<8>(log_tile, per_sm));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
