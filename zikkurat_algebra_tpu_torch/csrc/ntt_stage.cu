// Kernel K5: one radix-2 decimation-in-time NTT stage, in place, on a
// (W, B, S, lanes) limb-plane tensor, one thread per butterfly pair.
//
// Replaces: zikkurat_algebra_tpu/ops/pallas_field.py, `_build_butterfly`
// (pallas_call at :130) reached from `butterfly_pallas` (:143), body
// `_butterfly_kernel` (:112): hi = u + v tw, lo = u - v tw on (L, N)
// radix-2^15 planes with lazy limbs, which ops/ntt.py:380 calls once per
// stage on operands it has gathered and broadcast to n/2.  Here the
// stage is indexed in the kernel: for pair i of stage s (half = 2^(s-1)),
// block = i >> (s-1) and j = i & (half-1); u is row block*2*half + j of
// the S axis, v the row half below it, and the twiddle is entry j of the
// stage's (W, half) table.  u becomes u + v T[j] and v becomes
// u - v T[j], both canonical mod p (CIOS and add/sub of field.cuh).
// `lanes` columns share each butterfly's twiddle: 1 for the radix-2
// transform, the row length for the four-step column passes.
//
// Bound on the H100: bytes.  A stage reads and writes every element once
// (2 * 4 W bytes per element, 64 MB at n = 2^20, W = 8) and does one
// Montgomery product per pair (4 W^2 + W = 264 multiply-adds at W = 8):
// about 20 us of memory against 8 us of multiplies at 2^20.  The design
// keeps the pair in registers, reads limb planes so that a warp's loads of
// one limb are contiguous (neighbouring threads hold neighbouring j), and
// computes its offsets with shifts (S and lanes are powers of two).  One
// launch per stage; fusing several stages in shared memory is later work.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

template <int W>
__global__ void __launch_bounds__(256)
ntt_stage_kernel(int32_t* __restrict__ x, const int32_t* __restrict__ tw,
                 const int32_t* __restrict__ pp, uint32_t n0, long long n,
                 int log_rows, int log_lanes, int s, long long pairs) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= pairs) return;
  const long long half = 1LL << (s - 1);
  const long long lane = t & ((1LL << log_lanes) - 1);
  const long long rest = t >> log_lanes;            // b * S/2 + i
  const long long i = rest & ((1LL << (log_rows - 1)) - 1);
  const long long b = rest >> (log_rows - 1);
  const long long j = i & (half - 1);
  const long long row = ((i >> (s - 1)) << s) + j;
  const long long eu = (((b << log_rows) + row) << log_lanes) + lane;
  const long long ev = eu + (half << log_lanes);

  uint32_t p[W], u[W], v[W], w[W], hi[W], lo[W];
#pragma unroll
  for (int k = 0; k < W; ++k) p[k] = static_cast<uint32_t>(__ldg(pp + k));
  zk::load_limbs<W>(u, x, eu, n);
  zk::load_limbs<W>(v, x, ev, n);
#pragma unroll
  for (int k = 0; k < W; ++k)
    w[k] = static_cast<uint32_t>(__ldg(tw + k * half + j));
  zk::mont_mul<W>(v, v, w, p, n0);
  zk::add_mod<W>(hi, u, v, p);
  zk::sub_mod<W>(lo, u, v, p);
  zk::store_limbs<W>(x, hi, eu, n);
  zk::store_limbs<W>(x, lo, ev, n);
}

template <int W>
cudaError_t launch(int32_t* x, const int32_t* tw, const int32_t* p,
                   uint32_t n0, long long nbatch, int log_rows, int log_lanes,
                   int s, cudaStream_t stream) {
  const long long n = nbatch << (log_rows + log_lanes);
  const long long pairs = n >> 1;
  const int threads = 256;
  const long long blocks = (pairs + threads - 1) / threads;
  ntt_stage_kernel<W><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      x, tw, p, n0, n, log_rows, log_lanes, s, pairs);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes.  x is (W, nbatch, 2^log_rows,
// 2^log_lanes), tw the (W, 2^(s-1)) table of stage s in 1..log_rows.
// Returns a cudaError_t (0 = launched).
extern "C" int zk_ntt_stage(void* x, const void* tw, const void* p,
                            uint32_t n0, int W, long long nbatch,
                            int log_rows, int log_lanes, int s,
                            void* stream) {
  if (s < 1 || s > log_rows || nbatch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto X = static_cast<int32_t*>(x);
  auto T = static_cast<const int32_t*>(tw);
  auto P = static_cast<const int32_t*>(p);
  switch (W) {
    case 8: return launch<8>(X, T, P, n0, nbatch, log_rows, log_lanes, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
