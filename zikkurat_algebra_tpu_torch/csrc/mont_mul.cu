// Kernel K1: elementwise Montgomery product out = a * b * R^-1 mod p on
// (W, n) limb planes, one element per thread.
//
// Replaces: zikkurat_algebra_tpu/ops/pallas_field.py, `_build_mont_mul`
// (pallas_call at :97) reached from `mont_mul_pallas` (:174), body `_cios`.
// The TPU kernel works on signed radix-2^15 limbs with lazy reduction
// because the TPU has no 32x32->64 multiply; here the limbs are radix 2^32
// and the product is exact CIOS with one final conditional subtraction
// (field.cuh), so the output is canonical.
//
// Bound on the H100: integer multiplies.  Each of the W outer steps of
// CIOS does 2W products a_j b_i and m p_j (lo and hi halves counted apart,
// 4W multiply-adds) plus one for m, so an element needs 4 W^2 + W = 588
// 32-bit multiply-adds for W = 12 and moves 3 * 4 W = 144 bytes: about
// 4 multiply-adds per byte, where the card's integer multiply rate
// (64 per clock per SM) over its 3.35 TB/s is about 5 per byte, so the
// multiplies and the bytes take comparable time.  The design keeps the whole
// element in registers (no shared memory), reads the modulus once per
// thread (the same address for the whole warp, a broadcast), and reads
// limb planes so that a warp's 32 loads of one limb are contiguous.
//
// Widths: W = 12 (BLS12-381 and BLS12-377 Fp), 8 (their Fr, BN128, and
// every 256-bit field), and 1, 2, 3, 4 for the primes at the limb
// boundaries (M31; 45- to 64-bit primes; 2^64 + 13; M127).  The same
// CIOS serves all: at W = 1 its inner reduction loop is empty and the
// top word t[W] carries everything; for p above R/2 (goldilocks,
// 2^255 + 95) the result below 2p may reach R, and reduce_once takes the
// nonzero top word as the sign that t >= p.  The multiply-adds per byte
// are (4 W + 1) / 12: 0.42 at W = 1, 1.4 at W = 4, against the card's
// balance of about 5, so the small widths are bound by bytes.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

template <int W>
__global__ void __launch_bounds__(256)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, const int32_t* __restrict__ pp,
                uint32_t n0, long long n) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= n) return;
  uint32_t p[W], x[W], y[W], r[W];
#pragma unroll
  for (int i = 0; i < W; ++i) p[i] = static_cast<uint32_t>(__ldg(pp + i));
  zk::load_limbs<W>(x, a, e, n);
  zk::load_limbs<W>(y, b, e, n);
  zk::mont_mul<W>(r, x, y, p, n0);
  zk::store_limbs<W>(out, r, e, n);
}

template <int W>
cudaError_t launch(const int32_t* a, const int32_t* b, int32_t* out,
                   const int32_t* p, uint32_t n0, long long n,
                   cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  mont_mul_kernel<W><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      a, b, out, p, n0, n);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes.  Returns a cudaError_t (0 = launched).
extern "C" int zk_mont_mul(const void* a, const void* b, void* out,
                           const void* p, uint32_t n0, int W, long long n,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto A = static_cast<const int32_t*>(a);
  auto B = static_cast<const int32_t*>(b);
  auto O = static_cast<int32_t*>(out);
  auto P = static_cast<const int32_t*>(p);
  switch (W) {
    case 1: return launch<1>(A, B, O, P, n0, n, s);
    case 2: return launch<2>(A, B, O, P, n0, n, s);
    case 3: return launch<3>(A, B, O, P, n0, n, s);
    case 4: return launch<4>(A, B, O, P, n0, n, s);
    case 8: return launch<8>(A, B, O, P, n0, n, s);
    case 12: return launch<12>(A, B, O, P, n0, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
