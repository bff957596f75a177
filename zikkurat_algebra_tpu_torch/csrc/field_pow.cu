// Kernel P2: a field exponentiation out = a^e in ONE launch, for an
// exponent e fixed on the host, over a (W, n) batch of Montgomery
// elements, one element per thread.
//
// Replaces: the square-and-multiply loop of ops/field.py Field.pow_bits on
// CUDA tensors, which issued one K1 launch (mont_mul.cu) per squaring and
// per product: 608 launches for an Fp inverse a^(p-2) of BLS12-381, 606 for
// its square root a^((p+1)/4), 417 for an Fr inverse, each a few us of
// device work behind tens of us of host issue.  No TPU kernel did this: the
// JAX package runs the chain as one lax.scan of its stacked product, an
// LSB-first square-and-multiply with selects
// (zikkurat_algebra_tpu/ops/field.py:325 pow_bits).
//
// Algorithm: left-to-right binary square-and-multiply on csrc/field.cuh's
// mont_mul, the same chain as the loop it replaces (for canonical a every
// product is canonical, so the output equals its plain version,
// ops/kernel_field.py field_pow_plain, limb for limb): acc = a at the
// exponent's top bit, then for each lower bit acc = acc^2, and acc = acc a
// where the bit is set.  The exponent's bits are kernel parameters (struct
// PowParams, in the constant bank with p, n0 and 1 = R mod p), read most
// significant first; the branch on a bit is uniform across the grid.
//
// An exponent longer than a launch's kPowWords words (512 bits) runs as one
// launch per chunk, the top chunk first: a later chunk of k bits reads the
// previous launch's output acc and computes acc^(2^k) a^chunk.  Every
// exponent of the curve fields (at most 381 bits) is one launch.  e = 0
// gives 1 for every a (0^0 = 1 included); 0^e = 0 for e > 0.
//
// Dispatch: Field.pow_bits (and through it pow_static, inv, sqrt and
// batch_inv's one inversion) calls ops/kernel_field.py field_pow, which
// launches this kernel for CUDA tensors (launch counter
// field_pow.launches) and runs field_pow_plain for CPU tensors.
//
// Bound on the H100: at batch 1 (an inversion after a batch product, the
// affine conversion of one point) one thread runs the dependent chain
// alone, so the product's latency sets the time.  At large batch (the
// SRS's 2^20 square roots) integer multiplies bound it: each product is
// 4 W^2 + W multiply-adds, and the element is read and written once
// (8 W bytes) where the K1 chain read and wrote it once per product.
// -Xptxas -v for sm_90a: 62 registers at W = 12, 42 at W = 8, 32, 28, 20
// and 17 at W = 4, 3, 2, 1; no spill, no stack frame.  Measured times
// against the bound: PERF.md, the kernel table (row P2).

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPowWords = 16;       // exponent words per launch

template <int W>
struct PowParams {
  uint32_t p[W];
  uint32_t one[W];                  // R mod p: the result for e = 0
  uint32_t e[kPowWords];            // this chunk's bits, least significant
                                    // word first
  uint32_t n0;                      // -p^-1 mod 2^32
  int nbits;                        // bits of this chunk
};

// acc_in == nullptr: the top chunk (bit nbits - 1 set, or nbits = 0 for
// e = 0); else a later chunk continuing from acc_in.
template <int W>
__global__ void __launch_bounds__(kThreads)
field_pow_kernel(const int32_t* __restrict__ a,
                 const int32_t* __restrict__ acc_in,
                 int32_t* __restrict__ out, const PowParams<W> k,
                 long long n) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= n) return;
  uint32_t x[W], acc[W];
  if (k.nbits == 0) {
    zk::copy<W>(acc, k.one);
    zk::store_limbs<W>(out, acc, e, n);
    return;
  }
  zk::load_limbs<W>(x, a, e, n);
  int i = k.nbits - 1;
  if (acc_in == nullptr) {
    zk::copy<W>(acc, x);
    --i;
  } else {
    zk::load_limbs<W>(acc, acc_in, e, n);
  }
  for (; i >= 0; --i) {
    zk::mont_mul<W>(acc, acc, acc, k.p, k.n0);
    if ((k.e[i >> 5] >> (i & 31)) & 1u) {
      zk::mont_mul<W>(acc, acc, x, k.p, k.n0);
    }
  }
  zk::store_limbs<W>(out, acc, e, n);
}

template <int W>
cudaError_t launch(const int32_t* a, const int32_t* acc_in, int32_t* out,
                   const uint32_t* p, const uint32_t* one,
                   const uint32_t* words, int nbits, uint32_t n0,
                   long long n, cudaStream_t s) {
  PowParams<W> k;
  for (int i = 0; i < W; ++i) {
    k.p[i] = p[i];
    k.one[i] = one[i];
  }
  for (int i = 0; i < kPowWords; ++i) k.e[i] = words[i];
  k.n0 = n0;
  k.nbits = nbits;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  field_pow_kernel<W><<<grid, kThreads, 0, s>>>(a, acc_in, out, k, n);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes.  a, acc_in (nullptr for the top chunk)
// and out are contiguous (W, n) int32 planes on the card; p, one (R mod p)
// and words (kPowWords words of the chunk's bits) are HOST arrays, copied
// into the kernel's parameters.  0 <= nbits <= 32 kPowWords, nbits >= 1
// for a later chunk; n >= 1.  Returns a cudaError_t (0 = launched).
extern "C" int zk_field_pow(const void* a, const void* acc_in, void* out,
                            const void* p, const void* one, const void* words,
                            int nbits, uint32_t n0, int W, long long n,
                            void* stream) {
  if (n < 1 || nbits < 0 || nbits > 32 * kPowWords ||
      (acc_in != nullptr && nbits < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto A = static_cast<const int32_t*>(a);
  auto C = static_cast<const int32_t*>(acc_in);
  auto O = static_cast<int32_t*>(out);
  auto P = static_cast<const uint32_t*>(p);
  auto U = static_cast<const uint32_t*>(one);
  auto E = static_cast<const uint32_t*>(words);
  switch (W) {
    case 1: return launch<1>(A, C, O, P, U, E, nbits, n0, n, s);
    case 2: return launch<2>(A, C, O, P, U, E, nbits, n0, n, s);
    case 3: return launch<3>(A, C, O, P, U, E, nbits, n0, n, s);
    case 4: return launch<4>(A, C, O, P, U, E, nbits, n0, n, s);
    case 8: return launch<8>(A, C, O, P, U, E, nbits, n0, n, s);
    case 12: return launch<12>(A, C, O, P, U, E, nbits, n0, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
