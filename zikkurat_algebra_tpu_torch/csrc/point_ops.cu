// One G1 point operation per launch: complete projective addition and
// doubling over a batch of points, one thread per point.
//
// Replaces: the Field chains of ops/curve.py ProjCurveOps.add and .dbl on
// CUDA tensors of G1.  There each point operation is a sequence of
// `add_list`, `mul_list`, `sub_list` and `const` calls, several torch ops
// on int64 limbs each and one K1 launch per `mul_list`: about 100 launches
// issued by the host per point operation.  The MSM's serial tail (Horner,
// 17 x (15 doublings + 1 addition) at 2^20 and c = 15; the weighted bucket
// sum's ~40 levels; level 2's 11 scan steps) then holds the card idle
// while the host issues.  No TPU kernel did this: the JAX package leaves
// the group law to XLA's fusion (zikkurat_algebra_tpu/ops/curve.py).
//
// Formulas (curve.cuh): RCB15 algorithm 7 (addition, 14 products: 12 + 2
// by b3) and algorithm 9 (doubling, 9 products: 8 + 1 by b3), a = 0, in
// the operation order of ProjCurveOps.add / .dbl, so the outputs equal
// the torch law's limb for limb.  p, n0 = -p^-1 mod 2^32 and b3 R mod p
// are kernel parameters (struct zk::CurveConsts), in the constant bank.
//
// Dispatch (ProjCurveOps._fused): G1 coordinates (Fp, W in {8, 12}) on a
// CUDA tensor, over the kernel field, come here; G2 (Fp2), CPU tensors
// and ProjCurveOps.plain() run the torch law.  The wrappers are
// ops/kernel_point.py point_add / point_dbl (launch counters
// point_add.launches, point_dbl.launches).
//
// Layout: every coordinate is a (W, n) int32 limb plane (field.cuh), the
// batch flattened; each thread reads its point's coordinates once (6 W
// words for an addition, 3 W for a doubling), keeps the accumulator and
// the temporaries in registers and writes 3 W words.
//
// Bound on the H100: integer multiplies at large batch.  A product is
// 4 W^2 + W 32-bit multiply-adds: an addition 14 x 588 = 8232 at W = 12
// against 9 x 48 = 432 bytes moved (19 multiply-adds per byte), a
// doubling 9 x 588 = 5292 against 288 bytes; at W = 8, 3696 against 288
// and 2376 against 192.  The card does 1.673e13 multiply-adds/s (64 per
// clock per SM, 132 SMs, 1980 MHz) and moves 3.35e12 bytes/s, about 5
// multiply-adds per byte, so the products bound it: 0.49 ns per addition
// and 0.32 ns per doubling at W = 12.  At batch 1 (Horner) one thread runs
// the dependent CIOS chains alone: the launch and that latency set the
// time.  -Xptxas -v for sm_90a: point_add_kernel 198 registers at W = 12
// and 106 at W = 8, point_dbl_kernel 156 and 92, no spill, no stack
// frame; 198 registers leave two 128-thread CTAs per SM.  Measured times
// against the bound: PERF.md, the kernel table (row P1).

#include <cuda_runtime.h>

#include "curve.cuh"

namespace {

constexpr int kThreads = 128;

template <int W>
__global__ void __launch_bounds__(kThreads)
point_add_kernel(const int32_t* __restrict__ x1,
                 const int32_t* __restrict__ y1,
                 const int32_t* __restrict__ z1,
                 const int32_t* __restrict__ x2,
                 const int32_t* __restrict__ y2,
                 const int32_t* __restrict__ z2, int32_t* __restrict__ xo,
                 int32_t* __restrict__ yo, int32_t* __restrict__ zo,
                 const zk::CurveConsts<W> k, long long n) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= n) return;
  uint32_t X[W], Y[W], Z[W], X2[W], Y2[W], Z2[W];
  zk::load_limbs<W>(X, x1, e, n);
  zk::load_limbs<W>(Y, y1, e, n);
  zk::load_limbs<W>(Z, z1, e, n);
  zk::load_limbs<W>(X2, x2, e, n);
  zk::load_limbs<W>(Y2, y2, e, n);
  zk::load_limbs<W>(Z2, z2, e, n);
  zk::proj_add<W>(X, Y, Z, X2, Y2, Z2, k);
  zk::store_limbs<W>(xo, X, e, n);
  zk::store_limbs<W>(yo, Y, e, n);
  zk::store_limbs<W>(zo, Z, e, n);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
point_dbl_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                 const int32_t* __restrict__ z, int32_t* __restrict__ xo,
                 int32_t* __restrict__ yo, int32_t* __restrict__ zo,
                 const zk::CurveConsts<W> k, long long n) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= n) return;
  uint32_t X[W], Y[W], Z[W];
  zk::load_limbs<W>(X, x, e, n);
  zk::load_limbs<W>(Y, y, e, n);
  zk::load_limbs<W>(Z, z, e, n);
  zk::proj_dbl<W>(X, Y, Z, k);
  zk::store_limbs<W>(xo, X, e, n);
  zk::store_limbs<W>(yo, Y, e, n);
  zk::store_limbs<W>(zo, Z, e, n);
}

template <int W>
zk::CurveConsts<W> consts(const uint32_t* p, const uint32_t* b3,
                          uint32_t n0) {
  zk::CurveConsts<W> k;
  for (int i = 0; i < W; ++i) {
    k.p[i] = p[i];
    k.b3[i] = b3[i];
  }
  k.n0 = n0;
  return k;
}

unsigned grid(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

using I = const int32_t*;
using O = int32_t*;

template <int W>
cudaError_t launch_add(I x1, I y1, I z1, I x2, I y2, I z2, O xo, O yo, O zo,
                       const uint32_t* p, const uint32_t* b3, uint32_t n0,
                       long long n, cudaStream_t s) {
  point_add_kernel<W><<<grid(n), kThreads, 0, s>>>(
      x1, y1, z1, x2, y2, z2, xo, yo, zo, consts<W>(p, b3, n0), n);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_dbl(I x, I y, I z, O xo, O yo, O zo, const uint32_t* p,
                       const uint32_t* b3, uint32_t n0, long long n,
                       cudaStream_t s) {
  point_dbl_kernel<W><<<grid(n), kThreads, 0, s>>>(
      x, y, z, xo, yo, zo, consts<W>(p, b3, n0), n);
  return cudaGetLastError();
}

I in(const void* q) { return static_cast<I>(q); }
O out(void* q) { return static_cast<O>(q); }
const uint32_t* host(const void* q) {
  return static_cast<const uint32_t*>(q);
}

}  // namespace

// C entry points bound with ctypes.  Every coordinate is a contiguous
// (W, n) int32 plane on the card; p and b3 (b3 R mod p) are HOST arrays of
// W words, copied into the kernel's parameters.  n >= 1.  Returns a
// cudaError_t (0 = launched).
extern "C" int zk_point_add(const void* x1, const void* y1, const void* z1,
                            const void* x2, const void* y2, const void* z2,
                            void* xo, void* yo, void* zo, const void* p,
                            const void* b3, uint32_t n0, int W, long long n,
                            void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 8:
      return launch_add<8>(in(x1), in(y1), in(z1), in(x2), in(y2), in(z2),
                           out(xo), out(yo), out(zo), host(p), host(b3), n0,
                           n, s);
    case 12:
      return launch_add<12>(in(x1), in(y1), in(z1), in(x2), in(y2), in(z2),
                            out(xo), out(yo), out(zo), host(p), host(b3), n0,
                            n, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int zk_point_dbl(const void* x, const void* y, const void* z,
                            void* xo, void* yo, void* zo, const void* p,
                            const void* b3, uint32_t n0, int W, long long n,
                            void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 8:
      return launch_dbl<8>(in(x), in(y), in(z), out(xo), out(yo), out(zo),
                           host(p), host(b3), n0, n, s);
    case 12:
      return launch_dbl<12>(in(x), in(y), in(z), out(xo), out(yo), out(zo),
                            host(p), host(b3), n0, n, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
