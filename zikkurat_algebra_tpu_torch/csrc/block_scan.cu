// Kernel K2: level-1 bucket accumulation of the G1 Pippenger MSM.
//
// Replaces: zikkurat_algebra_tpu/ops/pallas_curve.py, `_build_block_scan`
// (pallas_call at :253) reached from `block_madd_scan` (:387), with
// `_block_scan_kernel` and `_madd`.  The TPU kernel streams a packed sort
// payload through VMEM and writes every running value, (L, m, B) planes,
// because the TPU cannot gather.  Here a lane gathers its points by index
// and writes only what the MSM reads afterwards: the running value at each
// segment's global tail into bucket[w, digit] (each (window, digit) has
// exactly one global tail, so there are no write conflicts and no atomics)
// and each block's trailer S[w, blk].  At 2^20 points the full running
// planes would be about 2.7 GB; the buckets and trailers are 48 MB.
//
// One thread per lane = (window w, block blk).  It walks the m sorted
// positions of its block: restart (first position of the block, or a new
// |digit|) loads from_affine(pt); otherwise acc = madd(acc, pt), RCB15
// algorithm 8 for a = 0 (11 products, same operation order as
// ops/curve.py ProjCurveOps.madd).  A point at infinity leaves acc as it is
// and is not even loaded; a negative digit negates y.
//
// Bound on the H100: integer multiplies.  A madd is 11 Montgomery
// products of 4 W^2 + W multiply-adds each (6468 for W = 12) against
// about 100 bytes read per position, so the multiply rate, not the
// memory, bounds it.  The design keeps the accumulator (3 W words), the
// point and the temporaries in registers; the register count, printed by
// -Xptxas -v, is the limit on the lanes in flight.  Not tuned yet.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

template <int W>
struct Consts {
  uint32_t p[W];
  uint32_t n0;
  int b3;
};

// (X, Y, Z) += (x2, y2), RCB15 algorithm 8, a = 0, b3 = 3b.
template <int W>
__device__ __forceinline__ void madd(uint32_t (&X)[W], uint32_t (&Y)[W],
                                     uint32_t (&Z)[W], const uint32_t (&x2)[W],
                                     const uint32_t (&y2)[W],
                                     const Consts<W>& k) {
  uint32_t t0[W], t1[W], t3[W], t4[W], t5[W], u[W], v[W];
  zk::mont_mul<W>(t0, X, x2, k.p, k.n0);
  zk::mont_mul<W>(t1, Y, y2, k.p, k.n0);
  zk::add_mod<W>(u, x2, y2, k.p);
  zk::add_mod<W>(v, X, Y, k.p);
  zk::mont_mul<W>(t3, u, v, k.p, k.n0);           // m3
  zk::add_mod<W>(u, t0, t1, k.p);
  zk::sub_mod<W>(t3, t3, u, k.p);                 // t3 = m3 - (t0 + t1)
  zk::mont_mul<W>(t4, x2, Z, k.p, k.n0);          // m4
  zk::add_mod<W>(t4, t4, X, k.p);                 // t4 = m4 + X1
  zk::mont_mul<W>(t5, y2, Z, k.p, k.n0);          // m5
  zk::add_mod<W>(t5, t5, Y, k.p);                 // t5 = m5 + Y1
  zk::scale_small<W>(X, t0, 3, k.p);              // X3 = 3 t0
  zk::scale_small<W>(u, Z, k.b3, k.p);            // t2 = b3 Z1
  zk::add_mod<W>(Z, t1, u, k.p);                  // Z3 = t1 + t2
  zk::sub_mod<W>(t1, t1, u, k.p);                 // t1 = t1 - t2
  zk::scale_small<W>(Y, t4, k.b3, k.p);           // Y3 = b3 t4
  // X = X3, Y = Y3, Z = Z3; live: t1, t3, t5
  zk::mont_mul<W>(u, t3, t1, k.p, k.n0);          // p0
  zk::mont_mul<W>(v, t5, Y, k.p, k.n0);           // p1
  zk::sub_mod<W>(t0, u, v, k.p);                  // X out
  zk::mont_mul<W>(u, Y, X, k.p, k.n0);            // p2
  zk::mont_mul<W>(v, t1, Z, k.p, k.n0);           // p3
  zk::add_mod<W>(t4, u, v, k.p);                  // Y out
  zk::mont_mul<W>(u, Z, t5, k.p, k.n0);           // p4
  zk::mont_mul<W>(v, X, t3, k.p, k.n0);           // p5
  zk::add_mod<W>(Z, u, v, k.p);                   // Z out
  zk::copy<W>(X, t0);
  zk::copy<W>(Y, t4);
}

template <int W>
__global__ void __launch_bounds__(128)
bucket_scan_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                   const uint8_t* __restrict__ inf,
                   const int32_t* __restrict__ sd,
                   const int32_t* __restrict__ idx,
                   int32_t* __restrict__ bx, int32_t* __restrict__ by,
                   int32_t* __restrict__ bz, int32_t* __restrict__ sx,
                   int32_t* __restrict__ sy, int32_t* __restrict__ sz,
                   const int32_t* __restrict__ pp, uint32_t n0,
                   const int32_t* __restrict__ onep, int b3, int nwin, int n,
                   int npts, int m, int nb1) {
  const int nblk = n / m;
  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
  if (lane >= static_cast<long long>(nwin) * nblk) return;
  const int w = static_cast<int>(lane / nblk);
  const int blk = static_cast<int>(lane % nblk);

  Consts<W> k;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    k.p[i] = static_cast<uint32_t>(__ldg(pp + i));
  }
  k.n0 = n0;
  k.b3 = b3;

  const int32_t* sdw = sd + static_cast<long long>(w) * n;
  const int32_t* idw = idx + static_cast<long long>(w) * n;
  const long long bstride = static_cast<long long>(nwin) * nb1;
  const long long sstride = static_cast<long long>(nwin) * nblk;
  const int base = blk * m;

  uint32_t X[W], Y[W], Z[W], x2[W], y2[W];
  zk::set_zero<W>(X);
  zk::set_zero<W>(Y);
  zk::set_zero<W>(Z);
  int a_prev = -1;
  int d = sdw[base];
  for (int j = 0; j < m; ++j) {
    const int pos = base + j;
    const int a = d < 0 ? -d : d;
    const bool negate = d < 0;
    const int next = pos + 1 < n ? sdw[pos + 1] : -1;
    const int pt = idw[pos];
    const bool pinf = inf[pt] != 0;
    const bool restart = (j == 0) || (a != a_prev);
    if (!pinf) {
      zk::load_limbs<W>(x2, x, pt, npts);
      zk::load_limbs<W>(y2, y, pt, npts);
      if (negate) zk::neg_mod<W>(y2, y2, k.p);
    }
    if (restart) {
      // from_affine: (0 : 1 : 0) for infinity, else (x : y : 1); the
      // Montgomery one is read where it is needed, not held in registers
      if (pinf) {
        zk::set_zero<W>(X);
        zk::load_limbs<W>(Y, onep, 0, 1);
        zk::set_zero<W>(Z);
      } else {
        zk::copy<W>(X, x2);
        zk::copy<W>(Y, y2);
        zk::load_limbs<W>(Z, onep, 0, 1);
      }
    } else if (!pinf) {
      madd<W>(X, Y, Z, x2, y2, k);
    }
    a_prev = a;
    const int a_next = next < 0 ? -next : next;
    if (pos + 1 == n || a_next != a) {             // global segment tail
      const long long e = static_cast<long long>(w) * nb1 + a;
      zk::store_limbs<W>(bx, X, e, bstride);
      zk::store_limbs<W>(by, Y, e, bstride);
      zk::store_limbs<W>(bz, Z, e, bstride);
    }
    d = next;
  }
  const long long e = static_cast<long long>(w) * nblk + blk;
  zk::store_limbs<W>(sx, X, e, sstride);
  zk::store_limbs<W>(sy, Y, e, sstride);
  zk::store_limbs<W>(sz, Z, e, sstride);
}

template <int W>
cudaError_t launch(const int32_t* x, const int32_t* y, const uint8_t* inf,
                   const int32_t* sd, const int32_t* idx, int32_t* bx,
                   int32_t* by, int32_t* bz, int32_t* sx, int32_t* sy,
                   int32_t* sz, const int32_t* p, uint32_t n0,
                   const int32_t* one, int b3, int nwin, int n, int npts,
                   int m, int nb1, cudaStream_t stream) {
  const int threads = 128;
  const long long lanes = static_cast<long long>(nwin) * (n / m);
  const long long blocks = (lanes + threads - 1) / threads;
  bucket_scan_kernel<W><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      x, y, inf, sd, idx, bx, by, bz, sx, sy, sz, p, n0, one, b3, nwin, n,
      npts, m, nb1);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes.  Returns a cudaError_t (0 = launched).
extern "C" int zk_bucket_scan(const void* x, const void* y, const void* inf,
                              const void* sd, const void* idx, void* bx,
                              void* by, void* bz, void* sx, void* sy, void* sz,
                              const void* p, uint32_t n0, const void* one,
                              int b3, int W, int nwin, int n, int npts, int m,
                              int nb1, void* stream) {
  if (m <= 0 || n % m != 0 || b3 < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto I = [](const void* q) { return static_cast<const int32_t*>(q); };
  auto O = [](void* q) { return static_cast<int32_t*>(q); };
  auto F = static_cast<const uint8_t*>(inf);
  switch (W) {
    case 8:
      return launch<8>(I(x), I(y), F, I(sd), I(idx), O(bx), O(by), O(bz),
                       O(sx), O(sy), O(sz), I(p), n0, I(one), b3, nwin, n,
                       npts, m, nb1, s);
    case 12:
      return launch<12>(I(x), I(y), F, I(sd), I(idx), O(bx), O(by), O(bz),
                        O(sx), O(sy), O(sz), I(p), n0, I(one), b3, nwin, n,
                        npts, m, nb1, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
