// Kernel K4: level-1 bucket accumulation of the G2 Pippenger MSM, over Fp2.
//
// Replaces: zikkurat_algebra_tpu/ops/pallas_curve.py, `_build_block_scan2`
// (pallas_call at :341) reached from `block_madd_scan2` (:352), with
// `_block_scan_kernel2`, `_madd2` and `_f2_mul`.  Like K2 (block_scan.cu),
// whose interface and output it keeps, a lane gathers its points by index
// and writes only the running value at each segment's global tail into
// bucket[w, digit] and each block's trailer S[w, blk], where the TPU kernel
// streams a packed payload and writes every running value (six (L, m, B)
// planes).
//
// One thread per lane = (window w, block blk), walking the m sorted
// positions of its block: restart (first position of the block, or a new
// |digit|) loads from_affine(pt); otherwise acc = madd2(acc, pt), RCB15
// algorithm 8 for a = 0 over Fp2 with b3 an Fp2 constant, in the operation
// order of `_madd2` (11 Fp2 products, 33 Montgomery products).  A point at
// infinity leaves acc as it is; a negative digit negates y.  Coordinates
// are (W, 2, npts) planes (field.cuh), buckets (W, 2, nwin, nbuckets + 1)
// and trailers (W, 2, nwin, nblk).
//
// Bound on the H100: integer multiplies.  A madd2 is 33 Montgomery products
// of 4 W^2 + W multiply-adds (19,404 at W = 12, three times K2's) against
// about 200 bytes read per position.  The state does not fit in registers:
// the Fp2 accumulator is 6 W = 72 words, the point 4 W = 48, and the madd
// keeps up to seven Fp2 temporaries.  The design calls the Fp2 product
// (zk::f2_mul, field.cuh) instead of inlining it: the madd's Fp2 values
// live in the thread's stack frame (local memory, cached in L1) and pass
// to the product by reference, and the product's CIOS runs in registers.
// With all 11 products inlined, ptxas kept 255 registers and spilled
// 2848 bytes at W = 12, and the kernel took 2.3 times as long on the
// H100 (PERF.md).  b3 is re-read from global memory where it is used.
// Registers and spills are printed by -Xptxas -v.  Not tuned: several
// lanes per window, occupancy and staging the points in shared memory are
// left for later.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

template <int W>
struct Consts {
  uint32_t p[W];
  uint32_t n0;
  int qnr;
};

// (X, Y, Z) += (x2, y2), RCB15 algorithm 8 over Fp2, a = 0.
template <int W>
__device__ __forceinline__ void madd2(zk::Fp2<W>& X, zk::Fp2<W>& Y,
                                      zk::Fp2<W>& Z, const zk::Fp2<W>& x2,
                                      const zk::Fp2<W>& y2,
                                      const Consts<W>& k,
                                      const int32_t* __restrict__ b3p) {
  zk::Fp2<W> t0, t1, t3, t4, t5, u, v;
  zk::f2_mul<W>(t0, X, x2, k.p, k.n0, k.qnr);
  zk::f2_mul<W>(t1, Y, y2, k.p, k.n0, k.qnr);
  zk::f2_add<W>(u, x2, y2, k.p);
  zk::f2_add<W>(v, X, Y, k.p);
  zk::f2_mul<W>(t3, u, v, k.p, k.n0, k.qnr);      // m3
  zk::f2_add<W>(u, t0, t1, k.p);
  zk::f2_sub<W>(t3, t3, u, k.p);                  // t3 = m3 - (t0 + t1)
  zk::f2_mul<W>(t4, x2, Z, k.p, k.n0, k.qnr);     // m4
  zk::f2_add<W>(t4, t4, X, k.p);                  // t4 = m4 + X1
  zk::f2_mul<W>(t5, y2, Z, k.p, k.n0, k.qnr);     // m5
  zk::f2_add<W>(t5, t5, Y, k.p);                  // t5 = m5 + Y1
  zk::f2_scale_small<W>(X, t0, 3, k.p);           // X3 = 3 t0
  zk::load_fp2<W>(v, b3p, 0, 1);
  zk::f2_mul<W>(u, Z, v, k.p, k.n0, k.qnr);       // t2 = b3 Z1
  zk::f2_add<W>(Z, t1, u, k.p);                   // Z3 = t1 + t2
  zk::f2_sub<W>(t1, t1, u, k.p);                  // t1 = t1 - t2
  zk::load_fp2<W>(v, b3p, 0, 1);
  zk::f2_mul<W>(Y, t4, v, k.p, k.n0, k.qnr);      // Y3 = b3 t4
  // X = X3, Y = Y3, Z = Z3; live: t1, t3, t5
  zk::f2_mul<W>(u, t3, t1, k.p, k.n0, k.qnr);     // p0
  zk::f2_mul<W>(v, t5, Y, k.p, k.n0, k.qnr);      // p1
  zk::f2_sub<W>(t0, u, v, k.p);                   // X out
  zk::f2_mul<W>(u, Y, X, k.p, k.n0, k.qnr);       // p2
  zk::f2_mul<W>(v, t1, Z, k.p, k.n0, k.qnr);      // p3
  zk::f2_add<W>(t4, u, v, k.p);                   // Y out
  zk::f2_mul<W>(u, Z, t5, k.p, k.n0, k.qnr);      // p4
  zk::f2_mul<W>(v, X, t3, k.p, k.n0, k.qnr);      // p5
  zk::f2_add<W>(Z, u, v, k.p);                    // Z out
  zk::f2_copy<W>(X, t0);
  zk::f2_copy<W>(Y, t4);
}

// The Fp2 Montgomery one, (1, 0), read from the one limb plane.
template <int W>
__device__ __forceinline__ void set_one(zk::Fp2<W>& r,
                                        const int32_t* __restrict__ onep) {
  zk::load_limbs<W>(r.c0, onep, 0, 1);
  zk::set_zero<W>(r.c1);
}

template <int W>
__global__ void __launch_bounds__(128)
bucket_scan2_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ y,
                    const uint8_t* __restrict__ inf,
                    const int32_t* __restrict__ sd,
                    const int32_t* __restrict__ idx,
                    int32_t* __restrict__ bx, int32_t* __restrict__ by,
                    int32_t* __restrict__ bz, int32_t* __restrict__ sx,
                    int32_t* __restrict__ sy, int32_t* __restrict__ sz,
                    const int32_t* __restrict__ pp, uint32_t n0,
                    const int32_t* __restrict__ onep,
                    const int32_t* __restrict__ b3p, int qnr, int nwin,
                    int n, int npts, int m, int nb1) {
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
  k.qnr = qnr;

  const int32_t* sdw = sd + static_cast<long long>(w) * n;
  const int32_t* idw = idx + static_cast<long long>(w) * n;
  const long long bstride = static_cast<long long>(nwin) * nb1;
  const long long sstride = static_cast<long long>(nwin) * nblk;
  const int base = blk * m;

  zk::Fp2<W> X, Y, Z, x2, y2;
  zk::f2_set_zero<W>(X);
  zk::f2_set_zero<W>(Y);
  zk::f2_set_zero<W>(Z);
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
      zk::load_fp2<W>(x2, x, pt, npts);
      zk::load_fp2<W>(y2, y, pt, npts);
      if (negate) zk::f2_neg<W>(y2, y2, k.p);
    }
    if (restart) {
      // from_affine: (0 : 1 : 0) for infinity, else (x : y : 1)
      if (pinf) {
        zk::f2_set_zero<W>(X);
        set_one<W>(Y, onep);
        zk::f2_set_zero<W>(Z);
      } else {
        zk::f2_copy<W>(X, x2);
        zk::f2_copy<W>(Y, y2);
        set_one<W>(Z, onep);
      }
    } else if (!pinf) {
      madd2<W>(X, Y, Z, x2, y2, k, b3p);
    }
    a_prev = a;
    const int a_next = next < 0 ? -next : next;
    if (pos + 1 == n || a_next != a) {             // global segment tail
      const long long e = static_cast<long long>(w) * nb1 + a;
      zk::store_fp2<W>(bx, X, e, bstride);
      zk::store_fp2<W>(by, Y, e, bstride);
      zk::store_fp2<W>(bz, Z, e, bstride);
    }
    d = next;
  }
  const long long e = static_cast<long long>(w) * nblk + blk;
  zk::store_fp2<W>(sx, X, e, sstride);
  zk::store_fp2<W>(sy, Y, e, sstride);
  zk::store_fp2<W>(sz, Z, e, sstride);
}

template <int W>
cudaError_t launch(const int32_t* x, const int32_t* y, const uint8_t* inf,
                   const int32_t* sd, const int32_t* idx, int32_t* bx,
                   int32_t* by, int32_t* bz, int32_t* sx, int32_t* sy,
                   int32_t* sz, const int32_t* p, uint32_t n0,
                   const int32_t* one, const int32_t* b3, int qnr, int nwin,
                   int n, int npts, int m, int nb1, cudaStream_t stream) {
  const int threads = 128;
  const long long lanes = static_cast<long long>(nwin) * (n / m);
  const long long blocks = (lanes + threads - 1) / threads;
  bucket_scan2_kernel<W><<<static_cast<unsigned>(blocks), threads, 0,
                           stream>>>(x, y, inf, sd, idx, bx, by, bz, sx, sy,
                                     sz, p, n0, one, b3, qnr, nwin, n, npts,
                                     m, nb1);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes.  b3 is one (W, 2) Fp2 Montgomery
// constant; qnr the nonresidue u^2.  Returns a cudaError_t (0 = launched).
extern "C" int zk_bucket_scan2(const void* x, const void* y, const void* inf,
                               const void* sd, const void* idx, void* bx,
                               void* by, void* bz, void* sx, void* sy,
                               void* sz, const void* p, uint32_t n0,
                               const void* one, const void* b3, int qnr,
                               int W, int nwin, int n, int npts, int m,
                               int nb1, void* stream) {
  if (m <= 0 || n % m != 0 || qnr == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto I = [](const void* q) { return static_cast<const int32_t*>(q); };
  auto O = [](void* q) { return static_cast<int32_t*>(q); };
  auto F = static_cast<const uint8_t*>(inf);
  switch (W) {
    case 8:
      return launch<8>(I(x), I(y), F, I(sd), I(idx), O(bx), O(by), O(bz),
                       O(sx), O(sy), O(sz), I(p), n0, I(one), I(b3), qnr,
                       nwin, n, npts, m, nb1, s);
    case 12:
      return launch<12>(I(x), I(y), F, I(sd), I(idx), O(bx), O(by), O(bz),
                        O(sx), O(sy), O(sz), I(p), n0, I(one), I(b3), qnr,
                        nwin, n, npts, m, nb1, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
