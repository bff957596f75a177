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
// The running value of a block restarts at the block's first position and
// wherever |digit| changes; otherwise acc = madd(acc, pt), RCB15
// algorithm 8 for a = 0 (11 products, same operation order as ops/curve.py
// ProjCurveOps.madd).  A point at infinity leaves acc as it is and is not
// even loaded; a negative digit negates y.
//
// Each block of m positions is split among S = min(8, m) sub-lanes, eight
// neighbouring threads of one warp, sub-lane s walking positions
// [s m / S, (s + 1) m / S) of the block, in two phases:
//   1. walk: a sub-lane restarts at its own first position and writes the
//      tails of the runs that start inside its range.  Its first run (its
//      head) may continue a run of the sub-lanes before it: when the head
//      ends at a global tail, the sub-lane writes the head's value H there
//      and marks it.  It ends holding T, its value at its last position.
//   2. combine: the eight threads of a block join their T's in the warp's
//      shared buffer, the scan of ops/msm.py `_level2_carries` one level
//      down: with uniform_s (the whole range is one run) and conn_s (its
//      first |digit| equals the last one of sub-lane s - 1),
//          T'_s = T_s + [uniform_s and conn_s] T'_{s-1},
//          C_s  = [conn_s] T'_{s-1},
//      by a segmented Hillis-Steele scan in log2 S steps of complete
//      projective additions (RCB15 algorithm 7, ops/curve.py
//      ProjCurveOps.add).  A marked head becomes H + C_s (T'_s for a
//      uniform sub-lane), and the block's trailer is T' of its last
//      sub-lane.
// The sums associate differently from one lane per block, so the points
// are the same in other projective coordinates.
//
// Bound on the H100: integer multiplies.  A madd is 11 Montgomery
// products of 4 W^2 + W multiply-adds each (6468 for W = 12) against
// about 100 bytes read per position, so the multiply rate, not the
// memory, bounds it.  The accumulator (3 W words), the point and the
// temporaries stay in registers, so the register count (-Xptxas -v) limits
// the warps in flight.  Eight sub-lanes per block give 8 x nwin x n / m
// threads (294,912 for the G1 path at 2^20): one-warp CTAs fill every SM
// about six times over, so no thin last wave is left.  The combine adds
// at most 4 additions of 12 products per sub-lane to its m / S madds, and
// a warp that combines overlaps with others that still walk (a separate
// combine kernel measured slower on the H100).  The field's constants are
// kernel parameters (struct Consts), read from the constant bank.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

// The field's constants, passed by value as a kernel parameter: they sit
// in the constant bank, where a multiply-add reads them as an operand, and
// take no registers.
template <int W>
struct Consts {
  uint32_t p[W];
  uint32_t one[W];           // the Montgomery one, R mod p
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

// Limb i of coordinate c of lane l in a warp's combine buffer sits at
// [(c W + i) 32 + l]: a lane reading another lane's point reads 32
// neighbouring banks.
template <int W>
__device__ __forceinline__ void put_point(volatile uint32_t* sh,
                                          const uint32_t (&X)[W],
                                          const uint32_t (&Y)[W],
                                          const uint32_t (&Z)[W], int lane) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    sh[i * 32 + lane] = X[i];
    sh[(W + i) * 32 + lane] = Y[i];
    sh[(2 * W + i) * 32 + lane] = Z[i];
  }
}

// Read where it is used, so that the other point takes no registers
// between products (the buffer is volatile).
template <int W>
__device__ __forceinline__ void get_coord(uint32_t (&r)[W],
                                          const volatile uint32_t* sh, int c,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = sh[(c * W + i) * 32 + lane];
}

// (X, Y, Z) += the point of lane q in sh, RCB15 algorithm 7, a = 0, in the
// operation order of ops/curve.py ProjCurveOps.add.
template <int W>
__device__ __forceinline__ void add_from(uint32_t (&X)[W], uint32_t (&Y)[W],
                                         uint32_t (&Z)[W],
                                         const volatile uint32_t* sh, int q,
                                         const Consts<W>& k) {
  uint32_t a[W], b[W], t0[W], t1[W], t2[W], t3[W], t4[W], y3[W];
  get_coord<W>(a, sh, 0, q);                      // X2
  zk::mont_mul<W>(t0, X, a, k.p, k.n0);           // t0 = X1 X2
  get_coord<W>(b, sh, 1, q);                      // Y2
  zk::mont_mul<W>(t1, Y, b, k.p, k.n0);           // t1 = Y1 Y2
  zk::add_mod<W>(a, a, b, k.p);
  zk::add_mod<W>(b, X, Y, k.p);
  zk::mont_mul<W>(t3, b, a, k.p, k.n0);           // m3
  zk::add_mod<W>(a, t0, t1, k.p);
  zk::sub_mod<W>(t3, t3, a, k.p);                 // t3 = m3 - (t0 + t1)
  get_coord<W>(a, sh, 2, q);                      // Z2
  zk::mont_mul<W>(t2, Z, a, k.p, k.n0);           // t2 = Z1 Z2
  get_coord<W>(b, sh, 1, q);
  zk::add_mod<W>(a, a, b, k.p);
  zk::add_mod<W>(b, Y, Z, k.p);
  zk::mont_mul<W>(t4, b, a, k.p, k.n0);           // m4
  zk::add_mod<W>(a, t1, t2, k.p);
  zk::sub_mod<W>(t4, t4, a, k.p);                 // t4 = m4 - (t1 + t2)
  get_coord<W>(a, sh, 0, q);
  get_coord<W>(b, sh, 2, q);
  zk::add_mod<W>(a, a, b, k.p);
  zk::add_mod<W>(b, X, Z, k.p);
  zk::mont_mul<W>(y3, b, a, k.p, k.n0);           // m5
  zk::add_mod<W>(a, t0, t2, k.p);
  zk::sub_mod<W>(y3, y3, a, k.p);                 // Y3 = m5 - (t0 + t2)
  zk::scale_small<W>(X, t0, 3, k.p);              // X3 = 3 t0
  zk::scale_small<W>(a, t2, k.b3, k.p);           // t2 = b3 t2
  zk::add_mod<W>(Z, t1, a, k.p);                  // Z3 = t1 + t2
  zk::sub_mod<W>(t1, t1, a, k.p);                 // t1 = t1 - t2
  zk::scale_small<W>(Y, y3, k.b3, k.p);           // Y3 = b3 Y3
  // X = X3, Y = Y3, Z = Z3; live: t1, t3, t4
  zk::mont_mul<W>(a, t3, t1, k.p, k.n0);          // p0
  zk::mont_mul<W>(b, t4, Y, k.p, k.n0);           // p1
  zk::sub_mod<W>(t0, a, b, k.p);                  // X out
  zk::mont_mul<W>(a, Y, X, k.p, k.n0);            // p2
  zk::mont_mul<W>(b, t1, Z, k.p, k.n0);           // p3
  zk::add_mod<W>(t2, a, b, k.p);                  // Y out
  zk::mont_mul<W>(a, Z, t4, k.p, k.n0);           // p4
  zk::mont_mul<W>(b, X, t3, k.p, k.n0);           // p5
  zk::add_mod<W>(Z, a, b, k.p);                   // Z out
  zk::copy<W>(X, t0);
  zk::copy<W>(Y, t2);
}

constexpr int kSub = 8;        // sub-lanes per block: a power of two <= 32
constexpr int kThreads = 32;   // one warp per CTA

// At most 168 registers: a warp takes its registers from one of the SM's
// four 16 K-register partitions, so 168 lets 3 warps share a partition (12
// per SM) where 176-255 let 2.  ptxas then spills a few hundred bytes.  The
// kernel is latency-bound: its time falls with the warps in flight, but
// 128 registers (16 warps) spill over a kilobyte, and holding the madd's
// temporaries in shared memory instead costs the overlap of independent
// products (scripts/kernel_variants.py, PERF.md).
template <int W>
__global__ void __launch_bounds__(kThreads, 12)
bucket_scan_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                   const uint8_t* __restrict__ inf,
                   const int32_t* __restrict__ sd,
                   const int32_t* __restrict__ idx,
                   int32_t* __restrict__ bx, int32_t* __restrict__ by,
                   int32_t* __restrict__ bz, int32_t* __restrict__ sx,
                   int32_t* __restrict__ sy, int32_t* __restrict__ sz,
                   const Consts<W> k, int nwin, int n, int npts, int m,
                   int nb1) {
  __shared__ uint32_t sh_all[kThreads / 32][3 * W * 32];
  volatile uint32_t* sh = sh_all[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  // Thread g is sub-lane s = g % kSub of block g / kSub (window w, block
  // blk) and walks positions [lo, hi).  Threads past the last block, or
  // with s >= min(m, kSub), are inactive.
  const int nblk = n / m;
  const int nsub = m < kSub ? m : kSub;
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int s = static_cast<int>(g % kSub);
  const bool active = g / kSub < static_cast<long long>(nwin) * nblk &&
                      s < nsub;
  const int w = active ? static_cast<int>(g / kSub / nblk) : 0;
  const int blk = active ? static_cast<int>(g / kSub % nblk) : 0;
  const int lo = blk * m + static_cast<int>(static_cast<long long>(s) * m /
                                            nsub);
  const int hi = blk * m + static_cast<int>(
      static_cast<long long>(s + 1) * m / nsub);
  const int32_t* sdw = sd + static_cast<long long>(w) * n;
  const int32_t* idw = idx + static_cast<long long>(w) * n;
  const long long bstride = static_cast<long long>(nwin) * nb1;

  // 1. The walk.  Every thread of the warp takes part in the combine
  // below; only active ones walk, add and write.
  uint32_t X[W], Y[W], Z[W], x2[W], y2[W];
  zk::set_zero<W>(X);
  zk::set_zero<W>(Y);
  zk::set_zero<W>(Z);
  bool head = true;          // still in the first run of the range
  bool head_tail = false;    // the first run ends at a global tail
  bool conn = false;         // the first |digit| ends sub-lane s - 1 too
  int a_first = 0;
  if (active) {
    int d = sdw[lo];
    a_first = d < 0 ? -d : d;
    int a_prev = -1;
    for (int pos = lo; pos < hi; ++pos) {
      const int a = d < 0 ? -d : d;
      const bool negate = d < 0;
      const int next = pos + 1 < n ? sdw[pos + 1] : -1;
      const int pt = idw[pos];
      const bool pinf = inf[pt] != 0;
      const bool restart = (pos == lo) || (a != a_prev);
      if (restart && pos != lo) head = false;
      if (!pinf) {
        zk::load_limbs<W>(x2, x, pt, npts);
        zk::load_limbs<W>(y2, y, pt, npts);
        if (negate) zk::neg_mod<W>(y2, y2, k.p);
      }
      if (restart) {
        // from_affine: (0 : 1 : 0) for infinity, else (x : y : 1)
        if (pinf) {
          zk::set_zero<W>(X);
          zk::copy<W>(Y, k.one);
          zk::set_zero<W>(Z);
        } else {
          zk::copy<W>(X, x2);
          zk::copy<W>(Y, y2);
          zk::copy<W>(Z, k.one);
        }
      } else if (!pinf) {
        madd<W>(X, Y, Z, x2, y2, k);
      }
      a_prev = a;
      const int a_next = next < 0 ? -next : next;
      if (pos + 1 == n || a_next != a) {           // global segment tail
        const long long e = static_cast<long long>(w) * nb1 + a;
        zk::store_limbs<W>(bx, X, e, bstride);
        zk::store_limbs<W>(by, Y, e, bstride);
        zk::store_limbs<W>(bz, Z, e, bstride);
        if (head) head_tail = true;
      }
      d = next;
    }
    if (s > 0) {
      const int db = sdw[lo - 1];
      conn = a_first == (db < 0 ? -db : db);
    }
  }

  // 2. The combine: T' by a segmented Hillis-Steele scan over the block's
  // sub-lanes, in the warp's shared buffer.
  bool brk = !(head && conn);
  for (int j = 1; j < kSub; j <<= 1) {
    put_point<W>(sh, X, Y, Z, lane);
    __syncwarp();
    const bool brk_prev = __shfl_up_sync(0xffffffffu, brk, j, kSub);
    if (active && s >= j && !brk) add_from<W>(X, Y, Z, sh, lane - j, k);
    if (s >= j) brk = brk || brk_prev;
    __syncwarp();
  }
  put_point<W>(sh, X, Y, Z, lane);                // T' for C_s = T'_{s-1}
  __syncwarp();
  if (active && s == nsub - 1) {
    const long long e = static_cast<long long>(w) * nblk + blk;
    const long long sstride = static_cast<long long>(nwin) * nblk;
    zk::store_limbs<W>(sx, X, e, sstride);
    zk::store_limbs<W>(sy, Y, e, sstride);
    zk::store_limbs<W>(sz, Z, e, sstride);
  }
  if (head_tail && conn) {                        // the marked head: H + C_s
    const long long e = static_cast<long long>(w) * nb1 + a_first;
    if (!head) {
      zk::load_limbs<W>(X, bx, e, bstride);
      zk::load_limbs<W>(Y, by, e, bstride);
      zk::load_limbs<W>(Z, bz, e, bstride);
      add_from<W>(X, Y, Z, sh, lane - 1, k);
    }                                             // uniform: H + C_s = T'_s
    zk::store_limbs<W>(bx, X, e, bstride);
    zk::store_limbs<W>(by, Y, e, bstride);
    zk::store_limbs<W>(bz, Z, e, bstride);
  }
}

long long ctas(int nwin, int n, int m) {
  const long long threads = static_cast<long long>(nwin) * (n / m) * kSub;
  return (threads + kThreads - 1) / kThreads;
}

template <int W>
cudaError_t launch(const int32_t* x, const int32_t* y, const uint8_t* inf,
                   const int32_t* sd, const int32_t* idx, int32_t* bx,
                   int32_t* by, int32_t* bz, int32_t* sx, int32_t* sy,
                   int32_t* sz, const uint32_t* p, uint32_t n0,
                   const uint32_t* one, int b3, int nwin, int n, int npts,
                   int m, int nb1, cudaStream_t stream) {
  Consts<W> k;
  for (int i = 0; i < W; ++i) {
    k.p[i] = p[i];
    k.one[i] = one[i];
  }
  k.n0 = n0;
  k.b3 = b3;
  bucket_scan_kernel<W><<<static_cast<unsigned>(ctas(nwin, n, m)),
                          kThreads, 0, stream>>>(
      x, y, inf, sd, idx, bx, by, bz, sx, sy, sz, k, nwin, n, npts, m, nb1);
  return cudaGetLastError();
}

template <int W>
cudaError_t occupancy(int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bucket_scan_kernel<W>, kThreads, 0);
}

}  // namespace

// Resident CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
// CTAs launched for nwin windows of n positions at block m.
extern "C" int zk_bucket_scan_occupancy(int W, int nwin, int n, int m,
                                        int* blocks_per_sm,
                                        long long* n_ctas) {
  if (m <= 0 || n % m != 0) return static_cast<int>(cudaErrorInvalidValue);
  *n_ctas = ctas(nwin, n, m);
  switch (W) {
    case 8:
      return static_cast<int>(occupancy<8>(blocks_per_sm));
    case 12:
      return static_cast<int>(occupancy<12>(blocks_per_sm));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C entry point bound with ctypes.  p and one are HOST arrays of W words
// (the modulus and the Montgomery one), copied into the kernel's
// parameters.  Returns a cudaError_t (0 = launched).
extern "C" int zk_bucket_scan(const void* x, const void* y, const void* inf,
                              const void* sd, const void* idx, void* bx,
                              void* by, void* bz, void* sx, void* sy, void* sz,
                              const void* p, uint32_t n0, const void* one,
                              int b3, int W, int nwin, int n, int npts, int m,
                              int nb1, void* stream) {
  if (m <= 0 || n % m != 0 || b3 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto I = [](const void* q) { return static_cast<const int32_t*>(q); };
  auto O = [](void* q) { return static_cast<int32_t*>(q); };
  auto H = [](const void* q) { return static_cast<const uint32_t*>(q); };
  auto F = static_cast<const uint8_t*>(inf);
  switch (W) {
    case 8:
      return launch<8>(I(x), I(y), F, I(sd), I(idx), O(bx), O(by), O(bz),
                       O(sx), O(sy), O(sz), H(p), n0, H(one), b3, nwin, n,
                       npts, m, nb1, s);
    case 12:
      return launch<12>(I(x), I(y), F, I(sd), I(idx), O(bx), O(by), O(bz),
                        O(sx), O(sy), O(sz), H(p), n0, H(one), b3, nwin, n,
                        npts, m, nb1, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
