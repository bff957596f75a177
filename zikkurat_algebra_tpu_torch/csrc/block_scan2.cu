// Kernel K4: level-1 bucket accumulation of the G2 Pippenger MSM, over Fp2.
//
// Replaces: zikkurat_algebra_tpu/ops/pallas_curve.py, `_build_block_scan2`
// (pallas_call at :341) reached from `block_madd_scan2` (:352), with
// `_block_scan_kernel2`, `_madd2` and `_f2_mul`.  Like K2 (block_scan.cu),
// whose interface, output and design it keeps, a lane gathers its points
// by index and writes only the running value at each segment's global
// tail into bucket[w, digit] and each block's trailer S[w, blk], where the
// TPU kernel streams a packed payload and writes every running value (six
// (L, m, B) planes).  Coordinates are (W, 2, npts) planes (field.cuh),
// buckets (W, 2, nwin, nbuckets + 1) and trailers (W, 2, nwin, nblk).
//
// The running value of a block restarts at the block's first position and
// wherever |digit| changes; otherwise acc = madd2(acc, pt), RCB15
// algorithm 8 for a = 0 over Fp2 with b3 an Fp2 constant, in the
// operation order of `_madd2` (11 Fp2 products, 33 Montgomery products).
// A point at infinity leaves acc as it is; a negative digit negates y.
//
// Each block of m positions is split among S = min(4, m) sub-lanes, four
// neighbouring threads of one warp, as in K2: sub-lane s walks positions
// [s m / S, (s + 1) m / S), writes the tails of the runs that start inside
// its range, writes its head's value H where the head ends at a global
// tail (and marks it), and ends holding T, its value at its last position.
// The combine is K2's segmented Hillis-Steele scan (ops/msm.py
// `_level2_carries` one level down) over Fp2:
//     T'_s = T_s + [uniform_s and conn_s] T'_{s-1},  C_s = [conn_s] T'_{s-1},
// by complete additions (RCB15 algorithm 7, ops/curve.py
// ProjCurveOps.add: 14 Fp2 products, two of them by b3).  A marked head
// becomes H + C_s, and the block's trailer is T' of its last sub-lane.
// The other sub-lane's point moves through __shfl_up_sync, limb by limb,
// so the kernel uses no shared memory and L1 keeps nearly all of its room
// for the stack frames below.  The sums associate differently from one lane
// per block, so the points are the same in other projective coordinates.
//
// Bound on the H100: integer multiplies.  A madd2 is 33 Montgomery
// products of 4 W^2 + W multiply-adds (19,404 at W = 12, three times K2's)
// against about 200 bytes read per position.  The state does not fit in
// registers: the Fp2 accumulator is 6 W = 72 words, the point 4 W = 48,
// and the madd keeps up to seven Fp2 temporaries.  So the Fp2 product is
// a called function (f2_mul_called): the Fp2 values live in the thread's
// stack frame (local memory, cached in L1) and pass to it by reference,
// and its CIOS runs in registers.  A called function cannot address the
// kernel parameters' constant bank, so it reads the modulus from a
// __constant__ array that the host writes on the launch's stream before
// each launch; the kernel body reads the other constants (b3 included)
// from a __grid_constant__ parameter.  The stack frames (about 2 KB a
// thread) do not fit in L1 at any useful occupancy, and the time stays
// flat from 8 to 12 one-warp CTAs per SM (255 and 168 registers; a warp
// takes its registers from one of the SM's four 16 K-register
// partitions) and rises below 8.  Four sub-lanes need fewer combine
// additions than eight and give 4 x nwin x n / m threads (147,456 on the
// G2 path at 2^20, 4608 CTAs, about 2.9 waves), so no thin last wave is
// left.  Registers, spills and the stack frame are printed by
// -Xptxas -v; scripts/kernel_variants.py times the alternatives
// (sub-lanes, register caps, the product inlined or interleaved, the
// combine through shared memory, a persistent grid) and PERF.md keeps
// their times.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

template <int W>
using F2 = zk::Fp2<W>;

// The field's and the curve's constants, passed by value as a kernel
// parameter.
template <int W>
struct Consts {
  uint32_t p[W];
  uint32_t one[W];           // the Montgomery one, R mod p
  F2<W> b3;                  // 3 b' in Montgomery form
  uint32_t n0;
  int qnr;
};

// The modulus of the called product, one array per limb count, written
// by set_modulus on the launch's stream before each launch.  Two launches
// with the same W and different moduli must therefore not run at once
// on different streams.
__constant__ uint32_t kModulus8[8];
__constant__ uint32_t kModulus12[12];

template <int W>
__device__ __forceinline__ const uint32_t (&modulus())[W] {
  static_assert(W == 8 || W == 12, "K4 is built for W = 8 and 12");
  if constexpr (W == 8) {
    return kModulus8;
  } else {
    return kModulus12;
  }
}

template <int W>
cudaError_t set_modulus(const uint32_t* p, cudaStream_t stream) {
  if constexpr (W == 8) {
    return cudaMemcpyToSymbolAsync(kModulus8, p, sizeof(kModulus8), 0,
                                   cudaMemcpyHostToDevice, stream);
  } else {
    return cudaMemcpyToSymbolAsync(kModulus12, p, sizeof(kModulus12), 0,
                                   cudaMemcpyHostToDevice, stream);
  }
}

// r = a b in Fp2, not inlined: its operands stay in the caller's stack
// frame, and its CIOS takes the modulus as constant-bank operands.
template <int W>
__device__ __noinline__ void f2_mul_called(F2<W>& r, const F2<W>& a,
                                           const F2<W>& b, uint32_t n0,
                                           int qnr) {
  zk::f2_mul<W>(r, a, b, modulus<W>(), n0, qnr);
}

template <int W>
__device__ __forceinline__ void mul(F2<W>& r, const F2<W>& a, const F2<W>& b,
                                    const Consts<W>& k) {
  f2_mul_called<W>(r, a, b, k.n0, k.qnr);
}

// (X, Y, Z) += (x2, y2), RCB15 algorithm 8 over Fp2, a = 0.
template <int W>
__device__ __forceinline__ void madd2(F2<W>& X, F2<W>& Y, F2<W>& Z,
                                      const F2<W>& x2, const F2<W>& y2,
                                      const Consts<W>& k) {
  F2<W> t0, t1, t3, t4, t5, u, v;
  mul<W>(t0, X, x2, k);
  mul<W>(t1, Y, y2, k);
  zk::f2_add<W>(u, x2, y2, k.p);
  zk::f2_add<W>(v, X, Y, k.p);
  mul<W>(t3, u, v, k);                            // m3
  zk::f2_add<W>(u, t0, t1, k.p);
  zk::f2_sub<W>(t3, t3, u, k.p);                  // t3 = m3 - (t0 + t1)
  mul<W>(t4, x2, Z, k);                           // m4
  zk::f2_add<W>(t4, t4, X, k.p);                  // t4 = m4 + X1
  mul<W>(t5, y2, Z, k);                           // m5
  zk::f2_add<W>(t5, t5, Y, k.p);                  // t5 = m5 + Y1
  zk::f2_scale_small<W>(X, t0, 3, k.p);           // X3 = 3 t0
  mul<W>(u, Z, k.b3, k);                          // t2 = b3 Z1
  zk::f2_add<W>(Z, t1, u, k.p);                   // Z3 = t1 + t2
  zk::f2_sub<W>(t1, t1, u, k.p);                  // t1 = t1 - t2
  mul<W>(Y, t4, k.b3, k);                         // Y3 = b3 t4
  // X = X3, Y = Y3, Z = Z3; live: t1, t3, t5
  mul<W>(u, t3, t1, k);                           // p0
  mul<W>(v, t5, Y, k);                            // p1
  zk::f2_sub<W>(t0, u, v, k.p);                   // X out
  mul<W>(u, Y, X, k);                             // p2
  mul<W>(v, t1, Z, k);                            // p3
  zk::f2_add<W>(t4, u, v, k.p);                   // Y out
  mul<W>(u, Z, t5, k);                            // p4
  mul<W>(v, X, t3, k);                            // p5
  zk::f2_add<W>(Z, u, v, k.p);                    // Z out
  zk::f2_copy<W>(X, t0);
  zk::f2_copy<W>(Y, t4);
}

// (X, Y, Z) += (X2, Y2, Z2), RCB15 algorithm 7 over Fp2, a = 0, in the
// operation order of ops/curve.py ProjCurveOps.add.
template <int W>
__device__ __forceinline__ void add2(F2<W>& X, F2<W>& Y, F2<W>& Z,
                                     const F2<W>& X2, const F2<W>& Y2,
                                     const F2<W>& Z2, const Consts<W>& k) {
  F2<W> a, b, t0, t1, t2, t3, t4, y3;
  mul<W>(t0, X, X2, k);                           // t0 = X1 X2
  mul<W>(t1, Y, Y2, k);                           // t1 = Y1 Y2
  zk::f2_add<W>(a, X2, Y2, k.p);
  zk::f2_add<W>(b, X, Y, k.p);
  mul<W>(t3, b, a, k);                            // m3
  zk::f2_add<W>(a, t0, t1, k.p);
  zk::f2_sub<W>(t3, t3, a, k.p);                  // t3 = m3 - (t0 + t1)
  mul<W>(t2, Z, Z2, k);                           // t2 = Z1 Z2
  zk::f2_add<W>(a, Y2, Z2, k.p);
  zk::f2_add<W>(b, Y, Z, k.p);
  mul<W>(t4, b, a, k);                            // m4
  zk::f2_add<W>(a, t1, t2, k.p);
  zk::f2_sub<W>(t4, t4, a, k.p);                  // t4 = m4 - (t1 + t2)
  zk::f2_add<W>(a, X2, Z2, k.p);
  zk::f2_add<W>(b, X, Z, k.p);
  mul<W>(y3, b, a, k);                            // m5
  zk::f2_add<W>(a, t0, t2, k.p);
  zk::f2_sub<W>(y3, y3, a, k.p);                  // Y3 = m5 - (t0 + t2)
  zk::f2_scale_small<W>(X, t0, 3, k.p);           // X3 = 3 t0
  mul<W>(a, t2, k.b3, k);                         // t2 = b3 t2
  zk::f2_add<W>(Z, t1, a, k.p);                   // Z3 = t1 + t2
  zk::f2_sub<W>(t1, t1, a, k.p);                  // t1 = t1 - t2
  mul<W>(Y, y3, k.b3, k);                         // Y3 = b3 Y3
  // X = X3, Y = Y3, Z = Z3; live: t1, t3, t4
  mul<W>(a, t3, t1, k);                           // p0
  mul<W>(b, t4, Y, k);                            // p1
  zk::f2_sub<W>(t0, a, b, k.p);                   // X out
  mul<W>(a, Y, X, k);                             // p2
  mul<W>(b, t1, Z, k);                            // p3
  zk::f2_add<W>(t2, a, b, k.p);                   // Y out
  mul<W>(a, Z, t4, k);                            // p4
  mul<W>(b, X, t3, k);                            // p5
  zk::f2_add<W>(Z, a, b, k.p);                    // Z out
  zk::f2_copy<W>(X, t0);
  zk::f2_copy<W>(Y, t2);
}

constexpr int kSub = 4;        // sub-lanes per block: a power of two <= 32
constexpr int kThreads = 32;   // one warp per CTA
constexpr unsigned kFull = 0xffffffffu;

// (X2, Y2, Z2) = the point of sub-lane s - j of the same block (a lane's
// own point where s < j).  Every thread of the warp takes part.
template <int W>
__device__ __forceinline__ void point_up(F2<W>& X2, F2<W>& Y2, F2<W>& Z2,
                                         const F2<W>& X, const F2<W>& Y,
                                         const F2<W>& Z, int j) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    X2.c0[i] = __shfl_up_sync(kFull, X.c0[i], j, kSub);
    X2.c1[i] = __shfl_up_sync(kFull, X.c1[i], j, kSub);
    Y2.c0[i] = __shfl_up_sync(kFull, Y.c0[i], j, kSub);
    Y2.c1[i] = __shfl_up_sync(kFull, Y.c1[i], j, kSub);
    Z2.c0[i] = __shfl_up_sync(kFull, Z.c0[i], j, kSub);
    Z2.c1[i] = __shfl_up_sync(kFull, Z.c1[i], j, kSub);
  }
}

// At most 168 registers: 12 one-warp CTAs per SM.
template <int W>
__global__ void __launch_bounds__(kThreads, 12)
bucket_scan2_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ y,
                    const uint8_t* __restrict__ inf,
                    const int32_t* __restrict__ sd,
                    const int32_t* __restrict__ idx,
                    int32_t* __restrict__ bx, int32_t* __restrict__ by,
                    int32_t* __restrict__ bz, int32_t* __restrict__ sx,
                    int32_t* __restrict__ sy, int32_t* __restrict__ sz,
                    __grid_constant__ const Consts<W> k, int nwin, int n,
                    int npts, int m, int nb1) {
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
  F2<W> X, Y, Z, x2, y2;
  zk::f2_set_zero<W>(X);
  zk::f2_set_zero<W>(Y);
  zk::f2_set_zero<W>(Z);
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
        zk::load_fp2<W>(x2, x, pt, npts);
        zk::load_fp2<W>(y2, y, pt, npts);
        if (negate) zk::f2_neg<W>(y2, y2, k.p);
      }
      if (restart) {
        // from_affine: (0 : 1 : 0) for infinity, else (x : y : 1)
        if (pinf) {
          zk::f2_set_zero<W>(X);
          zk::copy<W>(Y.c0, k.one);
          zk::set_zero<W>(Y.c1);
          zk::f2_set_zero<W>(Z);
        } else {
          zk::f2_copy<W>(X, x2);
          zk::f2_copy<W>(Y, y2);
          zk::copy<W>(Z.c0, k.one);
          zk::set_zero<W>(Z.c1);
        }
      } else if (!pinf) {
        madd2<W>(X, Y, Z, x2, y2, k);
      }
      a_prev = a;
      const int a_next = next < 0 ? -next : next;
      if (pos + 1 == n || a_next != a) {           // global segment tail
        const long long e = static_cast<long long>(w) * nb1 + a;
        zk::store_fp2<W>(bx, X, e, bstride);
        zk::store_fp2<W>(by, Y, e, bstride);
        zk::store_fp2<W>(bz, Z, e, bstride);
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
  // sub-lanes, the other sub-lane's point moved by warp shuffles.
  F2<W> X2, Y2, Z2;
  bool brk = !(head && conn);
  for (int j = 1; j < kSub; j <<= 1) {
    point_up<W>(X2, Y2, Z2, X, Y, Z, j);
    const bool brk_prev = __shfl_up_sync(kFull, brk, j, kSub);
    if (active && s >= j && !brk) add2<W>(X, Y, Z, X2, Y2, Z2, k);
    if (s >= j) brk = brk || brk_prev;
  }
  point_up<W>(X2, Y2, Z2, X, Y, Z, 1);            // C_s = T'_{s-1}
  if (active && s == nsub - 1) {
    const long long e = static_cast<long long>(w) * nblk + blk;
    const long long sstride = static_cast<long long>(nwin) * nblk;
    zk::store_fp2<W>(sx, X, e, sstride);
    zk::store_fp2<W>(sy, Y, e, sstride);
    zk::store_fp2<W>(sz, Z, e, sstride);
  }
  if (head_tail && conn) {                        // the marked head: H + C_s
    const long long e = static_cast<long long>(w) * nb1 + a_first;
    if (!head) {
      zk::load_fp2<W>(X, bx, e, bstride);
      zk::load_fp2<W>(Y, by, e, bstride);
      zk::load_fp2<W>(Z, bz, e, bstride);
      add2<W>(X, Y, Z, X2, Y2, Z2, k);
    }                                             // uniform: H + C_s = T'_s
    zk::store_fp2<W>(bx, X, e, bstride);
    zk::store_fp2<W>(by, Y, e, bstride);
    zk::store_fp2<W>(bz, Z, e, bstride);
  }
}

long long ctas(int nwin, int n, int m) {
  const long long threads = static_cast<long long>(nwin) * (n / m) * kSub;
  return (threads + kThreads - 1) / kThreads;
}

// The kernel declares no shared memory, but the runtime reserves 1 KB of
// it for each resident CTA.  8% of the SM's 228 KB of shared memory holds
// the reserve of 16 CTAs, and L1 keeps the rest of the 256 KB for the
// stack frames.  A carveout of 0 leaves room for 8 CTAs only.
constexpr int kCarveoutPercent = 8;

template <int W>
cudaError_t prefer_l1() {
  return cudaFuncSetAttribute(bucket_scan2_kernel<W>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              kCarveoutPercent);
}

template <int W>
cudaError_t launch(const int32_t* x, const int32_t* y, const uint8_t* inf,
                   const int32_t* sd, const int32_t* idx, int32_t* bx,
                   int32_t* by, int32_t* bz, int32_t* sx, int32_t* sy,
                   int32_t* sz, const uint32_t* p, uint32_t n0,
                   const uint32_t* one, const uint32_t* b3, int qnr,
                   int nwin, int n, int npts, int m, int nb1,
                   cudaStream_t stream) {
  Consts<W> k;
  for (int i = 0; i < W; ++i) {
    k.p[i] = p[i];
    k.one[i] = one[i];
    k.b3.c0[i] = b3[i];
    k.b3.c1[i] = b3[W + i];
  }
  k.n0 = n0;
  k.qnr = qnr;
  cudaError_t rc = prefer_l1<W>();
  if (rc != cudaSuccess) return rc;
  rc = set_modulus<W>(p, stream);
  if (rc != cudaSuccess) return rc;
  bucket_scan2_kernel<W><<<static_cast<unsigned>(ctas(nwin, n, m)),
                           kThreads, 0, stream>>>(
      x, y, inf, sd, idx, bx, by, bz, sx, sy, sz, k, nwin, n, npts, m, nb1);
  return cudaGetLastError();
}

template <int W>
cudaError_t occupancy(int* blocks_per_sm) {
  cudaError_t rc = prefer_l1<W>();
  if (rc != cudaSuccess) return rc;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bucket_scan2_kernel<W>, kThreads, 0);
}

}  // namespace

// Resident CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
// CTAs launched for nwin windows of n positions at block m.
extern "C" int zk_bucket_scan2_occupancy(int W, int nwin, int n, int m,
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
// (the modulus and the Montgomery one), b3 a HOST array of 2 W words (the
// Fp2 Montgomery constant, c0 then c1), all copied into the kernel's
// parameters; qnr is the nonresidue u^2.  Returns a cudaError_t
// (0 = launched).
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
  auto H = [](const void* q) { return static_cast<const uint32_t*>(q); };
  auto F = static_cast<const uint8_t*>(inf);
  switch (W) {
    case 8:
      return launch<8>(I(x), I(y), F, I(sd), I(idx), O(bx), O(by), O(bz),
                       O(sx), O(sy), O(sz), H(p), n0, H(one), H(b3), qnr,
                       nwin, n, npts, m, nb1, s);
    case 12:
      return launch<12>(I(x), I(y), F, I(sd), I(idx), O(bx), O(by), O(bz),
                        O(sx), O(sy), O(sz), H(p), n0, H(one), H(b3), qnr,
                        nwin, n, npts, m, nb1, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
