// Montgomery arithmetic in GF(p) on W radix-2^32 limbs held in registers.
//
// Shared by the kernels of this directory (mont_mul.cu inlines mont_mul,
// ntt_stage.cu mont_mul, add_mod and sub_mod, block_scan.cu and
// block_scan2.cu the whole file).  An element is uint32_t[W], least
// significant limb first, canonical in [0, p), in Montgomery form with
// R = 2^(32 W).  In device memory elements are limb planes: limb i of
// element e of a batch of n sits at index i * n + e, so the threads of a
// warp that handle neighbouring elements read neighbouring words.
//
// The product is CIOS (coarsely integrated operand scanning, Koc et al.
// 1996) with 64-bit accumulators, which the compiler lowers to IMAD.WIDE
// and carry-chained IADD3, followed by ONE conditional subtraction: for
// a, b < p the CIOS result is below 2p, so the output is canonical.
//
// The quadratic extension Fp2 = Fp[u] / (u^2 - qnr) is a pair of such
// elements (struct Fp2).  In device memory an Fp2 batch is (W, 2, n):
// limb i of component c of element e sits at (2 i + c) n + e, so a
// component is a limb-plane batch with limb stride 2 n.

#pragma once

#include <cstdint>

namespace zk {

template <int W>
__device__ __forceinline__ void load_limbs(uint32_t (&r)[W],
                                           const int32_t* __restrict__ a,
                                           long long e, long long n) {
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = static_cast<uint32_t>(a[i * n + e]);
}

template <int W>
__device__ __forceinline__ void store_limbs(int32_t* __restrict__ a,
                                            const uint32_t (&r)[W],
                                            long long e, long long n) {
#pragma unroll
  for (int i = 0; i < W; ++i) a[i * n + e] = static_cast<int32_t>(r[i]);
}

template <int W>
__device__ __forceinline__ void copy(uint32_t (&r)[W], const uint32_t (&a)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = a[i];
}

template <int W>
__device__ __forceinline__ void set_zero(uint32_t (&r)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = 0u;
}

template <int W>
__device__ __forceinline__ bool is_zero(const uint32_t (&a)[W]) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < W; ++i) acc |= a[i];
  return acc == 0u;
}

// r = t - p if t >= p else t, for t = (t[0..W-1], top) < 2p.
template <int W>
__device__ __forceinline__ void reduce_once(uint32_t (&r)[W],
                                            const uint32_t (&t)[W],
                                            uint32_t top,
                                            const uint32_t (&p)[W]) {
  uint32_t d[W];
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t s = static_cast<uint64_t>(t[i]) - p[i] - borrow;
    d[i] = static_cast<uint32_t>(s);
    borrow = static_cast<uint32_t>(s >> 63);
  }
  const bool use_d = (top != 0u) || (borrow == 0u);
#pragma unroll
  for (int i = 0; i < W; ++i) r[i] = use_d ? d[i] : t[i];
}

// r = a * b * R^-1 mod p; n0 = -p^-1 mod 2^32.  r may alias a or b.
template <int W>
__device__ __forceinline__ void mont_mul(uint32_t (&r)[W],
                                         const uint32_t (&a)[W],
                                         const uint32_t (&b)[W],
                                         const uint32_t (&p)[W],
                                         uint32_t n0) {
  uint32_t t[W + 2];
#pragma unroll
  for (int i = 0; i < W + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      uint64_t s = static_cast<uint64_t>(a[j]) * b[i] + t[j] + c;
      t[j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    uint64_t s = static_cast<uint64_t>(t[W]) + c;
    t[W] = static_cast<uint32_t>(s);
    t[W + 1] = static_cast<uint32_t>(s >> 32);
    const uint32_t m = t[0] * n0;
    s = static_cast<uint64_t>(m) * p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < W; ++j) {
      s = static_cast<uint64_t>(m) * p[j] + t[j] + c;
      t[j - 1] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    s = static_cast<uint64_t>(t[W]) + c;
    t[W - 1] = static_cast<uint32_t>(s);
    t[W] = t[W + 1] + static_cast<uint32_t>(s >> 32);
  }
  uint32_t lo[W];
#pragma unroll
  for (int i = 0; i < W; ++i) lo[i] = t[i];
  reduce_once<W>(r, lo, t[W], p);
}

// r = a + b mod p.
template <int W>
__device__ __forceinline__ void add_mod(uint32_t (&r)[W],
                                        const uint32_t (&a)[W],
                                        const uint32_t (&b)[W],
                                        const uint32_t (&p)[W]) {
  uint32_t s[W];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t x = static_cast<uint64_t>(a[i]) + b[i] + c;
    s[i] = static_cast<uint32_t>(x);
    c = x >> 32;
  }
  reduce_once<W>(r, s, static_cast<uint32_t>(c), p);
}

// r = a - b mod p.
template <int W>
__device__ __forceinline__ void sub_mod(uint32_t (&r)[W],
                                        const uint32_t (&a)[W],
                                        const uint32_t (&b)[W],
                                        const uint32_t (&p)[W]) {
  uint32_t d[W];
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t x = static_cast<uint64_t>(a[i]) - b[i] - borrow;
    d[i] = static_cast<uint32_t>(x);
    borrow = static_cast<uint32_t>(x >> 63);
  }
  const uint32_t mask = 0u - borrow;  // add p back when a < b
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t x = static_cast<uint64_t>(d[i]) + (p[i] & mask) + c;
    r[i] = static_cast<uint32_t>(x);
    c = x >> 32;
  }
}

// r = -a mod p (0 stays 0).
template <int W>
__device__ __forceinline__ void neg_mod(uint32_t (&r)[W],
                                        const uint32_t (&a)[W],
                                        const uint32_t (&p)[W]) {
  const uint32_t mask = is_zero<W>(a) ? 0u : 0xFFFFFFFFu;
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t x = static_cast<uint64_t>(p[i]) - a[i] - borrow;
    r[i] = static_cast<uint32_t>(x) & mask;
    borrow = static_cast<uint32_t>(x >> 63);
  }
}

// r = k * a mod p for a small k >= 1, by double-and-add (k <= 2^16).
template <int W>
__device__ __forceinline__ void scale_small(uint32_t (&r)[W],
                                            const uint32_t (&a)[W], int k,
                                            const uint32_t (&p)[W]) {
  uint32_t acc[W];
  copy<W>(acc, a);
  int top = 31 - __clz(k);
  for (int bit = top - 1; bit >= 0; --bit) {
    add_mod<W>(acc, acc, acc, p);
    if ((k >> bit) & 1) add_mod<W>(acc, acc, a, p);
  }
  copy<W>(r, acc);
}

// ---- Fp2 = Fp[u] / (u^2 - qnr) -------------------------------------------

template <int W>
struct Fp2 {
  uint32_t c0[W];
  uint32_t c1[W];
};

// Element e of a (W, 2, n) batch.
template <int W>
__device__ __forceinline__ void load_fp2(Fp2<W>& r,
                                         const int32_t* __restrict__ a,
                                         long long e, long long n) {
  load_limbs<W>(r.c0, a, e, 2 * n);
  load_limbs<W>(r.c1, a + n, e, 2 * n);
}

template <int W>
__device__ __forceinline__ void store_fp2(int32_t* __restrict__ a,
                                          const Fp2<W>& r, long long e,
                                          long long n) {
  store_limbs<W>(a, r.c0, e, 2 * n);
  store_limbs<W>(a + n, r.c1, e, 2 * n);
}

template <int W>
__device__ __forceinline__ void f2_copy(Fp2<W>& r, const Fp2<W>& a) {
  copy<W>(r.c0, a.c0);
  copy<W>(r.c1, a.c1);
}

template <int W>
__device__ __forceinline__ void f2_set_zero(Fp2<W>& r) {
  set_zero<W>(r.c0);
  set_zero<W>(r.c1);
}

template <int W>
__device__ __forceinline__ void f2_add(Fp2<W>& r, const Fp2<W>& a,
                                       const Fp2<W>& b,
                                       const uint32_t (&p)[W]) {
  add_mod<W>(r.c0, a.c0, b.c0, p);
  add_mod<W>(r.c1, a.c1, b.c1, p);
}

template <int W>
__device__ __forceinline__ void f2_sub(Fp2<W>& r, const Fp2<W>& a,
                                       const Fp2<W>& b,
                                       const uint32_t (&p)[W]) {
  sub_mod<W>(r.c0, a.c0, b.c0, p);
  sub_mod<W>(r.c1, a.c1, b.c1, p);
}

template <int W>
__device__ __forceinline__ void f2_neg(Fp2<W>& r, const Fp2<W>& a,
                                       const uint32_t (&p)[W]) {
  neg_mod<W>(r.c0, a.c0, p);
  neg_mod<W>(r.c1, a.c1, p);
}

template <int W>
__device__ __forceinline__ void f2_scale_small(Fp2<W>& r, const Fp2<W>& a,
                                               int k,
                                               const uint32_t (&p)[W]) {
  scale_small<W>(r.c0, a.c0, k, p);
  scale_small<W>(r.c1, a.c1, k, p);
}

// r = qnr a for a base element a: a negation for qnr = -1, else |qnr| a
// by additions, negated for qnr < 0.  r may alias a.
template <int W>
__device__ __forceinline__ void mul_nr(uint32_t (&r)[W],
                                       const uint32_t (&a)[W], int qnr,
                                       const uint32_t (&p)[W]) {
  if (qnr == -1) {
    neg_mod<W>(r, a, p);
    return;
  }
  scale_small<W>(r, a, qnr < 0 ? -qnr : qnr, p);
  if (qnr < 0) neg_mod<W>(r, r, p);
}

// r = a b, Karatsuba with three Montgomery products (the recipe of
// ops/tower.py QuadExt.mul_list): t0 = a0 b0, t1 = a1 b1,
// t2 = (a0 + a1)(b0 + b1); c0 = t0 + qnr t1, c1 = t2 - (t0 + t1).
// r may alias a or b.  K4 calls it through a function that is not
// inlined (block_scan2.cu), so that the madd's Fp2 values stay in the
// stack frame across the call and the CIOS temporaries get the registers.
template <int W>
__device__ __forceinline__ void f2_mul(Fp2<W>& r, const Fp2<W>& a,
                                       const Fp2<W>& b,
                                       const uint32_t (&p)[W], uint32_t n0,
                                       int qnr) {
  uint32_t t0[W], t1[W], s[W], t[W];
  mont_mul<W>(t0, a.c0, b.c0, p, n0);
  mont_mul<W>(t1, a.c1, b.c1, p, n0);
  add_mod<W>(s, a.c0, a.c1, p);
  add_mod<W>(t, b.c0, b.c1, p);
  mont_mul<W>(s, s, t, p, n0);                    // t2
  add_mod<W>(t, t0, t1, p);
  sub_mod<W>(r.c1, s, t, p);
  mul_nr<W>(t1, t1, qnr, p);
  add_mod<W>(r.c0, t0, t1, p);
}

}  // namespace zk
