// The complete projective group law of y^2 = x^3 + b over GF(p), a = 0,
// on W-limb Montgomery elements held in registers (field.cuh).
//
// proj_add is RCB15 algorithm 7 and proj_dbl algorithm 9 (Renes,
// Costello, Batina, "Complete addition formulas for prime order
// elliptic curves", 2015), in the operation order of ops/curve.py
// ProjCurveOps.add and .dbl.  Every value is canonical, so each product
// by a small constant (3 in the addition, 3 and 8 in the doubling) is
// the same field value as the torch law's product by that constant, and
// the outputs equal the torch law's limb for limb.  The product by
// b3 = 3 b is a Montgomery product by b3 R mod p, as in the torch law, so
// the kernel takes any b.
//
// Only point_ops.cu includes this file.  K2 (block_scan.cu) keeps its own
// copy of the addition, reading the second point from shared memory.

#pragma once

#include <cstdint>

#include "field.cuh"

namespace zk {

template <int W>
struct CurveConsts {
  uint32_t p[W];
  uint32_t b3[W];            // 3 b in Montgomery form, b3 R mod p
  uint32_t n0;               // -p^-1 mod 2^32
};

// (X, Y, Z) += (X2, Y2, Z2): 14 products (12 + 2 by b3), in place.
template <int W>
__device__ __forceinline__ void proj_add(uint32_t (&X)[W], uint32_t (&Y)[W],
                                         uint32_t (&Z)[W],
                                         const uint32_t (&X2)[W],
                                         const uint32_t (&Y2)[W],
                                         const uint32_t (&Z2)[W],
                                         const CurveConsts<W>& k) {
  uint32_t a[W], b[W], t0[W], t1[W], t2[W], t3[W], t4[W], y3[W];
  mont_mul<W>(t0, X, X2, k.p, k.n0);              // t0 = X1 X2
  mont_mul<W>(t1, Y, Y2, k.p, k.n0);              // t1 = Y1 Y2
  mont_mul<W>(t2, Z, Z2, k.p, k.n0);              // t2 = Z1 Z2
  add_mod<W>(a, X, Y, k.p);
  add_mod<W>(b, X2, Y2, k.p);
  mont_mul<W>(t3, a, b, k.p, k.n0);               // m3
  add_mod<W>(a, t0, t1, k.p);
  sub_mod<W>(t3, t3, a, k.p);                     // t3 = m3 - (t0 + t1)
  add_mod<W>(a, Y, Z, k.p);
  add_mod<W>(b, Y2, Z2, k.p);
  mont_mul<W>(t4, a, b, k.p, k.n0);               // m4
  add_mod<W>(a, t1, t2, k.p);
  sub_mod<W>(t4, t4, a, k.p);                     // t4 = m4 - (t1 + t2)
  add_mod<W>(a, X, Z, k.p);
  add_mod<W>(b, X2, Z2, k.p);
  mont_mul<W>(y3, a, b, k.p, k.n0);               // m5
  add_mod<W>(a, t0, t2, k.p);
  sub_mod<W>(y3, y3, a, k.p);                     // Y3 = m5 - (t0 + t2)
  scale_small<W>(X, t0, 3, k.p);                  // X3 = 3 t0
  mont_mul<W>(a, t2, k.b3, k.p, k.n0);            // t2 = b3 t2
  add_mod<W>(Z, t1, a, k.p);                      // Z3 = t1 + t2
  sub_mod<W>(t1, t1, a, k.p);                     // t1 = t1 - t2
  mont_mul<W>(Y, y3, k.b3, k.p, k.n0);            // Y3 = b3 Y3
  // X = X3, Y = Y3, Z = Z3; live: t1, t3, t4
  mont_mul<W>(a, t3, t1, k.p, k.n0);              // p0
  mont_mul<W>(b, t4, Y, k.p, k.n0);               // p1
  sub_mod<W>(t0, a, b, k.p);                      // X out = p0 - p1
  mont_mul<W>(a, Y, X, k.p, k.n0);                // p2
  mont_mul<W>(b, t1, Z, k.p, k.n0);               // p3
  add_mod<W>(t2, a, b, k.p);                      // Y out = p2 + p3
  mont_mul<W>(a, Z, t4, k.p, k.n0);               // p4
  mont_mul<W>(b, X, t3, k.p, k.n0);               // p5
  add_mod<W>(Z, a, b, k.p);                       // Z out = p4 + p5
  copy<W>(X, t0);
  copy<W>(Y, t2);
}

// (X, Y, Z) = 2 (X, Y, Z): 9 products (8 + 1 by b3), in place.
template <int W>
__device__ __forceinline__ void proj_dbl(uint32_t (&X)[W], uint32_t (&Y)[W],
                                         uint32_t (&Z)[W],
                                         const CurveConsts<W>& k) {
  uint32_t t0[W], t1[W], t2[W], xy[W];
  mont_mul<W>(t0, Y, Y, k.p, k.n0);               // t0 = Y^2
  mont_mul<W>(t1, Y, Z, k.p, k.n0);               // t1 = Y Z
  mont_mul<W>(t2, Z, Z, k.p, k.n0);               // t2 = Z^2
  mont_mul<W>(xy, X, Y, k.p, k.n0);               // X Y
  scale_small<W>(Z, t0, 8, k.p);                  // Z3 = 8 t0
  mont_mul<W>(t2, t2, k.b3, k.p, k.n0);           // t2 = b3 t2
  add_mod<W>(Y, t0, t2, k.p);                     // Y3 = t0 + t2
  scale_small<W>(X, t2, 3, k.p);
  sub_mod<W>(t0, t0, X, k.p);                     // t0 = t0 - 3 t2
  mont_mul<W>(X, t2, Z, k.p, k.n0);               // q0 = t2 Z3
  mont_mul<W>(t1, t1, Z, k.p, k.n0);              // q1 = t1 Z3
  mont_mul<W>(t2, t0, Y, k.p, k.n0);              // q2 = t0 Y3
  mont_mul<W>(xy, t0, xy, k.p, k.n0);             // q3 = t0 X Y
  add_mod<W>(Y, X, t2, k.p);                      // Y out = q0 + q2
  add_mod<W>(X, xy, xy, k.p);                     // X out = q3 + q3
  copy<W>(Z, t1);                                 // Z out = q1
}

}  // namespace zk
