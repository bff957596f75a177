"""G1 and G2 group laws on limb planes: the complete projective formulas.

The torch counterpart of zikkurat_algebra_tpu/ops/curve.py (ProjCurveOps,
CurveKernels).  `add`, `dbl` and `madd` are RCB15 algorithms 7, 9 and 8
for a = 0 (Renes-Costello-Batina 2015), in the same operation order as
the JAX package, so both give the same X, Y, Z as field values.  The
coordinate field is `Field` (G1, elements (W, *batch)) or `QuadExt`
(G2, elements (W, 2, *batch)); the code only reads its `struct_ndim`.
Independent products go through `mul_list` (one K1 launch) and
independent sums through `add_list` / `sub_list`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..errors import UnsupportedError
from ..oracle.groups import g1_group, g2_group
from ..params import CurveParams
from .tower import TowerKernels

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]    # (X, Y, Z)
AffBatch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (x, y, inf)


class ProjCurveOps:
    """Branch-free projective group law over the coordinate field `f`,
    for y^2 = x^3 + b with b3 = 3 b: a small int (G1) or an Fp2 value
    (c0, c1) in standard form (G2)."""

    def __init__(self, f, b3: Union[int, Tuple[int, int]], scalar_bits: int,
                 name: str = ""):
        self.f = f
        self.b3 = b3
        self.scalar_bits = scalar_bits
        self.name = name

    def _bs(self, t: torch.Tensor) -> tuple:
        """The batch shape of a coordinate tensor."""
        return t.shape[self.f.struct_ndim:]

    def _b3(self, t: torch.Tensor) -> torch.Tensor:
        """b3 as a field element broadcast to t's batch."""
        return self.f.const(self.b3, self._bs(t))

    def mul_b3(self, t: torch.Tensor) -> torch.Tensor:
        """b3 t: one product by the constant (curve.py:54-61)."""
        return self.f.mul(t, self._b3(t))

    def plain(self) -> "ProjCurveOps":
        """The same group law with every product on the plain version."""
        return ProjCurveOps(self.f.plain(), self.b3, self.scalar_bits,
                            self.name)

    def infinity(self, batch_shape=()) -> Point:
        f = self.f
        return (f.zero(batch_shape), f.one(batch_shape).contiguous(),
                f.zero(batch_shape))

    def is_inf(self, P: Point) -> torch.Tensor:
        return self.f.is_zero(P[2])

    def is_on_curve(self, P: Point) -> torch.Tensor:
        """3 (Y^2 Z) == 3 X^3 + (3b) Z^3 (homogenized, a = 0)."""
        f = self.f
        y2, x2, z2 = f.mul_list([(P[1], P[1]), (P[0], P[0]), (P[2], P[2])])
        lhs, x3, z3 = f.mul_list([(y2, P[2]), (x2, P[0]), (z2, P[2])])
        return f.eq(f.scale_small(lhs, 3),
                    f.add(f.scale_small(x3, 3), self.mul_b3(z3)))

    def neg(self, P: Point) -> Point:
        return (P[0], self.f.neg(P[1]), P[2])

    def add(self, P: Point, Q: Point) -> Point:
        """Complete projective addition, RCB15 algorithm 7 (a = 0)."""
        f = self.f
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        s = f.add_list([(X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2),
                        (X1, Z1), (X2, Z2)])
        t0, t1, t2, m3, m4, m5 = f.mul_list([
            (X1, X2), (Y1, Y2), (Z1, Z2), (s[0], s[1]), (s[2], s[3]),
            (s[4], s[5]),
        ])
        u = f.add_list([(t0, t1), (t1, t2), (t0, t2)])
        t3, t4, Y3 = f.sub_list([(m3, u[0]), (m4, u[1]), (m5, u[2])])
        X3, t2b = f.mul_list([(t0, f.const(3, self._bs(t0))),
                              (t2, self._b3(t2))])
        Z3 = f.add(t1, t2b)
        t1 = f.sub(t1, t2b)
        Y3 = self.mul_b3(Y3)
        p0, p1, p2, p3, p4, p5 = f.mul_list([
            (t3, t1), (t4, Y3), (Y3, X3), (t1, Z3), (Z3, t4), (X3, t3),
        ])
        Y, Z = f.add_list([(p2, p3), (p4, p5)])
        return (f.sub(p0, p1), Y, Z)

    def dbl(self, P: Point) -> Point:
        """Complete projective doubling, RCB15 algorithm 9 (a = 0)."""
        f = self.f
        X, Y, Z = P
        t0, t1, t2, xy = f.mul_list([(Y, Y), (Y, Z), (Z, Z), (X, Y)])
        Z3, t2 = f.mul_list([(t0, f.const(8, self._bs(t0))),
                             (t2, self._b3(t2))])
        Y3 = f.add(t0, t2)
        t0 = f.sub(t0, f.scale_small(t2, 3))
        q0, q1, q2, q3 = f.mul_list([(t2, Z3), (t1, Z3), (t0, Y3), (t0, xy)])
        X3, Y3 = f.add_list([(q3, q3), (q0, q2)])
        return (X3, Y3, q1)

    def madd(self, P: Point, Q: AffBatch) -> Point:
        """Mixed addition P + (x2, y2, inf2), RCB15 algorithm 8 (a = 0);
        an affine infinity leaves P as it is (one final select)."""
        f = self.f
        X1, Y1, Z1 = P
        X2, Y2, inf2 = Q
        s = f.add_list([(X2, Y2), (X1, Y1)])
        t0, t1, m3, m4, m5 = f.mul_list([
            (X1, X2), (Y1, Y2), (s[0], s[1]), (X2, Z1), (Y2, Z1),
        ])
        t3 = f.sub(m3, f.add(t0, t1))
        t4, t5 = f.add_list([(m4, X1), (m5, Y1)])
        X3, t2, Y3 = f.mul_list([
            (t0, f.const(3, self._bs(t0))), (Z1, self._b3(Z1)),
            (t4, self._b3(t4)),
        ])
        Z3 = f.add(t1, t2)
        t1 = f.sub(t1, t2)
        p0, p1, p2, p3, p4, p5 = f.mul_list([
            (t3, t1), (t5, Y3), (Y3, X3), (t1, Z3), (Z3, t5), (X3, t3),
        ])
        Y3n, Z3n = f.add_list([(p2, p3), (p4, p5)])
        X3n = f.sub(p0, p1)
        return self.select(inf2, P, (X3n, Y3n, Z3n))

    def select(self, pred, P: Point, Q: Point) -> Point:
        s = self.f.select
        return (s(pred, P[0], Q[0]), s(pred, P[1], Q[1]), s(pred, P[2], Q[2]))

    def to_affine(self, P: Point) -> AffBatch:
        """(X/Z, Y/Z, inf) through one batched inversion."""
        f = self.f
        inf = self.is_inf(P)
        zinv = f.batch_inv(P[2])
        x, y = f.mul_list([(P[0], zinv), (P[1], zinv)])
        return (x, y, inf)

    def from_affine(self, A: AffBatch) -> Point:
        f = self.f
        x, y, inf = A
        bs = self._bs(x)
        one = f.one(bs)
        zero = f.zero(bs)
        s = f.select
        return (s(inf, zero, x), s(inf, one, y), s(inf, zero, one))


class CurveKernels:
    """G1 and G2 of one curve family on one device: the fields, the group
    laws, host encoding and the MSMs (curve.py::CurveKernels)."""

    def __init__(self, curve: CurveParams, device="cuda"):
        self.curve = curve
        self.tower = TowerKernels(curve, device)
        self.fp = self.tower.fp
        self.fr = self.tower.fr
        self.device = self.fp.device
        r_bits = curve.fr.p.bit_length()
        self.oracle_g1 = g1_group(curve)
        self.g1 = ProjCurveOps(self.fp, 3 * curve.b, r_bits,
                               name=f"{curve.name}/G1")
        if curve.b2 is None:
            # a fields + tower + G1 family (BLS12-377), as in the JAX package
            self.oracle_g2 = self.g2 = None
        else:
            self.oracle_g2 = g2_group(curve)
            p = curve.fp.p
            b3 = (3 * curve.b2[0] % p, 3 * curve.b2[1] % p)
            self.g2 = ProjCurveOps(self.tower.fp2, b3, r_bits,
                                   name=f"{curve.name}/G2")
        self._msm = {}

    def msm(self, grp: str = "g1"):
        """The Pippenger MSM of "g1" or "g2" (built once, then cached)."""
        if grp not in ("g1", "g2"):
            raise ValueError(f"no group {grp!r}: use 'g1' or 'g2'")
        if grp not in self._msm:
            from .msm import CurveMSM

            ops = self.g1 if grp == "g1" else self.g2
            if ops is None:
                raise UnsupportedError(
                    f"{self.curve.name} has no G2 support (fields + tower "
                    "+ G1 only)")
            self._msm[grp] = CurveMSM(ops, self.fr)
        return self._msm[grp]

    @staticmethod
    def _encode(enc, zero, pts, device) -> AffBatch:
        xs = [zero if p is None else p[0] for p in pts]
        ys = [zero if p is None else p[1] for p in pts]
        inf = torch.from_numpy(np.array([p is None for p in pts], dtype=bool))
        return (enc(xs), enc(ys), inf.to(device))

    @staticmethod
    def _decode(dec, A: AffBatch):
        xs, ys = dec(A[0]), dec(A[1])
        infs = A[2].detach().cpu().numpy()
        if infs.ndim == 0:
            return None if bool(infs) else (xs, ys)
        return [None if bool(i) else (x, y)
                for x, y, i in zip(xs, ys, infs.reshape(-1))]

    def encode_g1(self, pts: Sequence[Optional[Tuple[int, int]]]) -> AffBatch:
        return self._encode(self.fp.encode, 0, pts, self.device)

    def decode_g1(self, A: AffBatch):
        return self._decode(self.fp.decode, A)

    def encode_g2(self, pts: Sequence) -> AffBatch:
        """Oracle G2 points ((x0, x1), (y0, y1)) or None -> (x, y, inf)
        with x, y (W, 2, N) Montgomery limbs."""
        return self._encode(self.tower.encode_fp2, (0, 0), pts, self.device)

    def decode_g2(self, A: AffBatch):
        return self._decode(self.tower.decode_fp2, A)
