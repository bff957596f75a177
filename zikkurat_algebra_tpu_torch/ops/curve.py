"""G1 and G2 group laws on limb planes: the complete projective formulas.

The torch counterpart of zikkurat_algebra_tpu/ops/curve.py (ProjCurveOps,
CurveKernels).  `add`, `dbl` and `madd` are RCB15 algorithms 7, 9 and 8
for a = 0 (Renes-Costello-Batina 2015), in the same operation order as
the JAX package, so both give the same X, Y, Z as field values.  The
coordinate field is `Field` (G1, elements (W, *batch)) or `QuadExt`
(G2, elements (W, 2, *batch)); the code only reads its `struct_ndim`.
Independent products go through `mul_list` (one K1 launch) and
independent sums through `add_list` / `sub_list`.  On CUDA tensors of G1
`add` and `dbl` are instead one launch each of `csrc/point_ops.cu`
(`kernel_point`), which gives the same limbs (`_fused` says where).
`scalar_mul_digits` is the windowed scalar multiplication the group FFT
(ops/gfft.py) uses; `scalar_mul_static` the one for a scalar known on
the host (subgroup checks, cofactor clearing).

Subgroup membership: on the curve suffices for a cofactor of 1 (BN128
G1); with a GLV endomorphism phi(x, y) = (beta x, y) it is on the curve
and phi(P) = [lambda] P, a scalar of half the width of r (Scott, "A note
on group membership tests for G1, G2 and GT", ePrint 2021/1130; BLS12
G1); otherwise on the curve and [r] P = infinity (G2).  Compressed
points (`CurveKernels.compress_g1` / `_g2`) are the canonical Montgomery
limbs of x and int32 flags: bit 0 the parity of y in standard form (of
its c0, or of c1 where c0 = 0, over Fp2), bit 1 infinity (x = 0 there).
`g1_to_bytes48` / `g1_from_bytes48` are the ZCash 48-byte encoding of
BLS12-381 G1 (the commitments and proofs of EIP-4844).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..errors import UnsupportedError
from ..oracle.groups import g1_group, g2_group
from ..params import CurveParams
from ..utils import profiling as prof
from . import kernel_point, limbs as lb
from .field import resolve_device
from .tower import get_tower

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
        self._order: Optional[int] = None
        self._cofactor: Optional[int] = None
        self._glv: Optional[Tuple[torch.Tensor, int]] = None

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
        g = copy.copy(self)
        g.f = self.f.plain()
        return g

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

    def eq(self, P: Point, Q: Point) -> torch.Tensor:
        """Equal as points (curve.py:71): X1 Z2 = X2 Z1 and Y1 Z2 = Y2 Z1
        for finite points; infinity equals only infinity."""
        f = self.f
        xz1, xz2, yz1, yz2 = f.mul_list(
            [(P[0], Q[2]), (Q[0], P[2]), (P[1], Q[2]), (Q[1], P[2])])
        pi, qi = self.is_inf(P), self.is_inf(Q)
        same = f.eq(xz1, xz2) & f.eq(yz1, yz2)
        return (pi & qi) | (~pi & ~qi & same)

    def neg(self, P: Point) -> Point:
        return (P[0], self.f.neg(P[1]), P[2])

    def sub(self, P: Point, Q: Point) -> Point:
        return self.add(P, self.neg(Q))

    def _fused(self, device: torch.device) -> bool:
        """Whether a point op on coordinates on `device` is one launch of
        `csrc/point_ops.cu`: G1 (Fp) coordinates on a CUDA device, at a
        width the kernel takes, over the kernel field.  G2, CPU tensors
        and `plain()` (its products on the plain version) run the torch
        law."""
        f = self.f
        return (device.type == "cuda" and f.struct_ndim == 1
                and f.W in kernel_point.WIDTHS
                and f.on_kernel)

    def add(self, P: Point, Q: Point) -> Point:
        """Complete projective addition, RCB15 algorithm 7 (a = 0): one
        `kernel_point.point_add` launch where `_fused` holds, else the
        torch law below."""
        if self._fused(P[0].device):
            return kernel_point.point_add(self, P, Q)
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
        """Complete projective doubling, RCB15 algorithm 9 (a = 0): one
        `kernel_point.point_dbl` launch where `_fused` holds, else the
        torch law below."""
        if self._fused(P[0].device):
            return kernel_point.point_dbl(self, P)
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

    # -- scalar multiplication ---------------------------------------------------
    WINDOW = 4      # bits per digit of scalar_mul_digits: a 16-entry table

    def stack(self, Ps, axis: int) -> Point:
        """Points of equal shape stacked on a new batch axis."""
        return tuple(torch.stack([q[i] for q in Ps], axis) for i in range(3))

    def _window_table(self, P: Point) -> Point:
        """[0] P .. [15] P as ONE point batch with a table axis after the
        coordinate field's axes (curve.py:220-250), built in three levels
        of one batched doubling and one batched addition each."""
        sn = self.f.struct_ndim
        tab = {0: self.infinity(self._bs(P[0])), 1: P}
        k = 1
        while 2 * k < 1 << self.WINDOW:
            # 2t = dbl(t) and 2t + 1 = 2t + P for t in [k, 2k)
            ev = self.dbl(self.stack([tab[t] for t in range(k, 2 * k)], sn))
            od = self.add(ev, self.stack([P] * k, sn))
            for j in range(k):
                tab[2 * (k + j)] = tuple(c.select(sn, j) for c in ev)
                tab[2 * (k + j) + 1] = tuple(c.select(sn, j) for c in od)
            k *= 2
        return self.stack([tab[t] for t in range(1 << self.WINDOW)], sn)

    def scalar_mul_digits(self, digits: torch.Tensor, P: Point) -> Point:
        """[k] P for scalars k given as MSB-first 4-bit digit planes
        (S, *batch), any integer type (curve.py:265-281): the accumulator
        starts at the first digit's table entry, then per digit 4
        doublings and one addition of the entry, looked up with a gather
        on the table axis."""
        sn = self.f.struct_ndim
        bs = self._bs(P[0])
        table = self._window_table(P)

        def entry(d):
            idx = d.expand(bs).reshape((1,) * (sn + 1) + tuple(bs))
            return tuple(c.gather(sn, idx.expand(c.shape[:sn] + (1,) + bs))
                         .squeeze(sn) for c in table)

        digits = digits.to(torch.int64)
        acc = entry(digits[0])
        for d in digits[1:]:
            for _ in range(self.WINDOW):
                acc = self.dbl(acc)
            acc = self.add(acc, entry(d))
        return acc

    def scalar_mul_bits(self, bits: torch.Tensor, P: Point) -> Point:
        """[k] P for scalars k given per element as little-endian bit
        planes (B, *batch) on the device (curve.py:202): double-and-add
        with the addition kept by a select, so no bit is read back."""
        acc = self.infinity(self._bs(P[0]))
        base = P
        for i in range(bits.shape[0]):
            acc = self.select(bits[i] == 1, self.add(acc, base), acc)
            if i + 1 < bits.shape[0]:
                base = self.dbl(base)
        return acc

    def scalar_mul_static(self, k: int, P: Point) -> Point:
        """[k] P for one host int k shared by the batch (curve.py:283):
        the 16-entry window table, then per 4-bit digit of k four
        doublings and one addition of the digit's entry, indexed on the
        host; a zero digit adds nothing.  k is not reduced mod r."""
        if k == 0:
            return self.infinity(self._bs(P[0]))
        if k < 0:
            return self.neg(self.scalar_mul_static(-k, P))
        sn = self.f.struct_ndim
        table = self._window_table(P)
        digits = int_to_digits_msb(k, self.WINDOW)
        acc = tuple(c.select(sn, digits[0]) for c in table)
        for d in digits[1:]:
            for _ in range(self.WINDOW):
                acc = self.dbl(acc)
            if d:
                acc = self.add(acc, tuple(c.select(sn, d) for c in table))
        return acc

    def scalar_mul_fr_std(self, k_limbs: torch.Tensor, P: Point) -> Point:
        """[k] P for canonical standard-rep scalar limbs (Wr, *batch)
        (curve.py:351), windowed."""
        return self.scalar_mul_digits(limbs_to_digits_msb(k_limbs), P)

    # -- subgroup ------------------------------------------------------------
    def set_subgroup_params(self, order: int, cofactor: int):
        self._order = order
        self._cofactor = cofactor
        self._glv = None

    def set_glv(self, beta_mont: torch.Tensor, lam: int):
        """Use phi(X : Y : Z) = (beta X : Y : Z) with eigenvalue lam on the
        r-subgroup; beta is a (W,) Montgomery device constant."""
        self._glv = (beta_mont, lam)

    def endo(self, P: Point) -> Point:
        """phi(P): one product."""
        beta, _ = self._glv
        return (self.f.mul(P[0], lb.bcast(beta, P[0].ndim)), P[1], P[2])

    def _subgroup(self) -> int:
        if self._order is None:
            raise ValueError(f"{self.name}: no subgroup parameters set")
        return self._order

    def is_in_subgroup(self, P: Point) -> torch.Tensor:
        """Subgroup membership (curve.py:319): on the curve, and for a
        cofactor above 1 phi(P) = [lambda] P where a GLV endomorphism is
        set, else [r] P = infinity."""
        r = self._subgroup()
        on = self.is_on_curve(P)
        if self._cofactor == 1:
            return on
        if self._glv is not None:
            lam_p = self.scalar_mul_static(self._glv[1], P)
            return on & self.eq(self.endo(P), lam_p)
        return on & self.is_inf(self.scalar_mul_static(r, P))

    def is_in_subgroup_slow(self, P: Point) -> torch.Tensor:
        """On the curve and [r] P = infinity: the definition, the referee
        of the fast paths."""
        r = self._subgroup()
        return self.is_on_curve(P) & self.is_inf(self.scalar_mul_static(r, P))

    def clear_cofactor(self, P: Point) -> Point:
        """[h] P for the cofactor h: a curve point into the subgroup."""
        self._subgroup()
        return self.scalar_mul_static(self._cofactor, P)

    def select(self, pred, P: Point, Q: Point) -> Point:
        s = self.f.select
        return (s(pred, P[0], Q[0]), s(pred, P[1], Q[1]), s(pred, P[2], Q[2]))

    def to_affine(self, P: Point) -> AffBatch:
        """(X/Z, Y/Z, inf) through one batched inversion."""
        f = self.f
        with prof.span("curve.to_affine", P[2]):
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


def limbs_to_bits(a: torch.Tensor) -> torch.Tensor:
    """(W, *batch) canonical limbs -> (32 W, *batch) int32 bit planes,
    least significant first (curve.py:364, which gives 15 L bits)."""
    sh = torch.arange(lb.LIMB_BITS, device=a.device).view(
        (1, lb.LIMB_BITS) + (1,) * (a.ndim - 1))
    bits = (lb.to64(a).unsqueeze(1) >> sh) & 1
    return bits.reshape((a.shape[0] * lb.LIMB_BITS,) + a.shape[1:]).to(
        torch.int32)


def limbs_to_digits_msb(a: torch.Tensor, w: int = 4) -> torch.Tensor:
    """(W, *batch) canonical limbs -> (ceil(32 W / w), *batch) int32 w-bit
    digit planes, most significant first (curve.py:375; the count of
    leading zero digits differs from the JAX package's, the value not)."""
    bits = limbs_to_bits(a)
    pad = (-bits.shape[0]) % w
    if pad:
        bits = torch.cat([bits, bits.new_zeros((pad,) + bits.shape[1:])], 0)
    bits = bits.reshape((bits.shape[0] // w, w) + bits.shape[1:])
    weights = (1 << torch.arange(w, device=a.device, dtype=torch.int32)
               ).view((1, w) + (1,) * (bits.ndim - 2))
    return (bits * weights).sum(1, dtype=torch.int32).flip(0)


def int_to_digits_msb(k: int, w: int = 4):
    """A nonnegative int -> its w-bit digits, most significant first (at
    least one digit)."""
    if k < 0:
        raise ValueError("negative scalar")
    digits = []
    while k:
        digits.append(k & ((1 << w) - 1))
        k >>= w
    return digits[::-1] or [0]


class CurveKernels:
    """G1 and G2 of one curve family on one device: the fields, the group
    laws with their subgroup tests, host encoding, point compression and
    the MSMs (curve.py::CurveKernels)."""

    def __init__(self, curve: CurveParams, device="cuda"):
        self.curve = curve
        self.tower = get_tower(curve, device)
        self.fp = self.tower.fp
        self.fr = self.tower.fr
        self.device = self.fp.device
        r = curve.fr.p
        r_bits = r.bit_length()
        self.oracle_g1 = g1_group(curve)
        self.g1 = ProjCurveOps(self.fp, 3 * curve.b, r_bits,
                               name=f"{curve.name}/G1")
        self.g1.set_subgroup_params(r, curve.cofactor)
        if curve.glv_beta_lambda is not None and curve.cofactor != 1:
            self.g1.set_glv(*self._glv_pair(curve))
        self._b1 = self.fp.encode(curve.b)
        if curve.b2 is None:
            # a fields + tower + G1 family (BLS12-377), as in the JAX package
            self.oracle_g2 = self.g2 = None
        else:
            self.oracle_g2 = g2_group(curve)
            p = curve.fp.p
            b3 = (3 * curve.b2[0] % p, 3 * curve.b2[1] % p)
            self.g2 = ProjCurveOps(self.tower.fp2, b3, r_bits,
                                   name=f"{curve.name}/G2")
            self.g2.set_subgroup_params(r, curve.g2_cofactor)
            self._b2 = self.tower.encode_fp2_const(curve.b2)
        self._msm = {}

    def _glv_pair(self, curve: CurveParams):
        """(beta as a device constant, its eigenvalue): lambda or lambda^2
        mod r, whichever maps the oracle generator G to (beta x, y)
        (curve.py:420-444); neither raises."""
        beta, lam = curve.glv_beta_lambda
        gen = self.oracle_g1.gen
        phi_g = (beta * gen[0] % curve.fp.p, gen[1])
        for cand in (lam, lam * lam % curve.fr.p):
            if self.oracle_g1.scalar_mul(cand, gen) == phi_g:
                return self.fp.encode(beta), cand
        raise ValueError(f"{curve.name}: GLV beta does not match lambda or "
                         "lambda^2 on the generator")

    def _group(self, grp: str):
        """(group law, oracle group, encoder) of "g1" or "g2"."""
        if grp not in ("g1", "g2"):
            raise ValueError(f"no group {grp!r}: use 'g1' or 'g2'")
        if grp == "g1":
            return self.g1, self.oracle_g1, self.encode_g1
        if self.g2 is None:
            raise UnsupportedError(
                f"{self.curve.name} has no G2 support (fields + tower + G1 "
                "only)")
        return self.g2, self.oracle_g2, self.encode_g2

    def generator(self, n: int, grp: str = "g1") -> Point:
        """n copies of the generator of "g1" or "g2" as projective points
        (coordinates (W, n) or (W, 2, n))."""
        ops, og, enc = self._group(grp)
        return tuple(c.expand(c.shape[:-1] + (n,)).contiguous()
                     for c in ops.from_affine(enc([og.gen])))

    def rnd_point(self, gen: torch.Generator, batch_shape=(),
                  grp: str = "g1") -> Point:
        """Random subgroup points [k] G for k drawn by `Field.rnd` of Fr
        from `gen` (curve.py:460), as projective points of batch_shape."""
        ops = self._group(grp)[0]
        n = int(np.prod(batch_shape)) if batch_shape else 1
        k = self.fr.from_mont(self.fr.rnd(gen, (n,)))
        P = ops.scalar_mul_fr_std(k, self.generator(n, grp))
        return tuple(c.reshape(c.shape[:-1] + tuple(batch_shape)) for c in P)

    def msm(self, grp: str = "g1"):
        """The Pippenger MSM of "g1" or "g2" (built once, then cached)."""
        ops = self._group(grp)[0]
        if grp not in self._msm:
            from .msm import CurveMSM

            self._msm[grp] = CurveMSM(ops, self.fr)
        return self._msm[grp]

    # -- compressed points (curve.py:496-555) -----------------------------------
    @staticmethod
    def _parity(f, y) -> torch.Tensor:
        """Parity of the standard-rep value of y, int32."""
        return (f.from_mont(y)[0] & 1).to(torch.int32)

    def _parity_fp2(self, y) -> torch.Tensor:
        """The Fp2 sign: parity of c0, or of c1 where c0 = 0, so that
        negation flips it for every y != 0 (one product for both)."""
        par = self._parity(self.fp, y)
        return torch.where(self.fp.is_zero(y[:, 0]), par[1], par[0])

    @staticmethod
    def _flags(par, inf) -> torch.Tensor:
        return par | (inf.to(torch.int32) << 1)

    def compress_g1(self, A: AffBatch):
        """Affine G1 batch -> (x limbs, 0 at infinity; int32 flags)."""
        x, y, inf = A
        return (self.fp.select(inf, torch.zeros_like(x), x),
                self._flags(self._parity(self.fp, y), inf))

    def decompress_g1(self, x: torch.Tensor, flags: torch.Tensor):
        """Inverse of `compress_g1`: y = +-sqrt(x^3 + b), the sign chosen
        by the parity flag.  Returns (affine batch, valid), valid False
        where x^3 + b is no square (no point has that x)."""
        f = self.fp
        par, inf = flags & 1, (flags & 2) == 2
        rhs = f.add(f.mul(f.sqr(x), x), lb.bcast(self._b1, x.ndim))
        root, ok = f.sqrt(rhs)
        y = f.select(self._parity(f, root) == par, root, f.neg(root))
        return (x, y, inf), ok | inf

    def compress_g2(self, A: AffBatch):
        """Affine G2 batch -> (x, (W, 2, *batch), 0 at infinity; flags)."""
        x, y, inf = A
        return (self.tower.fp2.select(inf, torch.zeros_like(x), x),
                self._flags(self._parity_fp2(y), inf))

    def decompress_g2(self, x: torch.Tensor, flags: torch.Tensor):
        """Inverse of `compress_g2` through `TowerKernels.fp2_sqrt`."""
        f2 = self.tower.fp2
        par, inf = flags & 1, (flags & 2) == 2
        b = self._b2.view(self._b2.shape + (1,) * (x.ndim - 2))
        root, ok = self.tower.fp2_sqrt(f2.add(f2.mul(f2.sqr(x), x),
                                              b.expand(x.shape)))
        y = f2.select(self._parity_fp2(root) == par, root, f2.neg(root))
        return (x, y, inf), ok | inf

    # -- the ZCash 48-byte encoding of G1 (EIP-4844's commitments, proofs) ------
    G1_BYTES = 48

    def _half_p(self) -> int:
        """(p + 1) / 2: y is the larger of y and p - y iff y >= it.  Raises
        where p leaves the encoding no three flag bits."""
        p = self.curve.fp.p
        if 8 * self.G1_BYTES - p.bit_length() < 3:
            raise UnsupportedError(f"{self.curve.name}: no 48-byte encoding")
        return (p + 1) // 2

    def g1_to_bytes48(self, A: AffBatch) -> torch.Tensor:
        """Affine G1 batch -> (*batch, 48) uint8, the ZCash compressed
        encoding: x big-endian (0 at infinity), and in the first byte the
        flags 0x80 (compressed), 0x40 (infinity) and 0x20 (y is the larger
        of y and p - y).  One product for both coordinates."""
        x, y, inf = A
        half = self._half_p()
        fp = self.fp
        xs, ys = fp.from_mont(torch.stack([x, y], 1)).unbind(1)
        big = ~lb.below(ys, half) & ~inf
        out = lb.limbs_to_be_bytes(fp.select(inf, torch.zeros_like(xs), xs),
                                   self.G1_BYTES)
        u8 = torch.uint8
        out[..., 0] |= 0x80 | (inf.to(u8) << 6) | (big.to(u8) << 5)
        return out

    def g1_from_bytes48(self, data: torch.Tensor):
        """Inverse of `g1_to_bytes48` (py_ecc's decompress_G1), on the
        device: (*batch, 48) uint8 -> (affine batch, valid).  valid is
        False where the compressed flag is clear, the infinity flag
        disagrees with x = 0, infinity carries the sign flag, x >= p, or
        x^3 + b is no square; such entries decode to infinity.  The
        subgroup is not checked (`g1.is_in_subgroup`)."""
        half = self._half_p()
        fp = self.fp
        data = data.to(self.device)
        top = data[..., 0].to(torch.int32)
        c, b, a = (((top >> s) & 1) == 1 for s in (7, 6, 5))
        body = data.clone()
        body[..., 0] &= 0x1F
        xs = lb.be_bytes_to_limbs(body, fp.W)
        ok = c & (b == fp.is_zero(xs)) & ~(b & a)
        fin = ok & ~b & lb.below(xs, fp.p)
        x = fp.to_mont(fp.select(fin, xs, torch.zeros_like(xs)))
        rhs = fp.add(fp.mul(fp.sqr(x), x), lb.bcast(self._b1, x.ndim))
        root, square = fp.sqrt(rhs)
        big = ~lb.below(fp.from_mont(root), half)
        y = fp.select(big == a, root, fp.neg(root))
        fin = fin & square
        zero = torch.zeros_like(x)
        return ((fp.select(fin, x, zero), fp.select(fin, y, zero), ~fin),
                (ok & b) | fin)

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


_CURVE_CACHE: Dict[Tuple[CurveParams, torch.device], CurveKernels] = {}


def get_curves(curve: CurveParams, device="cuda") -> CurveKernels:
    """The `CurveKernels` of `curve` on `device`, built once
    (curve.py:596)."""
    key = (curve, resolve_device(device))
    if key not in _CURVE_CACHE:
        _CURVE_CACHE[key] = CurveKernels(curve, key[1])
    return _CURVE_CACHE[key]
