"""The quadratic extension Fp2 = Fp[u] / (u^2 - qnr) on Python ints.

Elements are pairs (c0, c1) = c0 + c1 u with both coefficients in
[0, p).  The slow, obviously right reference for the port's `QuadExt`
and for G2 (the oracle `CurveGroup` works over this field as over Fp).
"""

from __future__ import annotations

from .field import Fp


class Fp2Field:
    def __init__(self, base: Fp, qnr: int = -1):
        self.fp = base
        self.p = base.p
        self.qnr = qnr % base.p                 # u^2 = qnr (a non-residue)
        self.zero = (0, 0)
        self.one = (1, 0)

    def _norm(self, a):
        """N(a) = a0^2 - qnr a1^2 (= a0^2 + a1^2 for u^2 = -1)."""
        return (a[0] * a[0] - self.qnr * a[1] * a[1]) % self.p

    def from_ints(self, c0: int, c1: int):
        return (c0 % self.p, c1 % self.p)

    def add(self, a, b):
        f = self.fp
        return (f.add(a[0], b[0]), f.add(a[1], b[1]))

    def sub(self, a, b):
        f = self.fp
        return (f.sub(a[0], b[0]), f.sub(a[1], b[1]))

    def neg(self, a):
        f = self.fp
        return (f.neg(a[0]), f.neg(a[1]))

    def mul(self, a, b):
        # u^2 = qnr:  (a0 b0 + qnr a1 b1, a0 b1 + a1 b0)
        p = self.p
        return ((a[0] * b[0] + self.qnr * a[1] * b[1]) % p,
                (a[0] * b[1] + a[1] * b[0]) % p)

    def sqr(self, a):
        p = self.p
        return ((a[0] * a[0] + self.qnr * a[1] * a[1]) % p,
                (2 * a[0] * a[1]) % p)

    def inv(self, a):
        """(a0 - a1 u) / N(a); inv(0) == 0 as in the base field."""
        p = self.p
        ninv = self.fp.inv(self._norm(a))
        return (a[0] * ninv % p, (p - a[1]) * ninv % p if a[1] else 0)

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    def eq(self, a, b):
        return a == b

    def is_zero(self, a):
        return a == (0, 0)

    def sqrt(self, a):
        """A square root of a by the norm: with n = sqrt(N(a)), the root is
        x0 + x1 u with x0^2 = (a0 +- n) / 2 and x1 = a1 / (2 x0), or
        x1 u with qnr x1^2 = a0 when a1 = 0; None for a non-square."""
        if self.is_zero(a):
            return self.zero
        f = self.fp
        n = f.sqrt(self._norm(a))
        if n is None:
            return None
        for nn in (n, f.neg(n)):
            x0 = f.sqrt(f.div_by_2(f.add(a[0], nn)))
            if x0 is None:
                continue
            if x0 == 0:
                x1 = f.sqrt(f.div(a[0], self.qnr)) if a[1] == 0 else None
                if x1 is not None:
                    return (0, x1)
                continue
            x1 = f.div(a[1], f.add(x0, x0))
            if self.sqr((x0, x1)) == a:
                return (x0, x1)
        return None
