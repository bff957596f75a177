"""Affine short-Weierstrass group law on Python ints, generic over the
coordinate field: Fp (`oracle.field.Fp`, ints) for G1 and Fp2
(`oracle.ext.Fp2Field`, pairs of ints) for G2.

Points at infinity are `None`.  Branchy and slow: this is the reference
that the batched projective formulas and the MSM are checked against.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

AffinePoint = Optional[Tuple]      # (x, y) over the coordinate field


class CurveGroup:
    """y^2 = x^3 + a x + b over `field`, scalar field order `r`; a and b
    are elements of `field`."""

    def __init__(self, field, a, b, r: int, gen: AffinePoint,
                 cofactor: int = 1):
        self.f = field
        self.a = a
        self.b = b
        self.r = r
        self.gen = gen
        self.cofactor = cofactor

    def is_on_curve(self, pt: AffinePoint) -> bool:
        if pt is None:
            return True
        f = self.f
        x, y = pt
        rhs = f.add(f.add(f.mul(f.mul(x, x), x), f.mul(self.a, x)), self.b)
        return f.eq(f.mul(y, y), rhs)

    def is_in_subgroup(self, pt: AffinePoint) -> bool:
        """On the curve and r pt = infinity (r not reduced mod r)."""
        return (self.is_on_curve(pt)
                and self.scalar_mul_unreduced(self.r, pt) is None)

    def neg(self, pt: AffinePoint) -> AffinePoint:
        if pt is None:
            return None
        return (pt[0], self.f.neg(pt[1]))

    def dbl(self, pt: AffinePoint) -> AffinePoint:
        if pt is None:
            return None
        f = self.f
        x, y = pt
        if f.is_zero(y):
            return None
        # lambda = (3x^2 + a) / 2y
        xx = f.mul(x, x)
        num = f.add(f.add(f.add(xx, xx), xx), self.a)
        lam = f.div(num, f.add(y, y))
        x3 = f.sub(f.mul(lam, lam), f.add(x, x))
        y3 = f.sub(f.mul(lam, f.sub(x, x3)), y)
        return (x3, y3)

    def add(self, p: AffinePoint, q: AffinePoint) -> AffinePoint:
        if p is None:
            return q
        if q is None:
            return p
        f = self.f
        x1, y1 = p
        x2, y2 = q
        if f.eq(x1, x2):
            if f.eq(y1, y2):
                return self.dbl(p)
            return None
        lam = f.div(f.sub(y2, y1), f.sub(x2, x1))
        x3 = f.sub(f.sub(f.mul(lam, lam), x1), x2)
        y3 = f.sub(f.mul(lam, f.sub(x1, x3)), y1)
        return (x3, y3)

    def sub(self, p: AffinePoint, q: AffinePoint) -> AffinePoint:
        return self.add(p, self.neg(q))

    def scalar_mul(self, k: int, pt: AffinePoint) -> AffinePoint:
        """[k mod r] pt: right for points of the r-subgroup only."""
        return self.scalar_mul_unreduced(k % self.r if self.r else k, pt)

    def scalar_mul_unreduced(self, k: int, pt: AffinePoint) -> AffinePoint:
        """[k] pt for any curve point, k not reduced mod r (cofactor
        multiples, subgroup checks)."""
        if k < 0:
            k, pt = -k, self.neg(pt)
        acc = None
        while k:
            if k & 1:
                acc = self.add(acc, pt)
            pt = self.dbl(pt)
            k >>= 1
        return acc

    def msm(self, coeffs: Sequence[int],
            points: Sequence[AffinePoint]) -> AffinePoint:
        """sum_i k_i P_i by one scalar multiplication per term."""
        if len(coeffs) != len(points):
            raise ValueError(f"{len(coeffs)} scalars vs {len(points)} points")
        acc = None
        for k, pt in zip(coeffs, points):
            acc = self.add(acc, self.scalar_mul(k, pt))
        return acc

    def rnd(self, rng) -> AffinePoint:
        """[k] gen for k uniform in [1, r) from `rng` (a random.Random)."""
        return self.scalar_mul(rng.randrange(1, self.r), self.gen)

    # -- group FFT -------------------------------------------------------------
    def fft(self, gen: int, points: Sequence[AffinePoint],
            inverse: bool = False):
        """out[k] = sum_j [gen^(j k)] P_j over a domain of size n = 2^m of
        the scalar field (gen of order n); the inverse uses gen^-1 and
        multiplies by 1/n."""
        n = len(points)
        if n & (n - 1):
            raise ValueError(f"group FFT of length {n}: not a power of two")
        if inverse:
            gen = pow(gen, -1, self.r)
        out = self._fft_rec(gen, list(points))
        if inverse:
            ninv = pow(n, -1, self.r)
            out = [self.scalar_mul(ninv, pt) for pt in out]
        return out

    def _fft_rec(self, gen: int, xs):
        n = len(xs)
        if n == 1:
            return xs
        evens = self._fft_rec(gen * gen % self.r, xs[0::2])
        odds = self._fft_rec(gen * gen % self.r, xs[1::2])
        out = [None] * n
        tw = 1
        for k in range(n // 2):
            t = self.scalar_mul(tw, odds[k])
            out[k] = self.add(evens[k], t)
            out[k + n // 2] = self.sub(evens[k], t)
            tw = tw * gen % self.r
        return out
