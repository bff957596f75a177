"""The extension-field tower Fp2 / Fp6 / Fp12 on Python ints.

    Fp2  = Fp [u] / (u^2 - qnr)      qnr = -1 (BN128, BLS12-381), -5 (BLS12-377)
    Fp6  = Fp2[v] / (v^3 - xi)       xi = 9 + u (BN128), 1 + u (BLS12-381)
    Fp12 = Fp6[w] / (w^2 - v)

Elements are nested tuples: Fp2 = (c0, c1) = c0 + c1 u with both
coefficients in [0, p), Fp6 = (Fp2, Fp2, Fp2), Fp12 = (Fp6, Fp6).  The
slow, obviously right reference for the port's tower (ops/tower.py), for
G2 (the oracle `CurveGroup` works over Fp2 as over Fp) and for the
pairing (oracle/pairing.py).
"""

from __future__ import annotations

from ..params import CurveParams
from .field import Fp


class Fp2Field:
    def __init__(self, base: Fp, qnr: int = -1, xi=None):
        self.fp = base
        self.p = base.p
        self.qnr = qnr % base.p                 # u^2 = qnr (a non-residue)
        # the Fp6 nonresidue xi = xi0 + xi1 u, where the field has a tower
        self.xi = None if xi is None else (xi[0] % base.p, xi[1] % base.p)
        self.zero = (0, 0)
        self.one = (1, 0)

    def _norm(self, a):
        """N(a) = a0^2 - qnr a1^2 (= a0^2 + a1^2 for u^2 = -1)."""
        return (a[0] * a[0] - self.qnr * a[1] * a[1]) % self.p

    def from_base(self, a: int):
        return (a % self.p, 0)

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

    def scale_fp(self, k: int, a):
        p = self.p
        return (k * a[0] % p, k * a[1] % p)

    def mul_xi(self, a):
        """The product by the Fp6 nonresidue xi."""
        return self.mul(a, self.xi)

    def conj(self, a):
        return (a[0], self.fp.neg(a[1]))

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

    def pow(self, a, e: int):
        return _generic_pow(self, a, e)

    def frobenius(self, a):
        """x -> x^p: conjugation, for any quadratic non-residue qnr, since
        u^p = u qnr^((p-1)/2) = -u."""
        return self.conj(a)

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

    def rnd(self, rng):
        """Uniform from `rng` (a random.Random)."""
        return (rng.randrange(self.p), rng.randrange(self.p))

    def coeffs(self, a):
        return [a[0], a[1]]


class Fp6Field:
    def __init__(self, fp2: Fp2Field):
        self.fp2 = fp2
        self.p = fp2.p
        self.zero = (fp2.zero,) * 3
        self.one = (fp2.one, fp2.zero, fp2.zero)

    def from_base(self, a):
        """An Fp2 element as an Fp6 element."""
        return (a, self.fp2.zero, self.fp2.zero)

    def add(self, a, b):
        f = self.fp2
        return tuple(f.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        f = self.fp2
        return tuple(f.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        f = self.fp2
        return tuple(f.neg(x) for x in a)

    def mul(self, a, b):
        """Schoolbook, then v^3 = xi."""
        f = self.fp2
        t = [f.zero] * 5
        for i in range(3):
            for j in range(3):
                t[i + j] = f.add(t[i + j], f.mul(a[i], b[j]))
        return (f.add(t[0], f.mul_xi(t[3])), f.add(t[1], f.mul_xi(t[4])),
                t[2])

    def sqr(self, a):
        return self.mul(a, a)

    def mul_by_v(self, a):
        """The product by v: (a0, a1, a2) -> (xi a2, a0, a1)."""
        return (self.fp2.mul_xi(a[2]), a[0], a[1])

    def frobenius(self, a):
        """x -> x^p: v^p = xi^((p-1)/3) v, so the coefficient of v^i is
        conjugated and multiplied by xi^(i (p-1)/3)."""
        f = self.fp2
        g2 = f.pow(f.xi, (self.p - 1) // 3)
        g4 = f.sqr(g2)
        return (f.conj(a[0]), f.mul(f.conj(a[1]), g2),
                f.mul(f.conj(a[2]), g4))

    def inv(self, a):
        """The closed form through the norm to Fp2."""
        f = self.fp2
        a0, a1, a2 = a
        t0 = f.sub(f.sqr(a0), f.mul_xi(f.mul(a1, a2)))
        t1 = f.sub(f.mul_xi(f.sqr(a2)), f.mul(a0, a1))
        t2 = f.sub(f.sqr(a1), f.mul(a0, a2))
        d = f.add(f.mul(a0, t0), f.mul_xi(f.add(f.mul(a2, t1), f.mul(a1, t2))))
        dinv = f.inv(d)
        return (f.mul(t0, dinv), f.mul(t1, dinv), f.mul(t2, dinv))

    def eq(self, a, b):
        return a == b

    def is_zero(self, a):
        return all(self.fp2.is_zero(x) for x in a)

    def pow(self, a, e: int):
        return _generic_pow(self, a, e)

    def rnd(self, rng):
        return tuple(self.fp2.rnd(rng) for _ in range(3))

    def coeffs(self, a):
        out = []
        for x in a:
            out += self.fp2.coeffs(x)
        return out


class Fp12Field:
    def __init__(self, fp6: Fp6Field):
        self.fp6 = fp6
        self.fp2 = fp6.fp2
        self.p = fp6.p
        self.zero = (fp6.zero, fp6.zero)
        self.one = (fp6.one, fp6.zero)

    def from_base(self, a):
        """An Fp6 element as an Fp12 element."""
        return (a, self.fp6.zero)

    def add(self, a, b):
        f = self.fp6
        return (f.add(a[0], b[0]), f.add(a[1], b[1]))

    def sub(self, a, b):
        f = self.fp6
        return (f.sub(a[0], b[0]), f.sub(a[1], b[1]))

    def neg(self, a):
        f = self.fp6
        return (f.neg(a[0]), f.neg(a[1]))

    def mul(self, a, b):
        """Karatsuba over Fp6 with w^2 = v."""
        f = self.fp6
        t0 = f.mul(a[0], b[0])
        t1 = f.mul(a[1], b[1])
        t2 = f.mul(f.add(a[0], a[1]), f.add(b[0], b[1]))
        return (f.add(t0, f.mul_by_v(t1)), f.sub(f.sub(t2, t0), t1))

    def sqr(self, a):
        return self.mul(a, a)

    def conj(self, a):
        """x^(p^6): the inverse on the cyclotomic subgroup."""
        return (a[0], self.fp6.neg(a[1]))

    def inv(self, a):
        """(a0 - a1 w) / (a0^2 - v a1^2)."""
        f = self.fp6
        d = f.sub(f.sqr(a[0]), f.mul_by_v(f.sqr(a[1])))
        dinv = f.inv(d)
        return (f.mul(a[0], dinv), f.neg(f.mul(a[1], dinv)))

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    def eq(self, a, b):
        return a == b

    def is_zero(self, a):
        return self.fp6.is_zero(a[0]) and self.fp6.is_zero(a[1])

    def pow(self, a, e: int):
        return _generic_pow(self, a, e)

    def frobenius(self, a):
        """x -> x^p through the gamma table."""
        return self._frob1(a)

    def rnd(self, rng):
        return (self.fp6.rnd(rng), self.fp6.rnd(rng))

    def coeffs(self, a):
        return self.fp6.coeffs(a[0]) + self.fp6.coeffs(a[1])

    # -- Frobenius -----------------------------------------------------------
    def _gammas(self):
        """gamma_i = xi^(i (p-1)/6), i = 0..5."""
        if not hasattr(self, "_gamma_cache"):
            f2 = self.fp2
            g1 = f2.pow(f2.xi, (self.p - 1) // 6)
            gs = [f2.one, g1]
            for _ in range(4):
                gs.append(f2.mul(gs[-1], g1))
            self._gamma_cache = gs
        return self._gamma_cache

    def _frob1(self, a):
        """x -> x^p: with x = sum_i c_i w^i (c_i in Fp2, v = w^2),
        frob(x) = sum_i conj(c_i) gamma_i w^i."""
        f2 = self.fp2
        cs = fp12_to_w_coeffs(a)
        return w_coeffs_to_fp12([f2.mul(f2.conj(c), g)
                                 for c, g in zip(cs, self._gammas())])

    def frobenius_k(self, a, k: int):
        for _ in range(k % 12):
            a = self._frob1(a)
        return a


def fp12_to_w_coeffs(a):
    """((A0, A1, A2), (B0, B1, B2)) -> the Fp2 coefficients of w^0 .. w^5:
    x = A0 + B0 w + A1 w^2 + B1 w^3 + A2 w^4 + B2 w^5."""
    (a0, a1, a2), (b0, b1, b2) = a
    return [a0, b0, a1, b1, a2, b2]


def w_coeffs_to_fp12(cs):
    return ((cs[0], cs[2], cs[4]), (cs[1], cs[3], cs[5]))


def _generic_pow(field, a, e: int):
    if e < 0:
        a, e = field.inv(a), -e
    acc = field.one
    while e:
        if e & 1:
            acc = field.mul(acc, a)
        a = field.sqr(a)
        e >>= 1
    return acc


class Tower:
    """The full tower of one curve family."""

    def __init__(self, curve: CurveParams):
        self.curve = curve
        self.fp = Fp(curve.fp)
        self.fr = Fp(curve.fr)
        self.fp2 = Fp2Field(self.fp, curve.tower.qnr,
                            (curve.tower.xi0, curve.tower.xi1))
        self.fp6 = Fp6Field(self.fp2)
        self.fp12 = Fp12Field(self.fp6)
