"""Dense univariate polynomials over a prime field, on Python ints: the
reference of the port's `PolyOps` and of the KZG oracle.  Horner
evaluation, long division and the division by x^n - eta follow the
reference C's bn128_poly_mont.c (`eval_at`, `long_div`,
`div_by_vanishing`, `quot_by_vanishing`)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


class Poly:
    """Coefficient list, little-endian (coeffs[i] is the x^i coefficient)."""

    def __init__(self, p: int, coeffs: Sequence[int]):
        self.p = p
        self.coeffs = [c % p for c in coeffs]
        while self.coeffs and self.coeffs[-1] == 0:
            self.coeffs.pop()

    # -- basic ---------------------------------------------------------------
    def degree(self) -> int:
        return len(self.coeffs) - 1  # degree of 0 is -1, as in the reference

    def is_zero(self) -> bool:
        return not self.coeffs

    def __eq__(self, other) -> bool:
        return self.p == other.p and self.coeffs == other.coeffs

    def coeff(self, i: int) -> int:
        return self.coeffs[i] if 0 <= i < len(self.coeffs) else 0

    # -- ring ops -------------------------------------------------------------
    def neg(self) -> "Poly":
        return Poly(self.p, [-c for c in self.coeffs])

    def add(self, other: "Poly") -> "Poly":
        n = max(len(self.coeffs), len(other.coeffs))
        return Poly(self.p, [self.coeff(i) + other.coeff(i) for i in range(n)])

    def sub(self, other: "Poly") -> "Poly":
        n = max(len(self.coeffs), len(other.coeffs))
        return Poly(self.p, [self.coeff(i) - other.coeff(i) for i in range(n)])

    def scale(self, k: int) -> "Poly":
        return Poly(self.p, [k * c for c in self.coeffs])

    def mul(self, other: "Poly") -> "Poly":
        if self.is_zero() or other.is_zero():
            return Poly(self.p, [])
        out = [0] * (len(self.coeffs) + len(other.coeffs) - 1)
        for i, a in enumerate(self.coeffs):
            for j, b in enumerate(other.coeffs):
                out[i + j] += a * b
        return Poly(self.p, out)

    def mul_by_xn(self, n: int) -> "Poly":
        return Poly(self.p, [0] * n + self.coeffs)

    # -- evaluation ------------------------------------------------------------
    def eval_at(self, x: int) -> int:
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * x + c) % self.p
        return acc

    # -- division ---------------------------------------------------------------
    def long_div(self, other: "Poly") -> Tuple["Poly", "Poly"]:
        assert not other.is_zero(), "division by zero polynomial"
        p = self.p
        rem = list(self.coeffs)
        d = other.degree()
        lead_inv = pow(other.coeffs[-1], -1, p)
        quot = [0] * max(0, len(rem) - d)
        for i in range(len(rem) - 1, d - 1, -1):
            q = rem[i] * lead_inv % p
            quot[i - d] = q
            if q:
                for j, b in enumerate(other.coeffs):
                    rem[i - d + j] = (rem[i - d + j] - q * b) % p
        return Poly(p, quot), Poly(p, rem[:d])

    def div_by_vanishing(self, n: int, eta: int) -> Tuple["Poly", "Poly"]:
        """Divide by (x^n - eta); returns (quotient, remainder)."""
        p = self.p
        rem = list(self.coeffs)
        quot = [0] * max(0, len(rem) - n)
        for i in range(len(rem) - 1, n - 1, -1):
            q = rem[i]
            quot[i - n] = (quot[i - n] + q) % p
            rem[i] = 0
            rem[i - n] = (rem[i - n] + q * eta) % p
        return Poly(p, quot), Poly(p, rem[:n])

    def quot_by_vanishing(self, n: int, eta: int) -> Optional["Poly"]:
        """Quotient by (x^n - eta) if the division is exact, else None."""
        q, r = self.div_by_vanishing(n, eta)
        return q if r.is_zero() else None
