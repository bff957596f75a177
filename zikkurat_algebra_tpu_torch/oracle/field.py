"""Prime-field arithmetic on Python ints in [0, p): the slow, obviously
right reference the port is checked against."""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..params import FieldParams


class Fp:
    """GF(p) acting on plain ints in [0, p)."""

    def __init__(self, params: FieldParams):
        self.params = params
        self.p = params.p

    def add(self, a: int, b: int) -> int:
        c = a + b
        return c - self.p if c >= self.p else c

    def sub(self, a: int, b: int) -> int:
        c = a - b
        return c + self.p if c < 0 else c

    def neg(self, a: int) -> int:
        return (self.p - a) if a else 0

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def sqr(self, a: int) -> int:
        return (a * a) % self.p

    def scale_int(self, k: int, a: int) -> int:
        return (k * a) % self.p

    def eq(self, a: int, b: int) -> bool:
        return a == b

    def is_zero(self, a: int) -> bool:
        return a == 0

    def inv(self, a: int) -> int:
        """inv(0) == 0, the convention of the field kernels."""
        if a == 0:
            return 0
        return pow(a, -1, self.p)

    def div(self, a: int, b: int) -> int:
        return self.mul(a, self.inv(b))

    def div_by_2(self, a: int) -> int:
        """a / 2: a >> 1 for even a, (a + p) >> 1 for odd a."""
        return a >> 1 if a % 2 == 0 else (a + self.p) >> 1

    def pow(self, a: int, e: int) -> int:
        if e < 0:
            return pow(self.inv(a), -e, self.p)
        return pow(a, e, self.p)

    def is_square(self, a: int) -> bool:
        return a == 0 or pow(a, (self.p - 1) // 2, self.p) == 1

    def sqrt(self, a: int) -> Optional[int]:
        """A square root of a, or None for a non-residue: a^((p+1)/4) for
        p = 3 mod 4, else textbook Tonelli-Shanks."""
        p = self.p
        if a == 0:
            return 0
        if not self.is_square(a):
            return None
        if p % 4 == 3:
            return pow(a, (p + 1) // 4, p)
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, tt = 0, t
            while tt != 1:
                tt = tt * tt % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t, r = t * c % p, r * b % p
        return r


def batch_inv(field: Fp, xs: Sequence[int]) -> List[int]:
    """Inverses by the batch trick (one inversion); zeros map to zero."""
    n = len(xs)
    prefix = [0] * n
    acc = 1
    for i, x in enumerate(xs):
        prefix[i] = acc
        if x != 0:
            acc = acc * x % field.p
    inv_acc = field.inv(acc)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        if xs[i] != 0:
            out[i] = inv_acc * prefix[i] % field.p
            inv_acc = inv_acc * xs[i] % field.p
    return out


def jacobi(n: int, k: int) -> int:
    """The Jacobi symbol (n | k) in {-1, 0, 1} for odd positive k, by the
    binary algorithm and quadratic reciprocity."""
    if k <= 0 or k % 2 == 0:
        raise ValueError("jacobi (n|k): k must be odd and positive")
    n %= k
    t = 1
    while n:
        while n % 2 == 0:
            n //= 2
            if k % 8 in (3, 5):
                t = -t
        n, k = k, n
        if n % 4 == 3 and k % 4 == 3:
            t = -t
        n %= k
    return t if k == 1 else 0
