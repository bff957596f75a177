"""Prime-field arithmetic on Python ints in [0, p): the slow, obviously
right reference the port is checked against."""

from __future__ import annotations

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
