"""Fixed-width unsigned big integers on the port's limb planes.

The torch counterpart of zikkurat_algebra_tpu/ops/bigint.py::BigInt: for
a width of `bits` (a multiple of 64, 128 to 768 in the reference), W =
bits / 32 radix-2^32 limbs on the first axis, int32 planes (W, *batch)
as in ops/limbs.py.  Additions and subtractions return the value mod
2^bits and a carry or borrow plane; `mul_ext` and `sqr_ext` the full 2W
limbs, `mul` the low W; `scale_ext` a word below 2^32 times a value in
W + 1 limbs; shifts by a static count drop what leaves the width.

These are plain torch ops on every device: the JAX package's BigInt
reaches no Pallas kernel.  A 32 x 32-bit product fills 64 bits, so
products go through 16-bit digits (`kernel_field._split16`, `_conv`),
whose int64 column sums cannot overflow; the batch is cut into chunks so
that the digit products stay near `SCRATCH_BYTES` of device memory.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch

from . import limbs as lb
from .field import resolve_device
from .kernel_field import M16, _conv, _partial16, _split16

I32 = torch.int32
I64 = torch.int64
SCRATCH_BYTES = 1 << 28     # the int64 scratch of one batch chunk


def _limbs(T: torch.Tensor) -> torch.Tensor:
    """(2K, N) nonnegative int64 columns < 2^40 of radix 2^16 -> (K, N)
    int32 limbs of their value mod 2^(32 K): after `_partial16` each
    column is below 2^16 + 2, so a pair of them makes a 32-bit column
    below 2^33 for `add_carry` (K <= 60; the 96 digit columns of a
    768-bit product are too many for `_norm16`'s carry resolution)."""
    T = _partial16(T)
    return lb.to32(lb.add_carry(T[0::2] + (T[1::2] << 16))[0])


class BigInt:
    """Unsigned integers of `bits` bits as (W, *batch) int32 limb planes
    on one device."""

    def __init__(self, bits: int, device="cuda"):
        if bits % 64 or bits <= 0:
            raise ValueError(f"width must be a positive multiple of 64 bits, "
                             f"not {bits}")
        self.bits = bits
        self.W = bits // 32
        self.device = resolve_device(device)

    # -- host conversions ------------------------------------------------------
    def encode(self, values: Union[int, Sequence[int]]) -> torch.Tensor:
        """Python int(s) in [0, 2^bits) -> (W,) or (W, N) limbs."""
        return torch.from_numpy(lb.ints_to_limbs(values, self.W).copy()).to(
            self.device)

    def decode(self, limbs) -> Union[int, List[int]]:
        return lb.limbs_to_ints(limbs)

    # -- predicates ----------------------------------------------------------------
    def is_zero(self, a) -> torch.Tensor:
        return (a == 0).all(0)

    def is_one(self, a) -> torch.Tensor:
        return (a[0] == 1) & (a[1:] == 0).all(0)

    def eq(self, a, b) -> torch.Tensor:
        return (a == b).all(0)

    def geq(self, a, b) -> torch.Tensor:
        """a >= b: a - b does not borrow."""
        return self.sub(a, b)[1] == 0

    # -- addition --------------------------------------------------------------------
    def add(self, a, b) -> Tuple[torch.Tensor, torch.Tensor]:
        """((a + b) mod 2^bits, carry out in {0, 1} as int32)."""
        s, c = lb.add_carry(lb.to64(a) + lb.to64(b))
        return lb.to32(s), c.to(I32)

    def sub(self, a, b) -> Tuple[torch.Tensor, torch.Tensor]:
        """((a - b) mod 2^bits, borrow out in {0, 1} as int32)."""
        d, c = lb.sub_borrow(lb.to64(a) - lb.to64(b))
        return lb.to32(d), c.to(I32)

    def neg(self, a) -> torch.Tensor:
        """-a mod 2^bits."""
        return lb.to32(lb.sub_borrow(-lb.to64(a))[0])

    def _unit(self, a) -> torch.Tensor:
        one = torch.zeros_like(a)
        one[0] = 1
        return one

    def inc(self, a) -> Tuple[torch.Tensor, torch.Tensor]:
        """a + 1 with its carry out."""
        return self.add(a, self._unit(a))

    def dec(self, a) -> Tuple[torch.Tensor, torch.Tensor]:
        """a - 1 with its borrow out."""
        return self.sub(a, self._unit(a))

    # -- products ----------------------------------------------------------------------
    @staticmethod
    def _chunks(n: int, cols: int):
        """Batch slices whose int64 scratch of `cols` columns per element
        takes at most SCRATCH_BYTES."""
        step = max(1, SCRATCH_BYTES // (8 * cols))
        return (slice(s, s + step) for s in range(0, n, step))

    def _product(self, a, b, nlimbs: int) -> torch.Tensor:
        """The low nlimbs limbs of a b, nlimbs <= 2W."""
        shape = torch.broadcast_shapes(a.shape, b.shape)
        a = a.expand(shape).reshape(self.W, -1)
        b = b.expand(shape).reshape(self.W, -1)
        out = torch.empty((nlimbs, a.shape[1]), dtype=I32, device=a.device)
        for sl in self._chunks(a.shape[1], (2 * self.W) ** 2):
            cols = _conv(_split16(a[:, sl]), _split16(b[:, sl]), 2 * nlimbs)
            out[:, sl] = _limbs(cols)
        return out.view((nlimbs,) + tuple(shape[1:]))

    def mul_ext(self, a, b) -> torch.Tensor:
        """The full product, 2W limbs."""
        return self._product(a, b, 2 * self.W)

    def sqr_ext(self, a) -> torch.Tensor:
        return self._product(a, a, 2 * self.W)

    def mul(self, a, b) -> torch.Tensor:
        """a b mod 2^bits."""
        return self._product(a, b, self.W)

    def scale_ext(self, w, a) -> torch.Tensor:
        """w a for a word plane w (*batch,) below 2^32, any integer type
        (its low 32 bits are the word), as W + 1 limbs: the 16-bit digits
        of a times the two halves of w, each product below 2^32."""
        x = a.reshape(self.W, -1)
        w = (w.to(I64) & lb.M32).reshape(1, -1).expand(1, x.shape[1])
        out = torch.empty((self.W + 1, x.shape[1]), dtype=I32, device=a.device)
        for sl in self._chunks(x.shape[1], 4 * self.W + 2):
            A = _split16(x[:, sl])                         # (2W, n)
            cols = torch.zeros((2 * self.W + 2, A.shape[1]), dtype=I64,
                               device=a.device)
            cols[:-2] += A * (w[:, sl] & M16)
            cols[1:-1] += A * (w[:, sl] >> 16)
            out[:, sl] = _limbs(cols)
        return out.view((self.W + 1,) + a.shape[1:])

    # -- shifts ----------------------------------------------------------------------------
    def shift_left(self, a, k: int) -> torch.Tensor:
        """a << k mod 2^bits for a static k >= 0."""
        limbs, bits = divmod(k, 32)
        if limbs >= self.W:
            return torch.zeros_like(a)
        x = lb.to64(a)
        x = torch.cat([torch.zeros_like(x[:limbs]), x[:self.W - limbs]], 0)
        if bits:
            lower = torch.cat([torch.zeros_like(x[:1]), x[:-1]], 0)
            x = ((x << bits) & lb.M32) | (lower >> (32 - bits))
        return lb.to32(x)

    def shift_right(self, a, k: int) -> torch.Tensor:
        """a >> k for a static k >= 0."""
        limbs, bits = divmod(k, 32)
        if limbs >= self.W:
            return torch.zeros_like(a)
        x = lb.to64(a)
        x = torch.cat([x[limbs:], torch.zeros_like(x[:limbs])], 0)
        if bits:
            upper = torch.cat([x[1:], torch.zeros_like(x[:1])], 0)
            x = (x >> bits) | ((upper << (32 - bits)) & lb.M32)
        return lb.to32(x)

    def __repr__(self):
        return f"BigInt({self.bits}, {self.device})"


_BIGINT_CACHE: Dict[Tuple[int, torch.device], BigInt] = {}


def bigint(bits: int, device="cuda") -> BigInt:
    """The `BigInt` of `bits` bits on `device`, built once."""
    key = (bits, resolve_device(device))
    if key not in _BIGINT_CACHE:
        _BIGINT_CACHE[key] = BigInt(bits, key[1])
    return _BIGINT_CACHE[key]
