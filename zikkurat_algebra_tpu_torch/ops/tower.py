"""The quadratic extension Fp2 on limb planes, and what G2 needs of the tower.

The torch counterpart of the Fp2 parts of zikkurat_algebra_tpu/ops/tower.py
(QuadExt, TowerKernels).  An Fp2 element c0 + c1 u is a (W, 2, *batch)
int32 tensor: the limb axis first, the component axis right after it, as
the JAX package lays out (L, 2, *batch).  Sums, differences, negation and
selection are the base field's, componentwise.  `mul_list` expands every
product into three base products (Karatsuba) and stacks all of them into
ONE base-field product, so a batch of Fp2 products is one K1 launch.
"""

from __future__ import annotations

import copy
from typing import List, Sequence, Tuple, Union

import torch

from ..params import CurveParams
from .field import Field

Fp2Value = Union[int, Tuple[int, int]]


class QuadExt:
    """base[u] / (u^2 - qnr) over the prime field `base`."""

    struct_ndim = 2

    def __init__(self, base: Field, qnr: int):
        self.base = base
        self.qnr = qnr
        self.p = base.p
        self.W = base.W
        self.device = base.device

    def plain(self) -> "QuadExt":
        """This extension over the base field's plain view."""
        g = copy.copy(self)
        g.base = self.base.plain()
        return g

    def mul_u2(self, a):
        """a * qnr for a base element: a negation for qnr = -1, else one
        product by the small constant."""
        f = self.base
        return f.neg(a) if self.qnr == -1 else f.scale_small(a, self.qnr)

    # -- constants ---------------------------------------------------------
    def const(self, value: Fp2Value, batch_shape=()) -> torch.Tensor:
        """Montgomery form of an int or a pair (c0, c1), broadcast to
        (W, 2, *batch_shape)."""
        c0, c1 = (value, 0) if isinstance(value, int) else value
        f = self.base
        c = torch.stack([f.const(c0), f.const(c1)], 1)
        return c.view(c.shape + (1,) * len(batch_shape)).expand(
            c.shape + tuple(batch_shape))

    def zero(self, batch_shape=()) -> torch.Tensor:
        return torch.zeros((self.W, 2) + tuple(batch_shape),
                           dtype=torch.int32, device=self.device)

    def one(self, batch_shape=()) -> torch.Tensor:
        f = self.base
        return torch.stack([f.one(batch_shape), f.zero(batch_shape)], 1)

    # -- componentwise ops ------------------------------------------------------
    def add(self, a, b):
        return self.base.add(a, b)

    def sub(self, a, b):
        return self.base.sub(a, b)

    def neg(self, a):
        return self.base.neg(a)

    def add_list(self, pairs):
        return self.base.add_list(pairs)

    def sub_list(self, pairs):
        return self.base.sub_list(pairs)

    def scale_small(self, a, k: int):
        return self.base.scale_small(a, k)

    def conj(self, a):
        return torch.stack([a[:, 0], self.base.neg(a[:, 1])], 1)

    def is_zero(self, a) -> torch.Tensor:
        return (a == 0).all(0).all(0)

    def eq(self, a, b) -> torch.Tensor:
        return (a == b).all(0).all(0)

    def select(self, pred, a, b):
        return torch.where(pred[None, None], a, b)

    # -- products ----------------------------------------------------------
    def mul_list(self, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> List[torch.Tensor]:
        """Karatsuba (a0 + a1 u)(b0 + b1 u): t0 = a0 b0, t1 = a1 b1,
        t2 = (a0 + a1)(b0 + b1); c0 = t0 + qnr t1, c1 = t2 - t0 - t1
        (tower.py:165-179).  The K pairs are stacked on one batch axis, so
        all 3K base products are one product (one K1 launch), and
        (c0, c1) = (t0, t2) - (-qnr t1, t0 + t1) is one stacked
        subtraction."""
        f = self.base
        shape = torch.broadcast_shapes(*[x.shape for pr in pairs for x in pr])
        A = torch.stack([a.expand(shape) for a, _ in pairs], 2)
        B = torch.stack([b.expand(shape) for _, b in pairs], 2)
        ab = torch.stack([A, B], 2)                   # (W, 2, 2, K, *batch)
        s = f.add(ab[:, 0], ab[:, 1])                 # a0 + a1, b0 + b1
        t0, t1, t2 = f.mul(torch.stack([A[:, 0], A[:, 1], s[:, 0]], 1),
                           torch.stack([B[:, 0], B[:, 1], s[:, 1]], 1)
                           ).unbind(1)
        m = t1 if self.qnr == -1 else f.scale_small(t1, -self.qnr)
        c = f.sub(torch.stack([t0, t2], 1),
                  torch.stack([m, f.add(t0, t1)], 1))
        return list(c.unbind(2))

    def mul(self, a, b):
        return self.mul_list([(a, b)])[0]

    def sqr(self, a):
        return self.mul_list([(a, a)])[0]

    # -- inversion -----------------------------------------------------------
    def _norm(self, a):
        """N(a) = a0^2 - qnr a1^2 in the base field."""
        f = self.base
        s0, s1 = f.mul_list([(a[:, 0], a[:, 0]), (a[:, 1], a[:, 1])])
        return f.sub(s0, self.mul_u2(s1))

    def _scale_conj(self, a, ninv):
        """(a0 - a1 u) * ninv for a base element ninv."""
        f = self.base
        q0, q1 = f.mul_list([(a[:, 0], ninv), (a[:, 1], ninv)])
        return torch.stack([q0, f.neg(q1)], 1)

    def inv(self, a):
        """(a0 - a1 u) / N(a); inv(0) = 0."""
        return self._scale_conj(a, self.base.inv(self._norm(a)))

    def batch_inv(self, a):
        """The norms go down to Fp and through ONE `Field.batch_inv`;
        zeros map to zero."""
        return self._scale_conj(a, self.base.batch_inv(self._norm(a)))

    def __repr__(self):
        return f"QuadExt({self.base!r}, qnr={self.qnr})"


class TowerKernels:
    """What G2 needs of one curve's tower: Fp, Fr, Fp2 and the host
    encoding of Fp2 values (tower.py:259-277, 362-375).  Fp6, Fp12 and
    the Frobenius maps come with the pairing."""

    def __init__(self, curve: CurveParams, device="cuda"):
        self.curve = curve
        self.fp = Field(curve.fp, device)
        self.fr = Field(curve.fr, device)
        self.device = self.fp.device
        self.qnr = curve.tower.qnr
        self.fp2 = QuadExt(self.fp, self.qnr)
        self.mul_u2 = self.fp2.mul_u2

    def encode_fp2_const(self, c: Tuple[int, int]) -> torch.Tensor:
        """One Fp2 value -> (W, 2) Montgomery limbs."""
        return torch.stack([self.fp.encode(c[0]), self.fp.encode(c[1])], 1)

    def encode_fp2(self, cs: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Fp2 values -> (W, 2, N) Montgomery limbs."""
        c0 = self.fp.encode([c[0] for c in cs])
        c1 = self.fp.encode([c[1] for c in cs])
        return torch.stack([c0, c1], 1)

    def decode_fp2(self, a):
        """(W, 2) -> (c0, c1); (W, 2, *batch) -> a list of pairs."""
        c0 = self.fp.decode(a[:, 0])
        c1 = self.fp.decode(a[:, 1])
        if isinstance(c0, int):
            return (c0, c1)
        return list(zip(c0, c1))
