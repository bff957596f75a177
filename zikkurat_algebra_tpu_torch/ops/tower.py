"""The extension-field tower Fp2 / Fp6 / Fp12 on limb planes.

The torch counterpart of zikkurat_algebra_tpu/ops/tower.py.  The limb
axis stays first and the extension components follow it, outermost
extension first, as the JAX package lays them out:

    Fp   : (W, *batch)
    Fp2  : (W, 2, *batch)              u^2 = qnr (-1 for BN128, BLS12-381)
    Fp6  : (W, 3, 2, *batch)           v^3 = xi
    Fp12 : (W, 2, 3, 2, *batch)        w^2 = v

Sums, differences, negation and selection are the prime field's on the
whole tensor, componentwise.  A product at any level stacks the pair on
a batch axis, forms the Karatsuba operands with one stacked sum, and
hands ONE stacked product of 3 (quadratic) or 6 (cubic) base pairs down
a level; so every product of Fp2, Fp6 or Fp12 elements, and every
`mul_list` of them, is one K1 launch at the bottom (54 base products per
Fp12 element).  The products by xi and by v are additions only
(`Field.times`), so they launch nothing.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from ..oracle.groups import tower as oracle_tower
from ..params import CurveParams
from . import limbs as lb
from .field import Field, int_to_bits, resolve_device

Fp2Value = Union[int, Tuple[int, int]]


class _Ext:
    """What every extension level shares: the componentwise ops, the
    constants, selection, predicates and exponentiation.  `base` is the
    level below, `fp` the prime field at the bottom."""

    deg: int

    def __init__(self, base):
        self.base = base
        self.fp: Field = getattr(base, "fp", base)
        self.struct_ndim = base.struct_ndim + 1
        self.p = self.fp.p
        self.W = self.fp.W
        self.device = self.fp.device

    def plain(self):
        """This level over the plain view of the prime field: every
        product runs the plain version, on any device."""
        g = copy.copy(self)
        g.base = self.base.plain()
        g.fp = getattr(g.base, "fp", g.base)
        return g

    def _bs(self, a) -> tuple:
        return tuple(a.shape[self.struct_ndim:])

    # -- constants -----------------------------------------------------------
    def zero(self, batch_shape=()) -> torch.Tensor:
        return torch.zeros((self.W,) + self.elem_shape + tuple(batch_shape),
                           dtype=torch.int32, device=self.device)

    def one(self, batch_shape=()) -> torch.Tensor:
        return self.from_base(self.base.one(batch_shape))

    @property
    def elem_shape(self) -> tuple:
        """The component axes after the limb axis."""
        return (self.deg,) + tuple(getattr(self.base, "elem_shape", ()))

    def from_base(self, a) -> torch.Tensor:
        """A base-level element as this level's: the other components 0."""
        z = torch.zeros_like(a)
        return torch.stack([a] + [z] * (self.deg - 1), 1)

    # -- componentwise -------------------------------------------------------
    def add(self, a, b):
        return self.fp.add(a, b)

    def sub(self, a, b):
        return self.fp.sub(a, b)

    def neg(self, a):
        return self.fp.neg(a)

    def add_list(self, pairs):
        return self.fp.add_list(pairs)

    def sub_list(self, pairs):
        return self.fp.sub_list(pairs)

    def scale_small(self, a, k: int):
        """k a for a small int k: one product by the constant."""
        return self.fp.scale_small(a, k)

    def times(self, a, k: int):
        """k a for a small int k by additions alone."""
        return self.fp.times(a, k)

    def scale_base(self, k, a):
        """a times the base-level element k: every component by k in one
        base-level product (one launch)."""
        sb = self.base.struct_ndim
        return self.base.mul(k.unsqueeze(sb), a.movedim(1, sb)).movedim(sb, 1)

    def is_zero(self, a) -> torch.Tensor:
        return (a == 0).flatten(0, self.struct_ndim - 1).all(0)

    def eq(self, a, b) -> torch.Tensor:
        return (a == b).flatten(0, self.struct_ndim - 1).all(0)

    def select(self, pred, a, b):
        return torch.where(pred.reshape((1,) * self.struct_ndim + pred.shape),
                           a, b)

    # -- products ------------------------------------------------------------
    def _pair(self, a, b) -> torch.Tensor:
        """a and b broadcast and stacked on a new axis after this level's
        component axes: (W, deg, ..., 2, *batch)."""
        shape = torch.broadcast_shapes(a.shape, b.shape)
        return torch.stack([a.expand(shape), b.expand(shape)],
                           self.struct_ndim)

    def mul_list(self, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> List[torch.Tensor]:
        """K independent products as ONE product of a K-fold batch."""
        if len(pairs) == 1:
            return [self.mul(*pairs[0])]
        sn = self.struct_ndim
        shape = torch.broadcast_shapes(*[x.shape for pr in pairs for x in pr])
        A = torch.stack([a.expand(shape) for a, _ in pairs], sn)
        B = torch.stack([b.expand(shape) for _, b in pairs], sn)
        return list(self.mul(A, B).unbind(sn))

    def sqr(self, a):
        return self.mul(a, a)

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    # -- exponentiation --------------------------------------------------------
    def pow_bits(self, a, bits):
        """a^e for e given by its little-endian bits on the host, MSB-first
        square-and-multiply (tower.py:54): the bits choose the launches."""
        bits = np.asarray(bits).reshape(-1)
        nz = np.flatnonzero(bits)
        if nz.size == 0:
            return self.one(self._bs(a)).contiguous()
        acc = a
        for i in range(int(nz[-1]) - 1, -1, -1):
            acc = self.sqr(acc)
            if bits[i]:
                acc = self.mul(acc, a)
        return acc

    def pow_static(self, a, e: int):
        """a^e for a host int e; a negative e inverts first."""
        if e < 0:
            return self.pow_static(self.inv(a), -e)
        return self.pow_bits(a, int_to_bits(e))


class QuadExt(_Ext):
    """base[u] / (u^2 - nr).  Over the prime field (Fp2), nr is the small
    int `qnr`; over Fp6 (Fp12), nr = v and `mul_nr` is `CubicExt.mul_by_v`
    (tower.py:153-193)."""

    deg = 2

    def __init__(self, base, qnr: int = None, mul_nr=None):
        super().__init__(base)
        self.qnr = qnr
        self.mul_nr = self.mul_u2 if mul_nr is None else mul_nr

    def mul_u2(self, a):
        """a * qnr for a base element: a negation for qnr = -1, else one
        product by the small constant."""
        f = self.base
        return f.neg(a) if self.qnr == -1 else f.scale_small(a, self.qnr)

    def const(self, value: Fp2Value, batch_shape=()) -> torch.Tensor:
        """Montgomery form of an int or a pair (c0, c1), broadcast to
        (W, 2, *batch_shape) (Fp2 only)."""
        c0, c1 = (value, 0) if isinstance(value, int) else value
        f = self.base
        c = torch.stack([f.const(c0), f.const(c1)], 1)
        return c.view(c.shape + (1,) * len(batch_shape)).expand(
            c.shape + tuple(batch_shape))

    def conj(self, a):
        return torch.stack([a[:, 0], self.base.neg(a[:, 1])], 1)

    def mul(self, a, b):
        """Karatsuba (a0 + a1 u)(b0 + b1 u): t0 = a0 b0, t1 = a1 b1,
        t2 = (a0 + a1)(b0 + b1) as ONE base product of a 3-fold batch;
        c0 = t0 + nr t1, c1 = t2 - t0 - t1."""
        fp, sb = self.fp, self.base.struct_ndim
        ab = self._pair(a, b)                        # (W, 2, .., 2, *batch)
        a0b0, a1b1 = ab[:, 0], ab[:, 1]
        T = torch.stack([a0b0, a1b1, fp.add(a0b0, a1b1)], sb)
        t0, t1, t2 = self.base.mul(T.select(sb + 1, 0),
                                   T.select(sb + 1, 1)).unbind(sb)
        if self.qnr is not None:
            # (c0, c1) = (t0, t2) - (-qnr t1, t0 + t1): one stacked sub
            m = t1 if self.qnr == -1 else fp.scale_small(t1, -self.qnr)
            return fp.sub(torch.stack([t0, t2], 1),
                          torch.stack([m, fp.add(t0, t1)], 1))
        u = fp.add(torch.stack([t0, t0], 1),
                   torch.stack([self.mul_nr(t1), t1], 1))
        return torch.stack([u[:, 0], fp.sub(t2, u[:, 1])], 1)

    # -- inversion -----------------------------------------------------------
    def _norm(self, a):
        """N(a) = a0^2 - nr a1^2 in the base level."""
        f = self.base
        s0, s1 = f.mul_list([(a[:, 0], a[:, 0]), (a[:, 1], a[:, 1])])
        return f.sub(s0, self.mul_nr(s1))

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
        zeros map to zero (Fp2)."""
        return self._scale_conj(a, self.base.batch_inv(self._norm(a)))

    def __repr__(self):
        return f"QuadExt({self.base!r}, qnr={self.qnr})"


class CubicExt(_Ext):
    """base[v] / (v^3 - xi) over Fp2, xi applied by `mul_xi` with
    additions only (tower.py:196-248)."""

    deg = 3

    def __init__(self, base, mul_xi):
        super().__init__(base)
        self.mul_xi = mul_xi

    def mul(self, a, b):
        """Karatsuba over three coefficients: m_i = a_i b_i and
        s_ij = (a_i + a_j)(b_i + b_j) as ONE base product of a 6-fold
        batch; c0 = m0 + xi (s12 - m1 - m2), c1 = s01 - m0 - m1 + xi m2,
        c2 = s02 - m0 - m2 + m1."""
        fp, sb = self.fp, self.base.struct_ndim
        ab = self._pair(a, b)                        # (W, 3, .., 2, *batch)
        c = [ab[:, i] for i in range(3)]
        s = fp.add(torch.stack([c[1], c[0], c[0]], sb),
                   torch.stack([c[2], c[1], c[2]], sb))
        T = torch.cat([torch.stack(c, sb), s], sb)   # (W, .., 6, 2, *batch)
        m0, m1, m2, s12, s01, s02 = self.base.mul(
            T.select(sb + 1, 0), T.select(sb + 1, 1)).unbind(sb)
        e = fp.sub(fp.sub(torch.stack([s12, s01, s02], 1),
                          torch.stack([m1, m0, m0], 1)),
                   torch.stack([m2, m1, m2], 1))
        x = self.mul_xi(torch.stack([e[:, 0], m2], sb))
        return fp.add(torch.stack([m0, e[:, 1], e[:, 2]], 1),
                      torch.stack([x.select(sb, 0), x.select(sb, 1), m1], 1))

    def mul_by_v(self, a):
        """(a0, a1, a2) -> (xi a2, a0, a1): additions only."""
        return torch.stack([self.mul_xi(a[:, 2]), a[:, 0], a[:, 1]], 1)

    def inv(self, a):
        """The closed form through the norm to Fp2 (tower.py:229-248):
        three product launches and one Fp2 inversion."""
        f = self.base
        a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
        p0, p1, p2, q12, q01, q02 = f.mul_list([
            (a0, a0), (a1, a1), (a2, a2), (a1, a2), (a0, a1), (a0, a2)])
        xq12, xp2 = self.mul_xi(torch.stack([q12, p2], 2)).unbind(2)
        t0, t1, t2 = f.sub_list([(p0, xq12), (xp2, q01), (p1, q02)])
        u0, u1, u2 = f.mul_list([(a0, t0), (a2, t1), (a1, t2)])
        d = f.add(u0, self.mul_xi(f.add(u1, u2)))
        dinv = f.inv(d)
        return torch.stack(f.mul_list([(t0, dinv), (t1, dinv), (t2, dinv)]),
                           1)


class TowerKernels:
    """The tower of one curve family: Fp, Fr, Fp2, Fp6 and Fp12, the
    product by xi, the Frobenius maps with their gamma tables, the Fp2
    square root and the host encoding (tower.py:251-440)."""

    def __init__(self, curve: CurveParams, device="cuda"):
        self.curve = curve
        self.oracle = oracle_tower(curve)
        self.fp = Field(curve.fp, device)
        self.fr = Field(curve.fr, device)
        self.device = self.fp.device
        self.qnr = curve.tower.qnr
        self.fp2 = QuadExt(self.fp, qnr=self.qnr)
        self.mul_u2 = self.fp2.mul_u2
        self.xi = (curve.tower.xi0, curve.tower.xi1)
        self.fp6 = CubicExt(self.fp2, self.mul_xi)
        self.fp12 = QuadExt(self.fp6, mul_nr=self.fp6.mul_by_v)
        self._qnr_inv = self.fp.encode(pow(self.qnr, -1, curve.fp.p))
        # gamma_i = xi^(i (p-1)/6), i = 0..5, as the Fp2 factors of the
        # Frobenius maps laid out like the coefficients they scale: Fp12
        # coefficient [j, k] (w-slot j, v-slot k) holds w^(j + 2k)
        g = [self.encode_fp2_const(c) for c in self.oracle.fp12._gammas()]
        self._gamma12 = torch.stack([torch.stack([g[j + 2 * k]
                                                  for k in range(3)], 1)
                                     for j in range(2)], 1)   # (W, 2, 3, 2)
        self._gamma6 = torch.stack([g[0], g[2], g[4]], 1)      # (W, 3, 2)

    def mul_xi(self, a):
        """a (xi0 + xi1 u) for Fp2 elements a (W, 2, *batch):
        (xi0 a0 + qnr xi1 a1) + (xi1 a0 + xi0 a1) u by additions alone
        (tower.py:281-292; xi = 9 + u, 1 + u or u)."""
        fp, (xi0, xi1) = self.fp, self.xi
        x = fp.times(a, xi0)
        y = x if xi1 == xi0 else fp.times(a, xi1)
        if self.qnr == -1:
            c0 = fp.sub(x[:, 0], y[:, 1])
        else:
            c0 = fp.add(x[:, 0], fp.times(y[:, 1], self.qnr))
        return torch.stack([c0, fp.add(x[:, 1], y[:, 0])], 1)

    # -- Frobenius -------------------------------------------------------------
    def _conj_scale(self, a, gamma):
        """Every Fp2 coefficient of a conjugated and multiplied by the
        matching entry of `gamma`, in one Fp2 product (one K1 launch)."""
        sn = gamma.ndim                       # a's component axes + 1
        conj = torch.stack([a.select(sn - 1, 0),
                            self.fp.neg(a.select(sn - 1, 1))], sn - 1)
        x = conj.movedim(sn - 1, 1)           # (W, 2, .., *batch) as Fp2
        g = gamma.movedim(sn - 1, 1)
        g = g.reshape(g.shape + (1,) * (x.ndim - g.ndim))
        return self.fp2.mul(x, g).movedim(1, sn - 1)

    def fp2_frobenius(self, a):
        """x -> x^p over Fp2: the conjugation."""
        return self.fp2.conj(a)

    def fp6_frobenius(self, a):
        """x -> x^p over Fp6: each Fp2 coefficient conjugated, that of v^i
        multiplied by gamma_{2i} (tower.py:341-360)."""
        return self._conj_scale(a, self._gamma6)

    def fp12_frobenius(self, a, k: int = 1):
        """x -> x^(p^k) over Fp12, k applications of `_frob1`."""
        for _ in range(k % 12):
            a = self._frob1(a)
        return a

    def _frob1(self, a):
        """x -> x^p: the coefficient of w^i conjugated and multiplied by
        gamma_i, all six in one product (tower.py:404-419)."""
        return self._conj_scale(a, self._gamma12)

    def fp12_conj(self, a):
        """x^(p^6): the Fp6 conjugation."""
        return torch.stack([a[:, 0], self.fp6.neg(a[:, 1])], 1)

    # -- square root -------------------------------------------------------------
    def fp2_sqrt(self, a):
        """(root, is_square) for Fp2 elements (W, 2, *batch), branch-free
        (tower.py:305-335).  With s = sqrt(N(a)), the root is
        t + a1 / (2 t) u for t = sqrt((a0 + s) / 2), or sqrt((a0 - s) / 2)
        where that is no square; for a1 = 0 it is sqrt(a0) or
        sqrt(a0 / qnr) u.  The four base roots after the first are
        independent and go through ONE batched `Field.sqrt`.  is_square is
        root^2 == a, so a non-square reports False."""
        f = self.fp
        a0, a1 = a[:, 0], a[:, 1]
        s, _ = f.sqrt(self.fp2._norm(a))
        halves = f.div2(torch.stack([f.add(a0, s), f.sub(a0, s)], 1))
        qi = lb.bcast(self._qnr_inv, a0.ndim).expand(a0.shape)
        roots, oks = f.sqrt(torch.cat(
            [halves, torch.stack([a0, f.mul(a0, qi)], 1)], 1))
        t1, t2, r0, rn = roots.unbind(1)
        ok1, _, okr0, _ = oks.unbind(0)
        t = f.select(ok1, t1, t2)
        # t = 0 (a = 0 or a non-square): inv(0) = 0, and the check rejects
        x1 = f.mul(a1, f.inv(f.add(t, t)))
        z1 = f.is_zero(a1)
        zero = torch.zeros_like(a0)
        c0 = f.select(z1, f.select(okr0, r0, zero), t)
        c1 = f.select(z1, f.select(okr0, zero, rn), x1)
        root = torch.stack([c0, c1], 1)
        return root, self.fp2.eq(self.fp2.sqr(root), a)

    # -- host encode / decode ------------------------------------------------------
    def encode_fp2_const(self, c: Tuple[int, int]) -> torch.Tensor:
        """One Fp2 value -> (W, 2) Montgomery limbs."""
        return torch.stack([self.fp.encode(c[0]), self.fp.encode(c[1])], 1)

    def encode_fp2(self, cs: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Fp2 values -> (W, 2, N) Montgomery limbs."""
        c0 = self.fp.encode([c[0] for c in cs])
        c1 = self.fp.encode([c[1] for c in cs])
        return torch.stack([c0, c1], 1)

    def encode_fp6(self, cs: Sequence) -> torch.Tensor:
        """Oracle Fp6 values -> (W, 3, 2, N)."""
        return torch.stack([self.encode_fp2([c[i] for c in cs])
                            for i in range(3)], 1)

    def encode_fp12(self, cs: Sequence) -> torch.Tensor:
        """Oracle Fp12 values -> (W, 2, 3, 2, N)."""
        return torch.stack([self.encode_fp6([c[i] for c in cs])
                            for i in range(2)], 1)

    def _decode(self, a, level_shape):
        """Limbs of a tower level -> nested tuples of ints: one value for
        an element without batch axes, else a list in C order of the batch."""
        vals = self.fp.decode(a.reshape(self.fp.W, -1))
        k = len(level_shape)
        arr = np.empty(len(vals), dtype=object)
        arr[:] = vals
        arr = arr.reshape(tuple(a.shape[1:]))
        arr = np.moveaxis(arr, list(range(k)), list(range(-k, 0)))
        flat = arr.reshape((-1,) + tuple(level_shape))

        def nest(x):
            return tuple(nest(y) for y in x) if isinstance(x, np.ndarray) \
                else int(x)

        out = [nest(x) for x in flat]
        return out[0] if a.ndim == k + 1 else out

    def decode_fp2(self, a):
        """(W, 2) -> (c0, c1); (W, 2, *batch) -> a list of pairs."""
        return self._decode(a, (2,))

    def decode_fp6(self, a):
        return self._decode(a, (3, 2))

    def decode_fp12(self, a):
        return self._decode(a, (2, 3, 2))


_TOWER_CACHE: Dict[Tuple[CurveParams, torch.device], TowerKernels] = {}


def get_tower(curve: CurveParams, device="cuda") -> TowerKernels:
    """The `TowerKernels` of `curve` on `device`, built once
    (tower.py:434)."""
    key = (curve, resolve_device(device))
    if key not in _TOWER_CACHE:
        _TOWER_CACHE[key] = TowerKernels(curve, key[1])
    return _TOWER_CACHE[key]
