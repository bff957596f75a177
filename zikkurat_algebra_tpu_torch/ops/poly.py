"""Dense univariate polynomials over a prime field on limb planes.

The torch counterpart of zikkurat_algebra_tpu/ops/poly.py::PolyOps.  A
polynomial is a (W, *batch, N) tensor of Montgomery-form coefficients,
coefficient i (of x^i) at index i, zero-padded to the stored length N;
its degree is a value computed from the data, not N.

Products go through kernel K1 (`Field.mul` / `mul_list`), transforms
through the NTT (`ntt.get_domain`, kernel K5).  `mul_naive` forms every
product a_i b_j in one launch and sums the anti-diagonals as int64 column
sums (`Field.reduce_wide`); `div_by_vanishing` is a log-depth suffix
scan of the affine maps t -> B_j + eta t.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Sequence, Tuple

import torch

from ..errors import DimensionError
from . import limbs as lb
from .field import Field, _scan_mul
from .ntt import get_domain
from .vector import dot_prod, powers, scale, sum_mod

NAIVE_MAX = 64              # mul: schoolbook when na + nb <= NAIVE_MAX


@lru_cache(maxsize=None)
def _antidiag(na: int, nb: int, device: str) -> torch.Tensor:
    i = torch.arange(na, device=device)
    j = torch.arange(nb, device=device)
    return (i[:, None] + j[None, :]).reshape(-1)


class PolyOps:
    """Polynomial operations over one field; coefficients in Montgomery
    form."""

    def __init__(self, field: Field):
        self.f = field

    # -- basics ----------------------------------------------------------------
    def degree(self, a: torch.Tensor) -> torch.Tensor:
        """The degree of each polynomial; -1 for the zero polynomial."""
        nz = ~self.f.is_zero(a)                       # (*batch, N)
        idx = torch.arange(a.shape[-1], device=a.device)
        return torch.where(nz, idx, -1).amax(-1)

    def is_zero(self, a) -> torch.Tensor:
        return self.f.is_zero(a).all(-1)

    def eq(self, a, b) -> torch.Tensor:
        """Equality of the polynomials, whatever their stored lengths."""
        n = max(a.shape[-1], b.shape[-1])
        return self.f.eq(self.pad_to(a, n), self.pad_to(b, n)).all(-1)

    def get_coeff(self, a: torch.Tensor, k: int) -> torch.Tensor:
        """Coefficient k; zero beyond the stored length."""
        if k < 0 or k >= a.shape[-1]:
            return self.f.zero(a.shape[1:-1])
        return a[..., k]

    def is_constant(self, a) -> torch.Tensor:
        """True where the degree is at most 0."""
        return self.f.is_zero(a[..., 1:]).all(-1)

    def lincomb(self, coeffs: Sequence[torch.Tensor],
                polys: Sequence[torch.Tensor]) -> torch.Tensor:
        """sum_i coeffs[i] polys[i] for field elements coeffs[i] (W,) and
        polynomials of any stored lengths; all products in one launch."""
        n = max(p.shape[-1] for p in polys)
        prods = self.f.mul_list([
            (c.reshape((self.f.W,) + (1,) * (p.ndim - 1)), self.pad_to(p, n))
            for c, p in zip(coeffs, polys)])
        acc = prods[0]
        for t in prods[1:]:
            acc = self.f.add(acc, t)
        return acc

    def pad_to(self, a: torch.Tensor, n: int) -> torch.Tensor:
        if a.shape[-1] == n:
            return a
        if a.shape[-1] > n:
            raise DimensionError(f"cannot pad length {a.shape[-1]} down to "
                                 f"{n}")
        return torch.nn.functional.pad(a, (0, n - a.shape[-1]))

    # -- ring ops --------------------------------------------------------------
    def neg(self, a):
        return self.f.neg(a)

    def add(self, a, b):
        n = max(a.shape[-1], b.shape[-1])
        return self.f.add(self.pad_to(a, n), self.pad_to(b, n))

    def sub(self, a, b):
        n = max(a.shape[-1], b.shape[-1])
        return self.f.sub(self.pad_to(a, n), self.pad_to(b, n))

    def scale(self, s, a):
        """s a for a field element s, (W,) or (W, 1, ...)."""
        return scale(self.f, s, a)

    def mul_by_xn(self, a, k: int):
        """x^k a."""
        return torch.nn.functional.pad(a, (k, 0))

    # -- multiplication ----------------------------------------------------------
    def mul_naive(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Schoolbook product, length na + nb - 1: every a_i b_j in one
        product launch, the anti-diagonal sums as int64 column sums."""
        f = self.f
        na, nb = a.shape[-1], b.shape[-1]
        prods = f.mul(a.unsqueeze(-1), b.unsqueeze(-2))   # (W, *, na, nb)
        cols = torch.zeros(prods.shape[:-2] + (na + nb - 1,),
                           dtype=torch.int64, device=a.device)
        cols.index_add_(-1, _antidiag(na, nb, str(a.device)),
                        lb.to64(prods).flatten(-2))
        return f.reduce_wide(cols)

    def mul_ntt(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Product through the NTT: both operands in one forward transform,
        one pointwise product, one inverse transform."""
        na, nb = a.shape[-1], b.shape[-1]
        nout = na + nb - 1
        dom = get_domain(self.f, max(1, (nout - 1).bit_length()))
        bs = torch.broadcast_shapes(a.shape[1:-1], b.shape[1:-1])

        def lift(t):            # (W, *batch, n) broadcast to (W, *bs, n)
            t = self.pad_to(t, dom.n)
            lead = (1,) * (len(bs) + 2 - t.ndim)
            return t.reshape(t.shape[:1] + lead + t.shape[1:]).expand(
                t.shape[:1] + bs + (dom.n,))

        fab = dom.ntt(torch.stack([lift(a), lift(b)], 1))
        return dom.intt(self.f.mul(fab[:, 0], fab[:, 1]))[..., :nout]

    def mul(self, a, b):
        if a.shape[-1] + b.shape[-1] <= NAIVE_MAX:
            return self.mul_naive(a, b)
        return self.mul_ntt(a, b)

    # -- evaluation --------------------------------------------------------------
    def eval_at(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        """P(x) for one point x (W,): the powers of x by a log-depth prefix
        product, then a dot product."""
        f = self.f
        return dot_prod(f, a, powers(f, f.one(()), x, a.shape[-1]))

    def eval_many(self, xs: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        """P(x_k) for points xs (W, K) and coefficients a (W, N) -> (W, K)."""
        f = self.f
        n, k = a.shape[-1], xs.shape[-1]
        elems = torch.cat([f.one((1, k)), xs.unsqueeze(1).expand(
            f.W, n - 1, k)], 1)[:, :n].contiguous()
        pw = _scan_mul(f, elems)                        # (W, n, K)
        return sum_mod(f, f.mul(pw, a.unsqueeze(-1)), axis=1)

    # -- division ----------------------------------------------------------------
    def long_div(self, a: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Euclidean division a = q b + r.  The divisor's stored length
        defines its degree; the dividend may be zero-padded.  Returns
        (q (W, *, Na - Db), r (W, *, Db)), Db the divisor's degree."""
        f = self.f
        na, db1 = a.shape[-1], b.shape[-1]
        db = db1 - 1
        nq = na - db
        if nq < 1:
            raise DimensionError(f"dividend (len {na}) shorter than divisor "
                                 f"(len {db1})")
        lead_inv = f.inv(b[..., -1])
        rem = a.clone()
        quot = torch.zeros(a.shape[:-1] + (nq,), dtype=torch.int32,
                           device=a.device)
        for pos in range(na - 1, db - 1, -1):
            q = f.mul(rem[..., pos], lead_inv)
            quot[..., pos - db] = q
            win = rem[..., pos - db:pos + 1]
            rem[..., pos - db:pos + 1] = f.sub(win, f.mul(q.unsqueeze(-1), b))
        return quot, rem[..., :db]

    def quot(self, a, b):
        """The Euclidean quotient alone."""
        return self.long_div(a, b)[0]

    def rem(self, a, b):
        """The Euclidean remainder alone."""
        return self.long_div(a, b)[1]

    def div_by_vanishing(self, a: torch.Tensor, n: int, eta: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Division by x^n - eta, eta a field element (W,).  Returns
        (quot (W, *, max(Na - n, 0)), rem (W, *, n)).

        With P = sum_j B_j x^(j n) in k blocks of n, s_j = B_j + eta s_(j+1)
        (s_(k-1) = B_(k-1)) gives Q_i = s_(i+1) and rem = s_0.  The
        recurrence composes the affine maps F_j(t) = B_j + eta t, so it
        runs as a suffix scan in log2(k) steps: after the step of stride
        d, entry j holds the composite of F_j .. F_(j+d-1) applied to the
        rest, whose multiplier is eta^d for every entry it updates, so a
        step is B_j += eta^d B_(j+d), one product launch."""
        f = self.f
        na = a.shape[-1]
        if na <= n:
            return (a.new_zeros(a.shape[:-1] + (0,)), self.pad_to(a, n))
        k = -(-na // n)
        s = self.pad_to(a, k * n).reshape(a.shape[:-1] + (k, n))
        e = eta.reshape((f.W,) + (1,) * (s.ndim - 1))
        d = 1
        while d < k:
            t = f.mul(s[..., d:, :], e)
            s = torch.cat([f.add(s[..., :k - d, :], t), s[..., k - d:, :]], -2)
            d *= 2
            if d < k:
                e = f.sqr(e)
        quot = s[..., 1:, :].reshape(a.shape[:-1] + ((k - 1) * n,))
        return quot[..., :na - n], s[..., 0, :]

    def quot_by_vanishing(self, a: torch.Tensor, n: int, eta: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Quotient by x^n - eta and whether the division is exact."""
        q, r = self.div_by_vanishing(a, n, eta)
        return q, self.f.is_zero(r).all(-1)


_POLY_CACHE: Dict[tuple, PolyOps] = {}


def get_poly_ops(field: Field) -> PolyOps:
    """The PolyOps of `field`, cached per (field, device)."""
    key = (field.params.name, str(field.device))
    po = _POLY_CACHE.get(key)
    if po is None:
        po = _POLY_CACHE[key] = PolyOps(field)
    return po
