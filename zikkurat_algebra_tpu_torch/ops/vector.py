"""Pointwise and reduction operations on batches of field elements.

The torch counterpart of zikkurat_algebra_tpu/ops/vector.py: `powers`,
`sum_mod`, `dot_prod`, `mul_add`, `mul_sub`, `ax_plus_y`, `ax_plus_by`,
`scale` and `lin_comb`, on (W, *batch) Montgomery limb planes of a
`Field`.  Plain pointwise add/sub/mul are the Field's own methods.

Sums do not carry over from the JAX package, whose lazy radix-2^15 column
sums rely on spare bits in each limb.  Canonical 32-bit limbs have none,
so a sum here is an int64 column sum of the limbs (exact below 2^30
terms), one carry pass, and a reduction of the (W + 1)-limb total with
one stacked Montgomery product launch (`Field.reduce_wide`).
"""

from __future__ import annotations

import torch

from . import limbs as lb
from .field import Field, _scan_mul

_CHUNK = 1 << 30            # terms per int64 column sum: 2^30 * 2^32 < 2^63


def sum_mod(f: Field, a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Sum of the field elements along a batch axis of a (W, *batch)."""
    if axis < 0:
        axis += a.ndim
    if axis < 1:
        raise ValueError("sum_mod: axis 0 is the limb axis")
    x = a.movedim(axis, -1)
    if x.shape[-1] == 0:
        return f.zero(x.shape[1:-1])
    out = None
    for part in x.split(_CHUNK, -1):
        s = f.reduce_wide(lb.to64(part).sum(-1))
        out = s if out is None else f.add(out, s)
    return out


def dot_prod(f: Field, a, b) -> torch.Tensor:
    """sum_i a_i b_i along the last axis: one product launch, then
    `sum_mod`."""
    return sum_mod(f, f.mul(a, b))


def mul_add(f: Field, a, b, c):
    """a b + c, elementwise."""
    return f.add(f.mul(a, b), c)


def mul_sub(f: Field, a, b, c):
    """a b - c, elementwise."""
    return f.sub(f.mul(a, b), c)


def ax_plus_y(f: Field, a, x, y):
    """A x + y for a scalar A, (W,) or (W, 1, ...), and vectors x, y."""
    return f.add(f.mul(_bcast(f, a, x), x), y)


def ax_plus_by(f: Field, a, x, b, y):
    """A x + B y for scalars A, B: both products in one launch."""
    px, py = f.mul_list([(_bcast(f, a, x), x), (_bcast(f, b, y), y)])
    return f.add(px, py)


def scale(f: Field, s, a):
    """s a_i for a scalar s, (W,) or (W, 1, ...)."""
    return f.mul(_bcast(f, s, a), a)


def powers(f: Field, a: torch.Tensor, b: torch.Tensor, n: int
           ) -> torch.Tensor:
    """[a, a b, ..., a b^(n-1)] as (W, n) for elements a, b (W,): a
    log-depth prefix product (log2 n product launches)."""
    elems = torch.cat([a.reshape(f.W, 1),
                       b.reshape(f.W, 1).expand(f.W, max(n - 1, 0))], 1)
    return _scan_mul(f, elems[:, :n].contiguous())


def lin_comb(f: Field, coeffs: torch.Tensor, vecs: torch.Tensor
             ) -> torch.Tensor:
    """sum_k coeffs_k vecs_k for coeffs (W, K) and vecs (W, K, N) ->
    (W, N)."""
    return sum_mod(f, f.mul(coeffs.unsqueeze(-1), vecs), axis=1)


def _bcast(f: Field, s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return s.reshape((f.W,) + (1,) * (like.ndim - 1))
