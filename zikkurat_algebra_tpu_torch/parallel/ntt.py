"""Sharded NTT: the four-step transform over the ranks of a mesh.

The torch counterpart of zikkurat_algebra_tpu/parallel/ntt.py.  With
N = N1 N2, input index n = n1 N2 + n2 (n1 outer) and output index
k = k2 N1 + k1 (k2 outer, natural order),

    X[k2 N1 + k1] = NTT_{n2->k2}( g^(k1 n2) NTT_{n1->k1}(A)[k1, n2] )

for g of order N.  Rank r holds the contiguous chunk r of the (W, N)
array, that is N1/D whole rows of the (N1, N2) matrix.  Three
all_to_all transposes move the axis being transformed onto the rank:

  T1: (W, n1/D, n2) -> (W, n1, n2/D)    NTT over n1, twiddle g^(k1 n2)
  T2: (W, n1, n2/D) -> (W, n1/D, n2)    NTT over n2
  T3: (W, n1/D, n2) -> (W, n1, n2/D)    local transpose: natural order

The local transforms are `NTTDomain`s (kernel K5), the twiddles one
product (kernel K1).  The inverse runs the same pipeline with the inverse
twiddles and the domains' intt, whose 1/N1 and 1/N2 make 1/N.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..errors import DimensionError, DomainSizeError, MeshError
from ..ops.field import Field, _scan_mul
from ..ops.ntt import get_domain
from ..ops.vector import powers
from .mesh import Mesh


def split_sizes(log2_size: int, mesh: Mesh):
    """(m1, m2) with m1 + m2 = log2_size and both 2^m1, 2^m2 at least the
    mesh size, which must be a power of two."""
    d = mesh.size
    if d & (d - 1):
        raise MeshError(f"mesh of {d} ranks: a power of two is needed")
    m2 = max((log2_size + 1) // 2, (d - 1).bit_length())
    m1 = log2_size - m2
    if m1 < 0 or (1 << m1) < d or (1 << m2) < d:
        raise DomainSizeError(f"domain 2^{log2_size} too small for {d} "
                              "ranks")
    return m1, m2


def _all_to_all(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Chunk j of axis 0 (of size mesh.size) goes to rank j; chunk i of the
    result came from rank i."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group)
    return out


def to_cols(mesh: Mesh, A: torch.Tensor, n1: int) -> torch.Tensor:
    """(*lead, n1/D, n2) rows of rank r -> (*lead, n1, n2/D) columns."""
    nd = mesh.size
    n2 = A.shape[-1]
    A = A.reshape(A.shape[:-1] + (nd, n2 // nd)).movedim(-2, 0)
    B = _all_to_all(mesh, A)                         # (src, *lead, n1/D, n2/D)
    return B.movedim(0, -3).reshape(A.shape[1:-2] + (n1, n2 // nd))


def to_rows(mesh: Mesh, B: torch.Tensor, n2: int) -> torch.Tensor:
    """(*lead, n1, n2/D) columns -> (*lead, n1/D, n2) rows of rank r."""
    nd = mesh.size
    n1, cols = B.shape[-2:]
    B = B.reshape(B.shape[:-2] + (nd, n1 // nd, cols)).movedim(-3, 0)
    A = _all_to_all(mesh, B)                         # (src, *lead, n1/D, n2/D)
    return A.movedim(0, -2).reshape(B.shape[1:-2] + (n1 // nd, n2))


class ShardedNTT:
    """Four-step NTT of size 2^log2_size over a power-of-two mesh; `ntt`
    and `intt` take and return this rank's chunk (W, 2^log2_size / D) of
    Montgomery-form values."""

    def __init__(self, field: Field, log2_size: int, mesh: Mesh):
        self.field = field
        self.m = log2_size
        self.n = 1 << log2_size
        self.mesh = mesh
        self.ndev = mesh.size
        self.m1, self.m2 = split_sizes(log2_size, mesh)
        self.n1, self.n2 = 1 << self.m1, 1 << self.m2
        self.dom1 = get_domain(field, self.m1)
        self.dom2 = get_domain(field, self.m2)
        self.dom = get_domain(field, log2_size)
        self._tw = {}

    def twiddles(self, inverse: bool) -> torch.Tensor:
        """This rank's (W, n1, n2/D) columns of g^(k1 n2), by prefix
        products on the device: a ladder of g along n2, then products
        down the rows."""
        if inverse not in self._tw:
            f = self.field
            n1, n2, c = self.n1, self.n2, self.n2 // self.ndev
            g = self.dom.gen_inv if inverse else self.dom.gen
            row = powers(f, f.one(()), f.encode(g), n2)[
                :, self.mesh.member() * c:][:, :c]
            elems = torch.cat([f.one((1, c)),
                               row.unsqueeze(1).expand(f.W, n1 - 1, c)], 1)
            self._tw[inverse] = _scan_mul(f, elems.contiguous())
        return self._tw[inverse]

    def _transform(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        f, mesh = self.field, self.mesh
        n1, n2, nd = self.n1, self.n2, self.ndev
        if x.shape != (f.W, self.n // nd):
            raise DimensionError(f"want this rank's (W={f.W}, {self.n // nd}) "
                                 f"chunk, got {tuple(x.shape)}")
        ntt1 = self.dom1.intt if inverse else self.dom1.ntt
        ntt2 = self.dom2.intt if inverse else self.dom2.ntt
        A = to_cols(mesh, x.reshape(f.W, n1 // nd, n2), n1)  # (W, n1, n2/D)
        Y = ntt1(A.movedim(1, -1)).movedim(-1, 1)            # over n1
        Y = f.mul(Y, self.twiddles(inverse))
        Z = ntt2(to_rows(mesh, Y, n2))                        # (W, n1/D, n2)
        Zt = to_cols(mesh, Z, n1)                             # (W, n1, n2/D)
        return Zt.movedim(1, 2).reshape(f.W, self.n // nd)

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        return self._transform(x, inverse=False)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        return self._transform(x, inverse=True)
