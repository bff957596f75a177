"""Polynomials with the coefficient axis sharded over a mesh.

The torch counterpart of zikkurat_algebra_tpu/parallel/poly.py:

- `add`, `sub` and `scale` are pointwise: each rank's own chunk;
- `mul` is the sharded NTT (parallel/ntt.py) of both operands, a local
  product, and the sharded inverse NTT;
- `eval_at` builds the rank's slice of the powers of x locally, from
  x^(rank * chunk), and ends in one int64 all_reduce of the limb columns
  and one wide reduction (as parallel/vector.py);
- `div_by_vanishing` by x^n_van - eta: the block recurrence
  R_j = B_j + eta R_(j+1) runs as a suffix scan inside each rank
  (`ops.poly.suffix_blocks`); the ranks' zero-carry R_0 are all-gathered
  and folded into each rank's carry, and the quotient's blocks shift down
  by one, the first block of rank r + 1 sent to rank r.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..errors import DimensionError, DomainSizeError
from ..ops.field import Field
from ..ops.poly import get_poly_ops, suffix_blocks
from ..ops.vector import dot_prod, powers
from .mesh import Mesh
from .ntt import ShardedNTT
from .vector import all_reduce_limbs


class ShardedPolyOps:
    """Polynomials of 2^log2_size coefficients over one field, each rank
    holding its contiguous chunk (W, 2^log2_size / D)."""

    def __init__(self, field: Field, log2_size: int, mesh: Mesh):
        self.f = field
        self.m = log2_size
        self.n = 1 << log2_size
        self.mesh = mesh
        self.ndev = mesh.size
        self.chunk = self.n // self.ndev
        if self.chunk * self.ndev != self.n:
            raise DomainSizeError(f"poly size 2^{log2_size} not divisible "
                                  f"over {self.ndev} ranks")
        self.local = get_poly_ops(field)
        self._sntt: Optional[ShardedNTT] = None

    @property
    def sntt(self) -> ShardedNTT:
        if self._sntt is None:
            self._sntt = ShardedNTT(self.f, self.m, self.mesh)
        return self._sntt

    # -- pointwise ring operations: no communication ------------------------------
    def add(self, a, b):
        return self.local.add(a, b)

    def sub(self, a, b):
        return self.local.sub(a, b)

    def scale(self, s, a):
        return self.local.scale(s, a)

    # -- multiplication ------------------------------------------------------------
    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The product of two sharded polynomials through the sharded NTT:
        cyclic of length 2^log2_size, so the caller leaves the top half
        of each operand zero (as one `PolyOps.mul_ntt` step)."""
        fa, fb = self.sntt.ntt(a), self.sntt.ntt(b)
        return self.sntt.intt(self.f.mul(fa, fb))

    # -- evaluation ------------------------------------------------------------------
    def eval_at(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        """P(x) for a replicated point x (W,) and this rank's chunk of the
        coefficients -> replicated (W,)."""
        f = self.f
        xc = x
        for _ in range(self.chunk.bit_length() - 1):     # x^chunk
            xc = f.sqr(xc)
        off = f.pow_static(xc, self.mesh.member())       # x^(rank chunk)
        pw = powers(f, off, x, self.chunk)
        return all_reduce_limbs(f, self.mesh, dot_prod(f, a, pw))

    # -- division by a vanishing polynomial ---------------------------------------
    def div_by_vanishing(self, a: torch.Tensor, n_van: int, eta: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Divide the sharded polynomial by x^n_van - eta (eta (W,),
        replicated).  Returns (quot, rem): quot is this rank's chunk of a
        full-size quotient whose top n_van coefficients are zero, rem the
        replicated (W, n_van) remainder.  n_van must divide the chunk."""
        f, mesh = self.f, self.mesh
        W, chunk, nd = f.W, self.chunk, self.ndev
        rank = mesh.member()
        if chunk % n_van:
            raise DimensionError(f"vanishing degree {n_van} must divide the "
                                 f"per-rank chunk {chunk}")
        kloc = chunk // n_van
        R = suffix_blocks(f, a.reshape(W, kloc, n_van), eta)  # zero carry

        # the carry into this rank: the global R of rank + 1's first block,
        # folded down from the top rank with eta^kloc per rank
        firsts = [torch.empty_like(R[:, 0]) for _ in range(nd)]
        dist.all_gather(firsts, R[:, 0].contiguous(), group=mesh.group)
        s = f.pow_static(eta, kloc)
        carry = f.zero((n_van,))
        for d in range(nd - 2, rank - 1, -1):
            carry = f.add(firsts[d + 1], f.mul(s.view(W, 1), carry))
        epow = powers(f, eta, eta, kloc).flip(-1)        # j -> eta^(kloc - j)
        R = f.add(R, f.mul(epow.unsqueeze(-1), carry.unsqueeze(1)))

        # rem: rank 0's first block, replicated
        rem = R[:, 0].clone() if rank == 0 else torch.zeros_like(R[:, 0])
        dist.all_reduce(rem, group=mesh.group)

        # quotient block j = R_(j+1): rank r + 1's first block moves to r
        nxt = torch.zeros_like(R[:, 0])
        ops = []
        if rank > 0:
            ops.append(dist.P2POp(dist.isend, R[:, 0].contiguous(), rank - 1,
                                  mesh.group))
        if rank < nd - 1:
            ops.append(dist.P2POp(dist.irecv, nxt, rank + 1, mesh.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        q = torch.cat([R[:, 1:], nxt.unsqueeze(1)], 1)
        return q.reshape(W, chunk), rem
