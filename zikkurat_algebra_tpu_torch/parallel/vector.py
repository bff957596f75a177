"""Sharded reductions (the torch counterpart of
zikkurat_algebra_tpu/parallel/vector.py).

Pointwise operations need no code: a rank applies the Field's own to its
chunk.  A reduction is the local one (ops/vector.py, canonical W limbs),
an int64 all_reduce of the limb columns (each below size * 2^32), and one
`Field.reduce_wide`: the result is replicated on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import limbs as lb
from ..ops import vector as V
from ..ops.field import Field
from .mesh import Mesh


def all_reduce_limbs(f: Field, mesh: Mesh, local: torch.Tensor
                     ) -> torch.Tensor:
    """sum over the ranks of canonical (W, *batch) elements mod p,
    replicated."""
    mesh.member()
    cols = lb.to64(local)
    dist.all_reduce(cols, group=mesh.group)
    return f.reduce_wide(cols)


def sharded_sum(f: Field, mesh: Mesh, a: torch.Tensor) -> torch.Tensor:
    """The sum of the elements of a sharded (W, *batch, n) along its last
    axis -> replicated (W, *batch)."""
    return all_reduce_limbs(f, mesh, V.sum_mod(f, a))


def sharded_dot(f: Field, mesh: Mesh, a: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """<a, b> along the last axis of two sharded arrays -> replicated."""
    return all_reduce_limbs(f, mesh, V.dot_prod(f, a, b))
