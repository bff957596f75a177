"""Data-parallel MSM (the torch counterpart of
zikkurat_algebra_tpu/parallel/msm.py): each rank runs the local Pippenger
(`MSM.msm_std`: kernels K1, K3 and K2 or K4) on its chunk of scalars and
points, the partial points are all-gathered, and a tree of additions
gives the same point on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.curve import AffBatch, Point
from ..ops.msm import MSM, _tree_sum
from .mesh import Mesh


def sharded_msm(msm: MSM, mesh: Mesh, k_limbs: torch.Tensor,
                points: AffBatch, c: Optional[int] = None,
                block: int = 512) -> Point:
    """sum_i k_i P_i over every rank's chunk: standard-rep scalar limbs
    (Wr, n) and affine points (x, y, inf) of this rank.  Returns the
    projective sum, replicated."""
    mesh.member()
    r = torch.stack(msm.msm_std(k_limbs, points, c, block), 0)  # (3, W..)
    parts = [torch.empty_like(r) for _ in range(mesh.size)]
    dist.all_gather(parts, r.contiguous(), group=mesh.group)
    allr = torch.stack(parts, -1)                          # (3, W.., ranks)
    return _tree_sum(msm.ops, tuple(allr.unbind(0)))
