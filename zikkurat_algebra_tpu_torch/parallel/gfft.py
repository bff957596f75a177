"""Sharded FFT over curve points (the group FFT) over a mesh.

The torch counterpart of zikkurat_algebra_tpu/parallel/gfft.py: the
four-step pipeline of parallel/ntt.py with points in place of field
elements,

    X[k2 N1 + k1] = GFFT_{n2->k2}( [g^(k1 n2)] GFFT_{n1->k1}(P) ),

the local transforms `GroupFFT`s batched over the other axis, and the
step-2 twiddles a scalar multiplication (`scalar_mul_digits`) by the
domain constants g^(k1 n2), kept as 4-bit digit planes of this rank's
columns.  Used to shard the Lagrange-basis conversion of a KZG setup.
"""

from __future__ import annotations

import torch

from ..errors import DimensionError
from ..ops.curve import Point, ProjCurveOps
from ..ops.gfft import get_group_fft, to_digits
from ..oracle.ntt import subgroup_gen
from .mesh import Mesh
from .ntt import split_sizes, to_cols, to_rows


class ShardedGroupFFT:
    """Four-step group FFT of size 2^log2_size over a power-of-two mesh;
    `fft` and `ifft` take and return this rank's chunk of projective
    points, coordinates (W, n / D) or (W, 2, n / D)."""

    def __init__(self, ops: ProjCurveOps, fr_params, log2_size: int,
                 mesh: Mesh):
        self.ops = ops
        self.m = log2_size
        self.n = 1 << log2_size
        self.mesh = mesh
        self.ndev = mesh.size
        self.m1, self.m2 = split_sizes(log2_size, mesh)
        self.n1, self.n2 = 1 << self.m1, 1 << self.m2
        self.f1 = get_group_fft(ops, fr_params, self.m1)
        self.f2 = get_group_fft(ops, fr_params, self.m2)
        self.r = fr_params.p
        g = subgroup_gen(fr_params, log2_size)
        self._tw_fwd = self._tw_digits(g)
        self._tw_inv = self._tw_digits(pow(g, -1, self.r))

    def _tw_digits(self, g: int) -> torch.Tensor:
        """(S, n2/D, n1) digit planes of g^(k1 n2) for this rank's columns
        n2: domain constants, made once on the host."""
        c = self.n2 // self.ndev
        cols = range(self.mesh.member() * c, (self.mesh.member() + 1) * c)
        vals = [pow(g, k1 * j2, self.r) for j2 in cols
                for k1 in range(self.n1)]
        d = to_digits(vals, self.r.bit_length())
        return torch.from_numpy(d.reshape(-1, c, self.n1)).to(
            self.ops.f.device)

    def _transform(self, P: Point, inverse: bool) -> Point:
        ops, mesh = self.ops, self.mesh
        n1, n2, nd = self.n1, self.n2, self.ndev
        sn = ops.f.struct_ndim
        if P[0].ndim != sn + 1 or P[0].shape[-1] != self.n // nd:
            raise DimensionError(f"want this rank's {self.n // nd} points, "
                                 f"got coordinates {tuple(P[0].shape)}")
        fft1 = self.f1.ifft if inverse else self.f1.fft
        fft2 = self.f2.ifft if inverse else self.f2.fft
        tw = self._tw_inv if inverse else self._tw_fwd
        A = tuple(to_cols(mesh, c.reshape(c.shape[:-1] + (n1 // nd, n2)), n1)
                  for c in P)                              # (.., n1, n2/D)
        Y = fft1(tuple(c.transpose(-1, -2) for c in A))   # (.., n2/D, n1)
        Y = ops.scalar_mul_digits(tw, Y)
        Z = fft2(tuple(to_rows(mesh, c.transpose(-1, -2), n2) for c in Y))
        return tuple(to_cols(mesh, c, n1).transpose(-1, -2).reshape(
            c.shape[:-2] + (self.n // nd,)) for c in Z)    # natural order

    def fft(self, P: Point) -> Point:
        return self._transform(P, inverse=False)

    def ifft(self, P: Point) -> Point:
        return self._transform(P, inverse=True)
