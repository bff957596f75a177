"""FFT over curve points (the group FFT), on limb planes.

The torch counterpart of zikkurat_algebra_tpu/ops/gfft.py::GroupFFT: the
radix-2 decimation-in-time butterflies of the NTT (ops/ntt.py) with
points in place of field elements, point addition and subtraction in
place of the field's, and a scalar multiplication by the twiddle in place
of the product.  For points P_j of a domain of size n = 2^m in the scalar
field, `fft` gives out[k] = sum_j [w^(j k)] P_j and `ifft` its inverse.

The twiddles of a stage are known when the domain is built, so they are
kept as MSB-first 4-bit digit planes (S, half) for
`ProjCurveOps.scalar_mul_digits`.  A stage is one batched scalar
multiplication of the n/2 lower halves and one batched addition that
gives both u + t and u - t.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..errors import DomainSizeError
from ..oracle.ntt import subgroup_gen
from .curve import Point, ProjCurveOps
from .ntt import bit_reverse_perm


def to_digits(vals: Sequence[int], nbits: int) -> np.ndarray:
    """Nonnegative ints below 2^nbits -> (ceil(nbits / 4), n) int64
    MSB-first 4-bit digit planes: the nibbles of their bytes."""
    nbytes = (nbits + 7) // 8
    raw = np.frombuffer(b"".join(v.to_bytes(nbytes, "little") for v in vals),
                        np.uint8).reshape(len(vals), nbytes)
    nib = np.stack([raw & 15, raw >> 4], -1).reshape(len(vals), -1)
    S = -(-nbits // 4)
    return np.ascontiguousarray(nib[:, :S][:, ::-1].T.astype(np.int64))


class GroupFFT:
    """The FFT over points of `ops` for the domain of size 2^log2_size of
    the scalar field `fr_params`."""

    def __init__(self, ops: ProjCurveOps, fr_params, log2_size: int):
        self.ops = ops
        self.m = log2_size
        self.n = 1 << log2_size
        self.r = fr_params.p
        self.nbits = self.r.bit_length()
        self.gen = subgroup_gen(fr_params, log2_size)
        self.gen_inv = pow(self.gen, -1, self.r)
        self.n_inv = pow(self.n, -1, self.r)
        dev = ops.f.device
        self._perm = torch.from_numpy(bit_reverse_perm(self.m)).to(dev)
        self._fwd = self._stage_digits(self.gen)
        self._inv = self._stage_digits(self.gen_inv)
        self._ninv_digits = torch.from_numpy(
            to_digits([self.n_inv], self.nbits)).to(dev)      # (S, 1)

    def _stage_digits(self, g: int) -> List[torch.Tensor]:
        """Per stage s, the digits of w_s^j, j < 2^(s-1), w_s = g^(2^(m-s))."""
        out = []
        for s in range(1, self.m + 1):
            w = pow(g, 1 << (self.m - s), self.r)
            tw, acc = [], 1
            for _ in range(1 << (s - 1)):
                tw.append(acc)
                acc = acc * w % self.r
            d = to_digits(tw, self.nbits)
            # leading digit rows that are zero for every twiddle add
            # nothing: drop them (stage 1, whose twiddle is 1, keeps one)
            lead = int(np.argmax(d.any(1))) if d.any() else len(d) - 1
            out.append(torch.from_numpy(d[lead:]).to(self.ops.f.device))
        return out

    def _transform(self, P: Point, tables: List[torch.Tensor]) -> Point:
        ops = self.ops
        n = self.n
        lead = P[0].shape[:-1]          # the coordinate's axes, then a batch
        if P[0].shape[-1] != n:
            raise DomainSizeError(f"group FFT of size {n} on points of shape "
                                  f"{tuple(P[0].shape)}")
        P = tuple(c.index_select(-1, self._perm) for c in P)
        for s, digits in enumerate(tables, 1):
            half = 1 << (s - 1)
            blocks = tuple(c.reshape(lead + (n >> s, 2, half)) for c in P)
            U = tuple(c.select(-2, 0) for c in blocks)
            T = ops.scalar_mul_digits(digits.unsqueeze(1),
                                      tuple(c.select(-2, 1) for c in blocks))
            # u + t and u - t in one batched addition
            out = ops.add(ops.stack([U, U], -2),
                          ops.stack([T, ops.neg(T)], -2))
            P = tuple(c.reshape(lead + (n,)) for c in out)
        return P

    def fft(self, P: Point) -> Point:
        """out[k] = sum_j [gen^(j k)] P_j for projective points (X, Y, Z)
        with coordinates (W, *batch, n) or (W, 2, *batch, n), transformed
        along the last axis."""
        return self._transform(P, self._fwd)

    def ifft(self, P: Point) -> Point:
        """The inverse of `fft`, the scalar multiplication by 1/n
        included."""
        return self.ops.scalar_mul_digits(self._ninv_digits,
                                          self._transform(P, self._inv))


_GFFT_CACHE: Dict[tuple, GroupFFT] = {}


def get_group_fft(ops: ProjCurveOps, fr_params, log2_size: int) -> GroupFFT:
    """The GroupFFT of (ops, size), cached; the cached object holds `ops`,
    so its id is not reused while the entry lives."""
    key = (id(ops), fr_params.name, log2_size)
    g = _GFFT_CACHE.get(key)
    if g is None:
        g = _GFFT_CACHE[key] = GroupFFT(ops, fr_params, log2_size)
    return g
