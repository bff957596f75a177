"""Number-theoretic transform (NTT and inverse) on limb planes.

The torch counterpart of zikkurat_algebra_tpu/ops/ntt.py::NTTDomain.
Convention (oracle/ntt.py): `ntt` evaluates the coefficients
(W, *batch, n), Montgomery form, on the subgroup of order n = 2^m,
out[k] = sum_j x[j] gen^(j k); `intt` is its inverse, the 1/n included.

Two schedules, the same result limb for limb:
- radix-2 decimation in time (the default at every size): one gather by
  the bit-reversal permutation, then m stages, each ONE launch of kernel
  K5 (`kernel_ntt.ntt_stage`) over the whole batch;
- four-step (Bailey), `four_step=True`: with n = A B, K5 column passes of
  length A over B lanes, the twiddle matrix W[k1, j2] = gen^(k1 j2) by one
  product (K1), one transpose, and K5 column passes of length B over A
  lanes.
`intt` ends with one product by 1/n.  Stage s uses the table
gen^(j 2^(m-s)), j < 2^(s-1): strided views of ONE power ladder of length
n/2, made contiguous.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..errors import DimensionError, DomainSizeError
from ..oracle.ntt import subgroup_gen
from .field import Field, _scan_mul
from .kernel_ntt import ntt_stage
from .vector import powers

HOST_LADDER_MAX = 4096      # ladders up to this length are built on the host


def bit_reverse_perm(m: int) -> np.ndarray:
    """rev[k] = k with its m low bits reversed, as int64."""
    idx = np.arange(1 << m, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(m):
        rev |= ((idx >> b) & 1) << (m - 1 - b)
    return rev


class NTTDomain:
    """The subgroup of order 2^log2_size of the field's largest FFT domain,
    with its stage tables on the field's device."""

    def __init__(self, field: Field, log2_size: int,
                 four_step: Optional[bool] = None):
        self.field = field
        self.m = log2_size
        self.n = 1 << log2_size
        p = field.p
        self.gen = subgroup_gen(field.params, log2_size)
        self.gen_inv = pow(self.gen, -1, p)
        self.n_inv = pow(self.n, -1, p)
        self.four_step = bool(four_step) and self.m >= 2
        self._perm: Optional[torch.Tensor] = None
        self._tables: Dict[bool, List[torch.Tensor]] = {}
        self._twiddle: Dict[bool, torch.Tensor] = {}
        if self.four_step:
            self._mB = self.m // 2
            self._mA = self.m - self._mB
            self._subA = get_domain(field, self._mA)
            self._subB = get_domain(field, self._mB)

    # -- tables ----------------------------------------------------------------
    def perm(self) -> torch.Tensor:
        """The bit-reversal permutation as a device index tensor."""
        if self._perm is None:
            self._perm = torch.from_numpy(bit_reverse_perm(self.m)).to(
                self.field.device)
        return self._perm

    def tables(self, inverse: bool = False) -> List[torch.Tensor]:
        """The m stage tables, (W, 2^(s-1)) for stage s, of gen or gen^-1."""
        if inverse not in self._tables:
            g = self.gen_inv if inverse else self.gen
            full = _ladder(self.field, g, max(1, self.n // 2))
            self._tables[inverse] = [
                full[:, ::1 << (self.m - s)][:, :1 << (s - 1)].contiguous()
                for s in range(1, self.m + 1)]
        return self._tables[inverse]

    def twiddle_matrix(self, inverse: bool = False) -> torch.Tensor:
        """Four-step inter-pass twiddles W[k1, j2] = g^(k1 j2), (W, A, B):
        a ladder of g along the row, then a prefix product down the rows."""
        if inverse not in self._twiddle:
            f = self.field
            A, B = 1 << self._mA, 1 << self._mB
            g = self.gen_inv if inverse else self.gen
            row = _ladder(f, g, B)
            elems = torch.cat([f.one((1, B)), row.unsqueeze(1).expand(
                f.W, A - 1, B)], 1).contiguous()
            self._twiddle[inverse] = _scan_mul(f, elems)
        return self._twiddle[inverse]

    def prepare(self):
        """Build every table the transforms of this domain use."""
        for inverse in (False, True):
            if self.four_step:
                self._subA.tables(inverse)
                self._subB.tables(inverse)
                self.twiddle_matrix(inverse)
            else:
                self.tables(inverse)
        if self.four_step:
            self._subA.perm()
            self._subB.perm()
        else:
            self.perm()
        return self

    # -- transforms ------------------------------------------------------------
    def _check(self, x: torch.Tensor) -> Tuple[int, ...]:
        if x.shape[-1] != self.n:
            raise DomainSizeError(f"domain size {self.n} != array size "
                                  f"{x.shape[-1]}")
        if x.ndim < 2 or x.shape[0] != self.field.W:
            raise DimensionError(f"want (W={self.field.W}, *batch, n) limb "
                                  f"planes, got {tuple(x.shape)}")
        return tuple(x.shape)

    def _stages(self, x: torch.Tensor, tables: List[torch.Tensor]):
        """The K5 stages along axis 2 of a (W, B, S, lanes) tensor whose
        rows are already in bit-reversed order; in place."""
        for s, tw in enumerate(tables, 1):
            ntt_stage(x, tw, s, self.field)
        return x

    def _radix2(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        shape = self._check(x)
        y = x.reshape(shape[0], -1, self.n).index_select(2, self.perm())
        y = self._stages(y.unsqueeze(-1), self.tables(inverse))
        return y.reshape(shape)

    def _four(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        """X[k2 A + k1] = sum_j2 (g^A)^(j2 k2) g^(k1 j2)
        sum_j1 x[j1 B + j2] (g^B)^(j1 k1): column passes, twiddles, one
        transpose, column passes; the (B, A) result is in output order."""
        shape = self._check(x)
        f = self.field
        A, B = 1 << self._mA, 1 << self._mB
        X = x.reshape(f.W, -1, A, B).index_select(2, self._subA.perm())
        X = self._stages(X.contiguous(), self._subA.tables(inverse))
        X = f.mul(X, self.twiddle_matrix(inverse).unsqueeze(1))
        X = X.transpose(2, 3).index_select(2, self._subB.perm()).contiguous()
        X = self._stages(X, self._subB.tables(inverse))
        return X.reshape(shape)

    def _transform(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        if self.four_step:
            return self._four(x, inverse)
        return self._radix2(x, inverse)

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """Forward NTT of Montgomery-form coefficients (W, *batch, n)."""
        return self._transform(x, False)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse NTT, the division by n included."""
        y = self._transform(x, True)
        f = self.field
        return f.mul(y, f.const(self.n_inv, y.shape[1:]))

    def __repr__(self):
        kind = "four-step" if self.four_step else "radix-2"
        return f"NTTDomain({self.field.params.name}, 2^{self.m}, {kind})"


def _ladder(f: Field, g: int, length: int) -> torch.Tensor:
    """[1, g, ..., g^(length-1)] as (W, length) Montgomery limbs: Python
    ints up to HOST_LADDER_MAX entries, a device prefix product above."""
    if length <= HOST_LADDER_MAX:
        vals, acc = [], 1
        for _ in range(length):
            vals.append(acc)
            acc = acc * g % f.p
        return f.encode(vals)
    return powers(f, f.one(()), f.encode(g), length)


_DOMAIN_CACHE: Dict[tuple, NTTDomain] = {}


def get_domain(field: Field, log2_size: int) -> NTTDomain:
    """The radix-2 domain of 2^log2_size for `field`, cached per (field,
    size, device)."""
    key = (field.params.name, log2_size, str(field.device))
    d = _DOMAIN_CACHE.get(key)
    if d is None:
        d = _DOMAIN_CACHE[key] = NTTDomain(field, log2_size)
    return d
