"""Batched Montgomery prime field on radix-2^32 limb planes.

The torch counterpart of zikkurat_algebra_tpu/ops/field.py::Field,
restricted to what the MSMs use.  Elements are (W, *batch) int32
planes (ops/limbs.py), canonical in [0, p), in Montgomery form with
R = 2^(32 W).  Every product goes through `kernel_field.mont_mul`: kernel
K1 for CUDA tensors, its plain version for CPU tensors.  `mul_list` stacks
independent products into one launch, as the JAX package does.
"""

from __future__ import annotations

import copy
from typing import List, Sequence, Tuple, Union

import torch

from ..params import FieldParams
from . import kernel_field, limbs as lb


def resolve_device(device) -> torch.device:
    """The torch device for `device`; "cuda" on a host without a usable
    card raises instead of running somewhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run the plain versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Field:
    """Montgomery-form GF(p) bound to one device."""

    struct_ndim = 1            # leading axes of an element: the limbs

    def __init__(self, params: FieldParams, device="cuda"):
        self.params = params
        self.p = params.p
        self.W = lb.nwords(self.p)
        self.device = resolve_device(device)
        self.R = 1 << (32 * self.W)
        self.R_inv = pow(self.R, -1, self.p)
        self.n0 = (-pow(self.p, -1, 1 << 32)) % (1 << 32)
        dev = self.device

        def t(value, W):
            return torch.from_numpy(lb.ints_to_limbs(value, W).copy()).to(dev)

        self.p32 = t(self.p, self.W)
        self.p64 = self.p32.to(torch.int64) & lb.M32
        self.p64_ext = torch.cat([self.p64, self.p64.new_zeros(1)])
        np_inv = (-pow(self.p, -1, self.R)) % self.R
        self.p16 = _digits16(self.p, self.W, dev)
        self.np16 = _digits16(np_inv, self.W, dev)
        self.one_limbs = t(self.R % self.p, self.W)
        self.r2_limbs = t(self.R * self.R % self.p, self.W)
        self._mont_mul = kernel_field.mont_mul
        self.p_minus_2 = self.p - 2

    def plain(self) -> "Field":
        """A view of this field whose products always run the plain torch
        version, on any device (the reference the kernels are held to)."""
        g = copy.copy(self)
        g._mont_mul = kernel_field.mont_mul_plain
        return g

    # -- constants ---------------------------------------------------------
    def const(self, value: int, batch_shape=()) -> torch.Tensor:
        """Montgomery form of an int, broadcast to (W, *batch_shape)."""
        v = lb.ints_to_limbs((value % self.p) * self.R % self.p, self.W)
        c = torch.from_numpy(v.copy()).to(self.device)
        return lb.bcast(c, len(batch_shape) + 1).expand(
            (self.W,) + tuple(batch_shape))

    def zero(self, batch_shape=()) -> torch.Tensor:
        return torch.zeros((self.W,) + tuple(batch_shape), dtype=torch.int32,
                           device=self.device)

    def one(self, batch_shape=()) -> torch.Tensor:
        return lb.bcast(self.one_limbs, len(batch_shape) + 1).expand(
            (self.W,) + tuple(batch_shape))

    # -- ring ops ----------------------------------------------------------
    def add(self, a, b):
        return lb.add_mod(a, b, self.p64)

    def sub(self, a, b):
        return lb.sub_mod(a, b, self.p64)

    def neg(self, a):
        return lb.neg_mod(a, self.p64)

    def add_list(self, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> List[torch.Tensor]:
        """Independent sums as one stacked add."""
        return self._stacked(lb.add_mod, pairs)

    def sub_list(self, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> List[torch.Tensor]:
        return self._stacked(lb.sub_mod, pairs)

    @staticmethod
    def _stack(pairs):
        """K pairs -> two (W, K, *batch) operands on one batch axis."""
        shape = torch.broadcast_shapes(*[x.shape for pr in pairs for x in pr])
        return (torch.stack([p[0].expand(shape) for p in pairs], 1),
                torch.stack([p[1].expand(shape) for p in pairs], 1))

    def _stacked(self, op, pairs):
        if len(pairs) == 1:
            return [op(pairs[0][0], pairs[0][1], self.p64)]
        return list(op(*self._stack(pairs), self.p64).unbind(1))

    def mul(self, a, b):
        shape = torch.broadcast_shapes(a.shape, b.shape)
        return self._mont_mul(a.expand(shape).contiguous(),
                              b.expand(shape).contiguous(), self)

    def sqr(self, a):
        a = a.contiguous()
        return self._mont_mul(a, a, self)

    def mul_list(self, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> List[torch.Tensor]:
        """K independent products in ONE launch (field.py:277-287)."""
        if len(pairs) == 1:
            return [self.mul(pairs[0][0], pairs[0][1])]
        return list(self._mont_mul(*self._stack(pairs), self).unbind(1))

    def scale_small(self, a, k: int):
        """k * a mod p for a small int k (one product by k R mod p)."""
        return self.mul(a, self.const(k, a.shape[1:]))

    # -- predicates and selection -------------------------------------------
    def norm(self, a):
        """Canonical [0, p) limbs of any value < 2^(32 W)."""
        return self.mul(a, self.one(a.shape[1:]))

    def is_zero(self, a) -> torch.Tensor:
        return (a == 0).all(0)

    def eq(self, a, b) -> torch.Tensor:
        return (a == b).all(0)

    def select(self, pred, a, b):
        return torch.where(pred.unsqueeze(0), a, b)

    # -- inversion -----------------------------------------------------------
    def inv(self, a):
        """Fermat inverse a^(p-2), MSB-first square-and-multiply; inv(0) = 0."""
        e = self.p_minus_2
        acc = a.contiguous()
        for i in range(e.bit_length() - 2, -1, -1):
            acc = self.sqr(acc)
            if (e >> i) & 1:
                acc = self.mul(acc, a)
        return acc

    def batch_inv(self, a):
        """Montgomery batch inversion: prefix products, ONE inversion, and
        the products back; zeros map to zero without poisoning the batch
        (field.py:361-381)."""
        x = a.reshape(self.W, -1)
        n = x.shape[1]
        if n == 1:
            return self.inv(a)
        zero = self.is_zero(x)
        x = self.select(zero, self.one((n,)), x)
        prefix = _scan_mul(self, x)                        # x0 ... xi
        suffix = _scan_mul(self, x.flip(1)).flip(1)        # xi ... x_{n-1}
        total_inv = self.inv(prefix[:, -1:])
        # 1 / x_i = (x0 ... x_{i-1}) (x_{i+1} ... x_{n-1}) / (x0 ... x_{n-1})
        one = self.one((1,))
        p_shift = torch.cat([one, prefix[:, :-1]], 1)
        s_shift = torch.cat([suffix[:, 1:], one], 1)
        out = self.mul(self.mul(p_shift, s_shift), total_inv)
        out = self.select(zero, torch.zeros_like(out), out)
        return out.reshape(a.shape)

    # -- representation conversions ------------------------------------------
    def to_mont(self, a_std):
        return self.mul(a_std, self.r2_limbs.view(
            (self.W,) + (1,) * (a_std.ndim - 1)))

    def from_mont(self, a):
        """Montgomery -> canonical standard-rep limbs: a * 1 * R^-1."""
        one_std = torch.zeros_like(a)
        one_std[0] = 1
        return self.mul(a, one_std)

    # -- host encode / decode -------------------------------------------------
    def encode(self, values: Union[int, Sequence[int]], mont: bool = True):
        """Python ints (standard rep, any residue) -> (W,) or (W, N) limbs."""
        if isinstance(values, int):
            values = [values]
            one = True
        else:
            values = list(values)
            one = False
        vals = [v % self.p for v in values]
        if mont:
            vals = [v * self.R % self.p for v in vals]
        arr = lb.ints_to_limbs(vals, self.W)
        t = torch.from_numpy(arr.copy()).to(self.device)
        return t[:, 0] if one else t

    def decode(self, limbs, mont: bool = True):
        out = lb.limbs_to_ints(limbs)
        if isinstance(out, int):
            return out * self.R_inv % self.p if mont else out % self.p
        if mont:
            return [v * self.R_inv % self.p for v in out]
        return [v % self.p for v in out]

    def __repr__(self):
        return f"Field({self.params.name}, W={self.W}, {self.device})"


def _digits16(value: int, W: int, device) -> torch.Tensor:
    d = [(value >> (16 * i)) & 0xFFFF for i in range(2 * W)]
    return torch.tensor(d, dtype=torch.int64, device=device)


def _scan_mul(f: Field, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along axis 1 in log2(n) batched steps."""
    n = x.shape[1]
    s = 1
    while s < n:
        head = x[:, :s]
        x = torch.cat([head, f.mul(x[:, s:], x[:, :-s])], 1)
        s *= 2
    return x
