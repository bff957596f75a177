"""Batched Montgomery prime field on radix-2^32 limb planes.

The torch counterpart of zikkurat_algebra_tpu/ops/field.py::Field.
Elements are (W, *batch) int32 planes (ops/limbs.py), canonical in
[0, p), in Montgomery form with R = 2^(32 W); W runs from 1 (M31) to 12
(BLS12-381 Fp).  Every product goes through `kernel_field.mont_mul`:
kernel K1 for CUDA tensors, its plain version for CPU tensors.
`mul_list` stacks independent products into one launch, as the JAX
package does.

Exponents (`pow_bits`, `pow_static`, `inv`, `sqrt`) are public host
integers.  `pow_static` runs a whole square-and-multiply chain through
`kernel_field.field_pow`: ONE launch of kernel P2 for CUDA tensors (per
512 exponent bits), its plain loop over the plain product for CPU
tensors; the exponent's bits are the kernel's parameters, so nothing is
read back from the device.  Data-dependent choices (Tonelli-Shanks'
levels) are device selects.  The constants they use are device tensors
built once per field (`const` keeps every constant it has built).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
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
        self._pow = kernel_field.field_pow
        self._consts: Dict[int, torch.Tensor] = {}
        # the reference C's Montgomery R = 2^(64 ceil(bits / 64)), the R of
        # export_ref_mont / import_ref_mont; it differs from R for odd W
        self.ref_words = -(-self.p.bit_length() // 64)
        self.R_ref = 1 << (64 * self.ref_words)

    def plain(self) -> "Field":
        """A view of this field whose products always run the plain torch
        version, on any device (the reference the kernels are held to)."""
        g = copy.copy(self)
        g._mont_mul = kernel_field.mont_mul_plain
        g._pow = kernel_field.field_pow_plain
        return g

    @property
    def on_kernel(self) -> bool:
        """Whether products may run K1 (False for a `plain()` view)."""
        return self._mont_mul is not kernel_field.mont_mul_plain

    # -- constants ---------------------------------------------------------
    def const(self, value: int, batch_shape=()) -> torch.Tensor:
        """Montgomery form of an int, broadcast to (W, *batch_shape).  The
        (W,) device tensor of each value is built once and kept."""
        value %= self.p
        c = self._consts.get(value)
        if c is None:
            c = self._consts[value] = self.encode(value)
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

    def mul_many(self, a_stack, b_stack):
        """Independent products stacked on the K axis of (W, K, *batch)
        operands, in ONE launch (field.py:272)."""
        return self.mul(a_stack, b_stack)

    def mul_list(self, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> List[torch.Tensor]:
        """K independent products in ONE launch (field.py:277-287)."""
        if len(pairs) == 1:
            return [self.mul(pairs[0][0], pairs[0][1])]
        return list(self.mul_many(*self._stack(pairs)).unbind(1))

    def scale_small(self, a, k: int):
        """k * a mod p for a small int k (one product by k R mod p)."""
        return self.mul(a, self.const(k, a.shape[1:]))

    def muli(self, a, k: int):
        """k * a for a static int k (field.py:289): no product for k = 0
        or 1."""
        if k == 0:
            return torch.zeros_like(a)
        if k == 1:
            return a
        return self.scale_small(a, k)

    def times(self, a, k: int):
        """k a for a small int k by additions alone (double-and-add over
        the bits of |k|), so no product is launched: the carry-free
        small-int scaling of the JAX package (field.py:289)."""
        if k < 0:
            return self.neg(self.times(a, -k))
        if k == 0:
            return torch.zeros_like(a)
        acc = a
        for bit in bin(k)[3:]:
            acc = self.add(acc, acc)
            if bit == "1":
                acc = self.add(acc, a)
        return acc

    def div2(self, a):
        """a / 2: one product by the constant 1/2 (field.py:298)."""
        return self.scale_small(a, (self.p + 1) // 2)

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

    def is_valid(self, a) -> torch.Tensor:
        """Whether limbs a encode a value below p (field.py:384): a - p
        borrows."""
        _, borrow = lb.sub_borrow(lb.to64(a) - lb.bcast(self.p64, a.ndim))
        return borrow.bool()

    # -- exponentiation ------------------------------------------------------
    def pow_bits(self, a, bits):
        """a^e for e given by its little-endian bits on the host (a
        sequence or numpy array of 0/1; field.py:325)."""
        return self.pow_static(a, sum(1 << int(i) for i in
                                      np.flatnonzero(np.asarray(bits))))

    def pow_static(self, a, e: int):
        """a^e for a host int e, a negative e inverting first: MSB-first
        square-and-multiply in `kernel_field.field_pow`, one launch of
        kernel P2 on the card."""
        if e < 0:
            return self.pow_static(self.inv(a), -e)
        return self._pow(a.contiguous(), e, self)

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    # -- inversion -----------------------------------------------------------
    def inv(self, a):
        """Fermat inverse a^(p-2); inv(0) = 0."""
        return self.pow_static(a, self.p - 2)

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

    # -- square roots ----------------------------------------------------------
    def sqrt(self, a):
        """(root, is_square) for Montgomery elements a (field.py:392-439):
        a^((p+1)/4) for p = 3 mod 4, else Tonelli-Shanks with a constant
        number of steps, s - 1 levels for p - 1 = q 2^s with q odd.
        is_square is root^2 == a, so a non-residue reports False."""
        if self.p % 4 == 3:
            r = self.pow_static(a, (self.p + 1) // 4)
            return r, self.eq(self.sqr(r), a)
        q, s = self._two_adic
        # w = a^((q-1)/2): x = a w = a^((q+1)/2), t = x w = a^q
        w = self.pow_static(a, (q - 1) // 2)
        x = self.mul(a, w)
        t = self.mul(x, w)
        bs = a.shape[1:]
        c = self.const(pow(self.params.multiplicative_gen, q, self.p), bs)
        minus1 = self.const(-1, bs)
        # level i = s .. 2: c has order 2^i; where t^(2^(i-2)) = -1, t has
        # order 2^(i-1) and x, t take one factor c more
        for i in range(s, 1, -1):
            t2 = t
            for _ in range(i - 2):
                t2 = self.sqr(t2)
            flag = self.eq(t2, minus1)
            xc, c = self.mul_list([(x, c), (c, c)])
            x = self.select(flag, xc, x)
            t = self.select(flag, self.mul(t, c), t)
        return x, self.eq(self.sqr(x), a)

    @property
    def _two_adic(self) -> Tuple[int, int]:
        """(q, s) with p - 1 = q 2^s, q odd."""
        s = ((self.p - 1) & -(self.p - 1)).bit_length() - 1
        return (self.p - 1) >> s, s

    # -- lazy wide sums ----------------------------------------------------------
    def reduce_wide(self, cols: torch.Tensor) -> torch.Tensor:
        """Canonical limbs of the residue of sum_i cols[i] 2^(32 i) for
        int64 columns (W, *batch) in [0, 2^62) (field.py:441, over the
        port's column format: the int64 column sums of ops/vector.py).
        Returns (W, *batch) int32."""
        W = self.W
        zero = torch.zeros_like(cols[:1])
        c = torch.cat([cols, zero], 0)
        c = (c & lb.M32) + torch.cat([zero, c[:-1] >> 32], 0)   # < 2^33
        limbs, _ = lb.add_carry(c)       # W + 1 limbs; the top one < 2^31
        low = lb.to32(limbs[:W])
        top = torch.cat([limbs[W:], torch.zeros_like(limbs[1:W])], 0)
        bs = cols.shape[1:]
        r2 = lb.bcast(self.r2_limbs, cols.ndim).expand(low.shape)
        # low R R^-1 = low mod p;  top R^2 R^-1 = top 2^(32 W) mod p
        lo, hi = self.mul_list([(low, self.one(bs)), (lb.to32(top), r2)])
        return self.add(lo, hi)

    # -- representation conversions ------------------------------------------
    def to_mont(self, a_std):
        return self.mul(a_std, self.r2_limbs.view(
            (self.W,) + (1,) * (a_std.ndim - 1)))

    def from_mont(self, a):
        """Montgomery -> canonical standard-rep limbs: a * 1 * R^-1."""
        one_std = torch.zeros_like(a)
        one_std[0] = 1
        return self.mul(a, one_std)

    def norm_std(self, a):
        """Canonical [0, p) limbs of a standard-rep value < 2^(32 W)
        (field.py:466).  A product by R mod p reduces either form."""
        return self.norm(a)

    def std_mul(self, a_std, b_std):
        """a b mod p on standard-rep limbs: (a b R^-1) R^2 R^-1."""
        t = self.mul(a_std, b_std)
        return self.mul(t, lb.bcast(self.r2_limbs, t.ndim).expand(t.shape))

    def std_inv(self, a_std):
        return self.from_mont(self.inv(self.to_mont(a_std)))

    def std_pow(self, a_std, e: int):
        return self.from_mont(self.pow_static(self.to_mont(a_std), e))

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

    # -- the reference C's word format (host) -----------------------------------
    def export_ref_mont(self, limbs) -> List[List[int]]:
        """Elements -> the reference C's Montgomery words: value * R_ref
        mod p as little-endian 64-bit words, R_ref = 2^(64 ceil(bits/64))
        (field.py:517), one word list per element."""
        vals = self.decode(limbs)
        if isinstance(vals, int):
            vals = [vals]
        mask = (1 << 64) - 1
        return [[(v * self.R_ref % self.p >> (64 * i)) & mask
                 for i in range(self.ref_words)] for v in vals]

    def import_ref_mont(self, words_list: Sequence[Sequence[int]]):
        """The inverse of `export_ref_mont`: (W, N) Montgomery limbs."""
        r_inv = pow(self.R_ref, -1, self.p)
        vals = [sum(int(w) << (64 * i) for i, w in enumerate(words))
                * r_inv % self.p for words in words_list]
        return self.encode(vals)

    # -- randomness ------------------------------------------------------------
    def rnd(self, gen: torch.Generator, batch_shape=()) -> torch.Tensor:
        """Nearly uniform Montgomery elements (bias below 2^(-32 W)): 2W
        random 32-bit limbs from `gen`, drawn on gen's device, reduced as
        lo + hi 2^(32 W) mod p by one stacked product."""
        shape = (2 * self.W,) + tuple(batch_shape)
        wide = torch.randint(0, 1 << 32, shape, generator=gen,
                             dtype=torch.int64, device=gen.device)
        wide = lb.to32(wide).to(self.device)
        bs = tuple(batch_shape)
        r2 = lb.bcast(self.r2_limbs, len(shape)).expand((self.W,) + bs)
        lo, hi = self.mul_list([(wide[:self.W], self.one(bs)),
                                (wide[self.W:], r2)])
        return self.add(lo, hi)

    def __repr__(self):
        return f"Field({self.params.name}, W={self.W}, {self.device})"


_FIELD_CACHE: Dict[Tuple[FieldParams, torch.device], Field] = {}


def get_field(params: FieldParams, device="cuda") -> Field:
    """The `Field` of `params` on `device`, built once (field.py:569)."""
    key = (params, resolve_device(device))
    if key not in _FIELD_CACHE:
        _FIELD_CACHE[key] = Field(params, key[1])
    return _FIELD_CACHE[key]


def int_to_bits(e: int) -> np.ndarray:
    """Little-endian bits of a nonnegative int (at least one bit)."""
    if e < 0:
        raise ValueError("negative exponent")
    return np.array([(e >> i) & 1 for i in range(max(1, e.bit_length()))],
                    dtype=np.uint8)


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
