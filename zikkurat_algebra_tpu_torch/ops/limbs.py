"""The port's limb format and its plain torch carry arithmetic.

A field element is W radix-2^32 limbs, least significant first, on the
FIRST axis: a tensor of shape (W, *batch).  The tensors are int32 and
carry the uint32 bit patterns of the limbs (a limb >= 2^31 reads as a
negative int32).  Montgomery form uses R = 2^(32 W); W = 12 for
BLS12-381 Fp and 8 for its Fr.  Values are canonical, in [0, p), at
every module boundary.

torch on the CPU has no uint32 `+` or `>>`, so the arithmetic here works
in int64 on the masked limbs.  Carries are resolved without a loop over
the limbs: after one column-wise add every carry (or borrow) is 0 or 1,
so the carry-ins follow from the generate and propagate bit masks of the
W columns as ((G << 1) + P) ^ P, one integer addition per element.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, Sequence, Union

import numpy as np
import torch

LIMB_BITS = 32
M32 = (1 << 32) - 1
I32 = torch.int32
I64 = torch.int64


def nwords(p: int) -> int:
    """Number of 32-bit limbs of an element of GF(p)."""
    return -(-p.bit_length() // LIMB_BITS)


# -- host conversions --------------------------------------------------------

def ints_to_limbs(values: Union[int, Sequence[int]], W: int) -> np.ndarray:
    """Python int(s) in [0, 2^(32W)) -> int32 limb planes, (W,) for one
    int or (W, N) for a sequence."""
    if isinstance(values, int):
        return ints_to_limbs([values], W)[:, 0]
    vals = list(values)
    buf = b"".join(v.to_bytes(4 * W, "little") for v in vals)
    words = np.frombuffer(buf, dtype="<u4").reshape(len(vals), W)
    return np.ascontiguousarray(words.T).view(np.int32)


def host_words(v: int, W: int):
    """v as W 32-bit words in host memory, least significant first: the
    field constants the kernels take as parameters (ctypes array)."""
    return (ctypes.c_uint32 * W)(*((v >> (32 * i)) & M32 for i in range(W)))


def limbs_to_ints(limbs) -> Union[int, List[int]]:
    """int32 limb planes (W,) or (W, *batch) -> Python int(s); a batch is
    flattened in C order."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    arr = np.asarray(limbs)
    W = arr.shape[0]
    one = arr.ndim == 1
    flat = arr.reshape(W, -1).astype(np.int64) & M32
    data = np.ascontiguousarray(flat.T.astype("<u4")).tobytes()
    out = [
        int.from_bytes(data[4 * W * i:4 * W * (i + 1)], "little")
        for i in range(flat.shape[1])
    ]
    return out[0] if one else out


# -- device helpers ----------------------------------------------------------

@lru_cache(maxsize=None)
def _shifts(W: int, device: str) -> torch.Tensor:
    return torch.arange(W, dtype=I64, device=device)


@lru_cache(maxsize=None)
def _weights(W: int, device: str) -> torch.Tensor:
    return torch.ones(W, dtype=I64, device=device) << _shifts(W, device)


@lru_cache(maxsize=None)
def _not_plus_one(W: int, device: str) -> torch.Tensor:
    """The columns M32, ..., M32 plus 1 at column 0: their value is
    2^(32 W), so x - y + this is x - y + 2^(32 W) with every column of
    x - y + this nonnegative for limbs x, y."""
    c = torch.zeros(W, dtype=I64, device=device)
    c[0] = 1
    return c + M32


def bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(W,) constant -> (W, 1, ..., 1) view broadcasting over ndim axes."""
    return v.view((v.shape[0],) + (1,) * (ndim - 1))


def to64(a: torch.Tensor) -> torch.Tensor:
    """int32 limb planes -> int64 planes holding the uint32 values."""
    return a.to(I64) & M32


def to32(x: torch.Tensor) -> torch.Tensor:
    """int64 planes with values in [0, 2^32) -> int32 bit patterns."""
    return ((x ^ 0x80000000) - 0x80000000).to(I32)


def carry_ins(gen: torch.Tensor, prop: torch.Tensor):
    """Carry-in bit of every column and the carry out of the top one,
    from the generate and propagate flags (W, *batch), W <= 60; the
    columns may be of any radix."""
    W = gen.shape[0]
    dev = str(gen.device)
    w = bcast(_weights(W, dev), gen.ndim)
    G = (gen * w).sum(0)
    P = (prop * w).sum(0)
    c = ((G << 1) + P) ^ P
    return (c.unsqueeze(0) >> bcast(_shifts(W, dev), gen.ndim)) & 1, \
        (c >> W) & 1


def add_carry(s: torch.Tensor):
    """Resolve int64 columns in [0, 2^33) into limbs in [0, 2^32).
    Returns (limbs, carry out in {0, 1})."""
    r = s & M32
    cin, cout = carry_ins(s >> 32, r == M32)
    return (r + cin) & M32, cout


def sub_borrow(d: torch.Tensor):
    """Resolve int64 columns in (-2^32, 2^32) into limbs in [0, 2^32).
    Returns (limbs of d mod 2^(32W), borrow out in {0, 1})."""
    r = d & M32
    bin_, bout = carry_ins(d < 0, r == 0)
    return (r - bin_) & M32, bout


def _carry_once(x: torch.Tensor) -> torch.Tensor:
    """Columns in [0, 3 * 2^32) -> columns in [0, 2^32 + 2) of the same
    value mod 2^(32 W) (each column's high part moved up one)."""
    hi = x >> 32
    return (x & M32) + torch.cat([torch.zeros_like(hi[:1]), hi[:-1]], 0)


# -- modular add / sub / neg on canonical values -----------------------------
#
# a + b and a - b each have two candidates, the plain value and the value
# corrected by p; both go through ONE carry resolution, stacked.

def add_mod(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for canonical a, b; p is the (W,) int64 modulus.
    Candidates a + b and a + b - p + 2^(32W); the second wraps past
    2^(32W) exactly when a + b >= p."""
    s = to64(a) + to64(b)                                   # [0, 2^33)
    d = s - bcast(p, a.ndim) + bcast(
        _not_plus_one(a.shape[0], str(a.device)), a.ndim)  # [0, 3 2^32)
    top = d[-1] >> 32
    limbs, cout = add_carry(torch.stack([s, _carry_once(d)], 1))
    wrap = (cout[1] + top).bool().unsqueeze(0)
    return to32(torch.where(wrap, limbs[:, 1], limbs[:, 0]))


def sub_mod(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for canonical a, b.  Candidates a + ~b + 1 (which
    wraps past 2^(32W) exactly when a >= b, to a - b) and that plus p."""
    x = to64(a) - to64(b) + bcast(_not_plus_one(a.shape[0], str(a.device)),
                                  a.ndim)                   # [0, 2^33)
    y = _carry_once(x + bcast(p, a.ndim))
    limbs, cout = add_carry(torch.stack([x, y], 1))
    return to32(torch.where(cout[0].bool().unsqueeze(0), limbs[:, 0],
                            limbs[:, 1]))


def neg_mod(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(-a) mod p for canonical a (0 stays 0)."""
    pb = bcast(p, a.ndim)
    d, _ = sub_borrow(pb - to64(a))
    zero = (a == 0).all(0, keepdim=True)
    return to32(d.masked_fill(zero, 0))


def cond_sub(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """x - p if x >= p else x, for int64 limb planes x < 2p (< 2^(32W)).
    Returns int64 limb planes."""
    d, bout = sub_borrow(x - bcast(p, x.ndim))
    return torch.where(bout.bool().unsqueeze(0), x, d)
