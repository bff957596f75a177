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
    sh = bcast(_shifts(W, str(gen.device)), gen.ndim)
    G = (gen.to(I64) << sh).sum(0)
    P = (prop.to(I64) << sh).sum(0)
    c = ((G << 1) + P) ^ P
    return (c.unsqueeze(0) >> sh) & 1, (c >> W) & 1


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


# -- modular add / sub / neg on canonical values -----------------------------

def add_mod(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for canonical a, b; p is the (W,) int64 modulus."""
    pb = bcast(p, a.ndim)
    s, cout = add_carry(to64(a) + to64(b))
    d, bout = sub_borrow(s - pb)
    keep_d = (cout | (1 - bout)).bool().unsqueeze(0)
    return to32(torch.where(keep_d, d, s))


def sub_mod(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for canonical a, b."""
    pb = bcast(p, a.ndim)
    d, bout = sub_borrow(to64(a) - to64(b))
    s, _ = add_carry(d + pb)
    return to32(torch.where(bout.bool().unsqueeze(0), s, d))


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
