"""Carrying the JAX package's data across to the port, and back.

The JAX package stores a field element as L signed radix-2^15 limbs
(L = ceil(bits / 15) + 2), possibly lazy (any value congruent mod p), in
Montgomery form with R' = 2^(15 L).  The port stores W radix-2^32 limbs,
canonical, with R = 2^(32 W).  These functions go through the integer
value: they remove one Montgomery factor and apply the other.  They work
on numpy arrays, so both packages can read what they return.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops import limbs as lb

LB15 = 15


def nlimbs15(p: int) -> int:
    """Limb count of the JAX package's radix-2^15 format for GF(p)."""
    return -(-p.bit_length() // LB15) + 2


def limbs15_to_ints(planes) -> List[int]:
    """(L, N) signed radix-2^15 limb planes -> the N integer values."""
    arr = np.asarray(planes).astype(np.int64)
    L = arr.shape[0]
    flat = arr.reshape(L, -1)
    return [
        sum(int(flat[k, i]) << (LB15 * k) for k in range(L))
        for i in range(flat.shape[1])
    ]


def ints_to_limbs15(values: Sequence[int], L: int) -> np.ndarray:
    """Nonnegative ints < 2^(15 L) -> (L, N) int32 radix-2^15 planes."""
    mask = (1 << LB15) - 1
    out = np.empty((L, len(values)), np.int32)
    for i, v in enumerate(values):
        for k in range(L):
            out[k, i] = (v >> (LB15 * k)) & mask
    return out


def from_jax_limbs15(planes, field, mont: bool = True) -> np.ndarray:
    """JAX (L, N) planes of GF(p) -> the port's (W, N) int32 limbs of the
    same field element; `mont` says both are in Montgomery form."""
    p = field.p
    vals = [v % p for v in limbs15_to_ints(planes)]
    if mont:
        r15_inv = pow(1 << (LB15 * np.asarray(planes).shape[0]), -1, p)
        vals = [v * r15_inv % p * field.R % p for v in vals]
    return lb.ints_to_limbs(vals, field.W)


def to_jax_limbs15(limbs, field, mont: bool = True) -> np.ndarray:
    """The port's (W, N) limbs -> canonical JAX (L, N) radix-2^15 planes."""
    p = field.p
    vals = lb.limbs_to_ints(limbs)
    if isinstance(vals, int):
        vals = [vals]
    L = nlimbs15(p)
    if mont:
        r15 = 1 << (LB15 * L)
        vals = [v * field.R_inv % p * r15 % p for v in vals]
    return ints_to_limbs15(vals, L)


def load_jax_seed_points(npz_path, fp):
    """A `bench_data/seeds_*_g1.npz` file of the JAX package (x and y as
    (L, N) Montgomery planes, inf as (N,) bool) -> port G1 affine points
    (x, y, inf) as tensors on `fp.device`."""
    with np.load(npz_path) as z:
        x, y, inf = z["x"], z["y"], z["inf"]
    dev = fp.device
    return (torch.from_numpy(from_jax_limbs15(x, fp)).to(dev),
            torch.from_numpy(from_jax_limbs15(y, fp)).to(dev),
            torch.from_numpy(inf.astype(bool)).to(dev))
