"""Carrying the JAX package's data across to the port, and back.

The JAX package stores a field element as L signed radix-2^15 limbs
(L = ceil(bits / 15) + 2), possibly lazy (any value congruent mod p), in
Montgomery form with R' = 2^(15 L).  The port stores W radix-2^32 limbs,
canonical, with R = 2^(32 W).  These functions go through the integer
value: they remove one Montgomery factor and apply the other.  They keep
every axis after the limb axis, so an Fp2 batch, JAX (L, 2, N), becomes
the port's (W, 2, N) and back, and an Fp6 or Fp12 batch, JAX
(L, 3, 2, N) or (L, 2, 3, 2, N), the port's (W, 3, 2, N) or
(W, 2, 3, 2, N).  They work on numpy arrays, so both packages can read
what they return.  A KZG setup of the JAX package becomes the port's by
`kzg_setup_from_jax`.  A JAX `BigInt` holds exact 16-bit limbs in uint32
planes (L = bits / 16, *batch); `from_jax_bigint` and `to_jax_bigint`
pair them into the port's 32-bit limbs and back.  `shard_numpy` gives a
rank its chunk of a global numpy array without moving the rest.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops import limbs as lb
from ..ops.curve import get_curves
from ..parallel.mesh import Mesh, shard_batch
from ..params import CURVES
from ..protocols.kzg import KZGSetup

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
    """JAX (L, *batch) planes of GF(p) -> the port's (W, *batch) int32
    limbs of the same field elements; `mont` says both are in Montgomery
    form."""
    planes = np.asarray(planes)
    p = field.p
    vals = [v % p for v in limbs15_to_ints(planes)]
    if mont:
        r15_inv = pow(1 << (LB15 * planes.shape[0]), -1, p)
        vals = [v * r15_inv % p * field.R % p for v in vals]
    return lb.ints_to_limbs(vals, field.W).reshape(
        (field.W,) + planes.shape[1:])


def to_jax_limbs15(limbs, field, mont: bool = True) -> np.ndarray:
    """The port's (W, *batch) limbs -> canonical JAX (L, *batch) radix-2^15
    planes."""
    p = field.p
    batch = tuple(limbs.shape[1:])
    vals = lb.limbs_to_ints(limbs)
    if isinstance(vals, int):
        vals, batch = [vals], (1,)
    L = nlimbs15(p)
    if mont:
        r15 = 1 << (LB15 * L)
        vals = [v * field.R_inv % p * r15 % p for v in vals]
    return ints_to_limbs15(vals, L).reshape((L,) + batch)


TOWER_SHAPES = {"fp": (), "fp2": (2,), "fp6": (3, 2), "fp12": (2, 3, 2)}


def _check_level(shape, level: str):
    want = TOWER_SHAPES[level]
    if tuple(shape[1:1 + len(want)]) != want:
        raise ValueError(f"{level} planes need component axes {want} after "
                         f"the limb axis, got shape {tuple(shape)}")


def from_jax_tower(planes, fp, level: str) -> np.ndarray:
    """JAX (L, *components, *batch) planes of a tower level ("fp2",
    "fp6" or "fp12", Montgomery form) -> the port's (W, *components,
    *batch) limbs of the same elements; `fp` is the port's base field."""
    planes = np.asarray(planes)
    _check_level(planes.shape, level)
    return from_jax_limbs15(planes, fp)


def to_jax_tower(limbs, fp, level: str) -> np.ndarray:
    """The port's (W, *components, *batch) limbs of a tower level ->
    canonical JAX (L, *components, *batch) radix-2^15 planes."""
    limbs = np.asarray(limbs.detach().cpu() if isinstance(limbs, torch.Tensor)
                       else limbs)
    _check_level(limbs.shape, level)
    return to_jax_limbs15(limbs, fp)


def kzg_setup_from_jax(jsetup, device="cuda"):
    """A KZG setup of the JAX package (the `KZGSetup` of its
    protocols/kzg.py: affine (x, y, inf) batches of Montgomery planes) -> the
    port's `KZGSetup` on `device`, with the port's curve of the same
    name.  Only attributes and `numpy.asarray` are used, so the port
    needs no JAX for it."""
    curve = CURVES[jsetup.curve.name]
    fp = get_curves(curve, device).fp

    def points(aff):
        x, y, inf = (np.asarray(t) for t in aff)
        return tuple(torch.from_numpy(a).to(fp.device) for a in (
            from_jax_limbs15(x, fp), from_jax_limbs15(y, fp),
            inf.astype(bool)))

    return KZGSetup(curve=curve, log2_size=jsetup.log2_size,
                    tau_g1=points(jsetup.tau_g1),
                    lagrange_tau_g1=points(jsetup.lagrange_tau_g1),
                    g2=points(jsetup.g2), tau_g2=points(jsetup.tau_g2))


def load_jax_seed_points(npz_path, fp):
    """A `bench_data/seeds_*_g1.npz` or `seeds_*_g2.npz` file of the JAX
    package (x and y as (L, N) or, for G2, (L, 2, N) Montgomery planes;
    inf as (N,) bool) -> port affine points (x, y, inf) as tensors on
    `fp.device`, x and y (W, N) or (W, 2, N)."""
    with np.load(npz_path) as z:
        x, y, inf = z["x"], z["y"], z["inf"]
    dev = fp.device
    return (torch.from_numpy(from_jax_limbs15(x, fp)).to(dev),
            torch.from_numpy(from_jax_limbs15(y, fp)).to(dev),
            torch.from_numpy(inf.astype(bool)).to(dev))


def from_jax_bigint(planes) -> np.ndarray:
    """JAX BigInt planes (L, *batch), 16-bit limbs in uint32, L even ->
    the port's (L / 2, *batch) int32 limbs of the same integers."""
    d = np.asarray(planes).astype(np.uint32)
    d = d.reshape((d.shape[0] // 2, 2) + d.shape[1:])
    return (d[:, 0] | (d[:, 1] << np.uint32(16))).view(np.int32)


def to_jax_bigint(limbs) -> np.ndarray:
    """The port's (W, *batch) limbs -> JAX BigInt planes (2W, *batch) of
    16-bit limbs in uint32."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    u = np.asarray(limbs).view(np.uint32)
    d = np.stack([u & np.uint32(0xFFFF), u >> np.uint32(16)], 1)
    return d.reshape((2 * u.shape[0],) + u.shape[1:])


def shard_numpy(mesh: Mesh, arr, batch_axis: int = -1) -> torch.Tensor:
    """This rank's chunk of a global numpy array along batch_axis, as a
    tensor on the rank's device (`parallel.mesh.shard_batch`; only the
    chunk is copied)."""
    return shard_batch(mesh, torch.from_numpy(np.ascontiguousarray(arr)),
                       batch_axis)
