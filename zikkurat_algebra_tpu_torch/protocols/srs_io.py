"""Saving and loading a KZG setup (the torch counterpart of
zikkurat_algebra_tpu/protocols/srs_io.py, in the port's own limb format).

A setup is one compressed .npz file: the affine coordinates as the
port's canonical Montgomery limbs (int32 (W, n) for G1, (W, 2, n) for
G2), the infinity flags, and a JSON header with the format, the curve,
log2 of the size and a sha256 digest over every array's name, shape and
bytes.  Loading checks the digest, so a corrupted or truncated file
raises instead of giving a wrong SRS.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from ..ops.field import resolve_device
from ..params import CURVES
from .kzg import KZGSetup

FORMAT = "zikkurat_algebra_tpu_torch/kzg-setup"
VERSION = 1
_POINTS = ("tau_g1", "lagrange_tau_g1", "g2", "tau_g2")
_ARRAY_KEYS = tuple(f"{p}_{c}" for p in _POINTS for c in ("x", "y", "inf"))


def _digest(arrays: dict) -> str:
    """sha256 over every array's name, shape and bytes, in key order."""
    h = hashlib.sha256()
    for k in _ARRAY_KEYS:
        a = np.ascontiguousarray(arrays[k])
        h.update(k.encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def save_setup(path, setup: KZGSetup) -> None:
    arrays = {f"{p}_{c}": t.detach().cpu().numpy()
              for p in _POINTS
              for c, t in zip(("x", "y", "inf"), getattr(setup, p))}
    meta = {"format": FORMAT, "version": VERSION, "curve": setup.curve.name,
            "log2_size": setup.log2_size, "sha256": _digest(arrays)}
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load_setup(path, device="cuda") -> KZGSetup:
    """The setup saved at `path`, on `device`; a file of another format,
    or whose digest does not match its arrays, raises ValueError."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("format") != FORMAT or meta.get("version") != VERSION:
            raise ValueError(f"{path}: format {meta.get('format')!r} version "
                             f"{meta.get('version')!r}, not {FORMAT!r} "
                             f"version {VERSION}")
        arrays = {k: z[k] for k in _ARRAY_KEYS}
    if _digest(arrays) != meta["sha256"]:
        raise ValueError("SRS file content digest mismatch (corrupted file?)")
    dev = resolve_device(device)
    pts = {p: tuple(torch.from_numpy(arrays[f"{p}_{c}"]).to(dev)
                    for c in ("x", "y", "inf")) for p in _POINTS}
    return KZGSetup(curve=CURVES[meta["curve"]], log2_size=meta["log2_size"],
                    **pts)
