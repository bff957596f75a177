"""The per-curve API: everything for one pairing-friendly curve family on
one device (the torch counterpart of zikkurat_algebra_tpu/api.py).

    from zikkurat_algebra_tpu_torch.api import bn128, bls12_381

    f = bls12_381().fr                 # batched Montgomery field (K1)
    P = bls12_381().g1                 # complete-formula projective group
    r = bls12_381().msm_g1.msm_mont(coeffs, points)     # K1, K2, K3
    e = bls12_381().pairing.pairing(Pa, Qa)

Every constructor takes `device`, "cuda" unless the caller asks for the
CPU; the objects are cached per (curve, device).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import params as P
from .ops.bigint import bigint
from .ops.curve import CurveKernels, get_curves
from .ops.field import Field, get_field, resolve_device
from .ops.gfft import GroupFFT, get_group_fft
from .ops.msm import CurveMSM
from .ops.ntt import NTTDomain, get_domain
from .ops.pairing import PairingKernels, get_pairing
from .ops.poly import get_poly_ops
from .ops.tower import TowerKernels


class CurveAPI:
    """Fields, tower, groups, MSMs, NTT domains, group FFTs and the
    pairing of one curve family on one device.  A family without G2
    (BLS12-377) raises `UnsupportedError` from `msm_g2`, `pairing` and
    `group_fft(grp="g2")`."""

    def __init__(self, curve: P.CurveParams, device="cuda"):
        self.params = curve
        self.curves: CurveKernels = get_curves(curve, device)
        self.device = self.curves.device
        self.tower: TowerKernels = self.curves.tower
        self.fr: Field = self.tower.fr
        self.fp: Field = self.tower.fp
        self.fp2 = self.tower.fp2
        self.fp6 = self.tower.fp6
        self.fp12 = self.tower.fp12
        self.g1 = self.curves.g1
        self.g2 = self.curves.g2
        self.poly = get_poly_ops(self.fr)

    # heavier kernels, built on first use
    @property
    def msm_g1(self) -> CurveMSM:
        return self.curves.msm("g1")

    @property
    def msm_g2(self) -> CurveMSM:
        return self.curves.msm("g2")

    @property
    def pairing(self) -> PairingKernels:
        return get_pairing(self.params, self.device)

    def ntt_domain(self, log2_size: int) -> NTTDomain:
        """The Fr evaluation domain of 2^log2_size."""
        return get_domain(self.fr, log2_size)

    def group_fft(self, log2_size: int, grp: str = "g1") -> GroupFFT:
        ops = self.curves._group(grp)[0]
        return get_group_fft(ops, self.params.fr, log2_size)

    # encode / decode and compressed points, passed through
    def encode_g1(self, pts):
        return self.curves.encode_g1(pts)

    def decode_g1(self, aff):
        return self.curves.decode_g1(aff)

    def encode_g2(self, pts):
        return self.curves.encode_g2(pts)

    def decode_g2(self, aff):
        return self.curves.decode_g2(aff)

    def compress_g1(self, aff):
        return self.curves.compress_g1(aff)

    def decompress_g1(self, x, flags):
        return self.curves.decompress_g1(x, flags)

    def g1_to_bytes48(self, aff):
        return self.curves.g1_to_bytes48(aff)

    def g1_from_bytes48(self, data):
        return self.curves.g1_from_bytes48(data)

    def compress_g2(self, aff):
        return self.curves.compress_g2(aff)

    def decompress_g2(self, x, flags):
        return self.curves.decompress_g2(x, flags)

    def __repr__(self):
        return f"CurveAPI({self.params.name}, {self.device})"


_API_CACHE: Dict[Tuple[str, torch.device], CurveAPI] = {}


def curve_api(name: str, device="cuda") -> CurveAPI:
    """The `CurveAPI` of the family named `name` ("BN128", "BLS12-381",
    "BLS12-377") on `device`, built once."""
    key = (name, resolve_device(device))
    if key not in _API_CACHE:
        _API_CACHE[key] = CurveAPI(P.CURVES[name], key[1])
    return _API_CACHE[key]


def bn128(device="cuda") -> CurveAPI:
    return curve_api(P.BN128.name, device)


def bls12_381(device="cuda") -> CurveAPI:
    return curve_api(P.BLS12_381.name, device)


__all__ = [
    "CurveAPI", "bn128", "bls12_381", "curve_api", "bigint",
    "get_field", "get_domain",
]
