"""The oracle G1 group of a curve family."""

from __future__ import annotations

from functools import lru_cache

from ..params import CurveParams
from .curve import CurveGroup
from .field import Fp


@lru_cache(maxsize=None)
def g1_group(curve: CurveParams) -> CurveGroup:
    return CurveGroup(
        field=Fp(curve.fp),
        a=curve.a % curve.fp.p,
        b=curve.b % curve.fp.p,
        r=curve.fr.p,
        gen=curve.g1_gen,
        cofactor=curve.cofactor,
    )
