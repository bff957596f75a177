"""The oracle G1 and G2 groups of a curve family."""

from __future__ import annotations

from functools import lru_cache

from ..params import CurveParams
from .curve import CurveGroup
from .ext import Fp2Field, Tower
from .field import Fp


@lru_cache(maxsize=None)
def tower(curve: CurveParams) -> Tower:
    """The oracle tower Fp2 / Fp6 / Fp12 of a curve family."""
    return Tower(curve)


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


@lru_cache(maxsize=None)
def fp2_field(curve: CurveParams) -> Fp2Field:
    return tower(curve).fp2


@lru_cache(maxsize=None)
def g2_group(curve: CurveParams) -> CurveGroup:
    """G2 on the twist y^2 = x^3 + b2 over Fp2 (curve.b2 must be set)."""
    f2 = fp2_field(curve)
    return CurveGroup(
        field=f2,
        a=f2.zero,
        b=f2.from_ints(*curve.b2),
        r=curve.fr.p,
        gen=(f2.from_ints(*curve.g2_gen[0]), f2.from_ints(*curve.g2_gen[1])),
        cofactor=curve.g2_cofactor,
    )
