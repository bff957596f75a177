"""The KZG polynomial commitment on Python ints: the reference of the
port's protocols/kzg.py.  The scheme of the reference's examples/KZG.hs:
a trusted setup from a known tau, commitments to coefficients and to
values, an opening proof at x0, and its check by two pairings."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..params import CurveParams
from .curve import AffinePoint
from .groups import g1_group, g2_group
from .ntt import subgroup_gen
from .pairing import Pairing
from .poly import Poly


@dataclass
class KZGSetup:
    curve: CurveParams
    log2_size: int
    tau_g1: List[AffinePoint]            # [tau^i] G1, i < n
    lagrange_tau_g1: List[AffinePoint]   # [L_i(tau)] G1: the group iFFT of tau_g1
    g2: AffinePoint
    tau_g2: AffinePoint


def new_setup(curve: CurveParams, log2_size: int, tau: int) -> KZGSetup:
    """The setup of a known tau (for tests)."""
    g1, g2 = g1_group(curve), g2_group(curve)
    n, r = 1 << log2_size, curve.fr.p
    taus, acc = [], 1
    for _ in range(n):
        taus.append(acc)
        acc = acc * tau % r
    tau_g1 = [g1.scalar_mul(t, g1.gen) for t in taus]
    lagrange = g1.fft(subgroup_gen(curve.fr, log2_size), tau_g1, inverse=True)
    return KZGSetup(curve=curve, log2_size=log2_size, tau_g1=tau_g1,
                    lagrange_tau_g1=lagrange, g2=g2.gen,
                    tau_g2=g2.scalar_mul(tau, g2.gen))


def commit_poly(setup: KZGSetup, poly: Poly) -> AffinePoint:
    g1 = g1_group(setup.curve)
    coeffs = poly.coeffs
    if len(coeffs) > len(setup.tau_g1):
        raise ValueError("polynomial too large for the setup")
    return g1.msm(coeffs, setup.tau_g1[:len(coeffs)])


def commit_values(setup: KZGSetup, values: List[int]) -> AffinePoint:
    if len(values) != len(setup.lagrange_tau_g1):
        raise ValueError("one value per point of the Lagrange SRS")
    return g1_group(setup.curve).msm(values, setup.lagrange_tau_g1)


def opening_proof(setup: KZGSetup, poly: Poly, x0: int
                  ) -> Tuple[int, AffinePoint]:
    """(y0 = p(x0), the commitment to (p - y0) / (x - x0))."""
    y0 = poly.eval_at(x0)
    quot = poly.sub(Poly(setup.curve.fr.p, [y0])).quot_by_vanishing(1, x0)
    return y0, commit_poly(setup, quot)


def verify_proof(setup: KZGSetup, commitment: AffinePoint,
                 proof: AffinePoint, x0: int, y0: int) -> bool:
    """e(proof, [tau] G2) == e(commitment + [x0] proof - [y0] G1, G2)."""
    g1 = g1_group(setup.curve)
    pairing = Pairing(setup.curve)
    adj = g1.sub(g1.add(commitment, g1.scalar_mul(x0, proof)),
                 g1.scalar_mul(y0, g1.gen))
    return (pairing.pairing(proof, setup.tau_g2)
            == pairing.pairing(adj, setup.g2))
