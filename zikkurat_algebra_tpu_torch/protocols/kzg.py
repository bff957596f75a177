"""The KZG polynomial commitment on the port's kernels.

The torch counterpart of zikkurat_algebra_tpu/protocols/kzg.py (the
scheme of the reference's examples/KZG.hs): the powers of tau by a
log-depth prefix product, [tau^i] G1 by one batched scalar
multiplication, the Lagrange-basis SRS by a second one (or by the group
iFFT), commitments by the G1 Pippenger MSM (kernels K1, K2, K3), the
opening by `PolyOps` and the check by ONE two-pair `pairing_product`.
Field elements are Montgomery limbs of Fr: x0, y0 (W,), coefficients
and values (W, n).  The device is the setup's: `new_setup` puts it on
the card unless the caller asks for the CPU.  Spans (`utils.profiling`):
`kzg.commit`, `kzg.open`, `kzg.verify`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..oracle.ntt import subgroup_gen
from ..ops import vector as V
from ..ops.curve import AffBatch, CurveKernels, Point, get_curves
from ..ops.gfft import get_group_fft
from ..ops.pairing import get_pairing
from ..ops.poly import get_poly_ops
from ..params import CurveParams
from ..utils import profiling as prof


@dataclass
class KZGSetup:
    curve: CurveParams
    log2_size: int
    tau_g1: AffBatch            # [tau^i] G1, i < n, affine (x, y (W, n), inf)
    lagrange_tau_g1: AffBatch   # [L_i(tau)] G1: the group iFFT of tau_g1
    g2: AffBatch                # the G2 generator, a batch of 1
    tau_g2: AffBatch            # [tau] G2, a batch of 1

    @property
    def device(self) -> torch.device:
        return self.tau_g1[0].device


def _curves(setup: KZGSetup) -> CurveKernels:
    return get_curves(setup.curve, setup.device)


def new_setup(curve: CurveParams, log2_size: int, tau: int,
              use_group_fft: bool = False, device="cuda") -> KZGSetup:
    """The setup of a known tau (tests and benchmarks; kzg.py:39).

    The Lagrange SRS [L_j(tau)] G1: with tau known, the group iFFT of
    tau_g1 collapses to scalars, L_j(tau) = (tau^n - 1) / (n (tau w^-j - 1)),
    so it joins [tau^i] G1 in one batched scalar multiplication of 2n
    points; `use_group_fft=True`
    takes the general route, `GroupFFT.ifft` of tau_g1 (the one a
    ceremony's output needs)."""
    ck = get_curves(curve, device)
    fr, g1 = ck.fr, ck.g1
    n = 1 << log2_size
    taus = V.powers(fr, fr.one(()), fr.encode(tau), n)        # (W, n)
    if use_group_fft:
        G = ck.generator(n)
        tau_g1 = g1.to_affine(g1.scalar_mul_fr_std(fr.from_mont(taus), G))
        lagrange = g1.to_affine(get_group_fft(g1, curve.fr, log2_size).ifft(
            g1.from_affine(tau_g1)))
    else:
        w_inv = pow(subgroup_gen(curve.fr, log2_size), -1, fr.p)
        t_wj = V.powers(fr, fr.encode(tau), fr.encode(w_inv), n)  # tau w^-j
        denom = fr.mul(fr.const(n, (n,)), fr.sub(t_wj, fr.one((n,))))
        num = fr.const(pow(tau, n, fr.p) - 1, (n,))
        coeffs = fr.mul(num, fr.batch_inv(denom))
        # [tau^i] G and [L_i(tau)] G as ONE scalar multiplication of 2n
        both = g1.to_affine(g1.scalar_mul_fr_std(
            fr.from_mont(torch.cat([taus, coeffs], 1)),
            ck.generator(2 * n)))
        tau_g1, lagrange = (tuple(c[..., h * n:(h + 1) * n].contiguous()
                                  for c in both) for h in range(2))
    g2 = ck.encode_g2([ck.oracle_g2.gen])
    tau_g2 = ck.g2.scalar_mul_fr_std(fr.encode([tau], mont=False),
                                     ck.g2.from_affine(g2))
    return KZGSetup(curve=curve, log2_size=log2_size, tau_g1=tau_g1,
                    lagrange_tau_g1=lagrange, g2=g2,
                    tau_g2=ck.g2.to_affine(tau_g2))


def _msm(setup: KZGSetup, k_mont: torch.Tensor, points: AffBatch) -> Point:
    """The G1 MSM, its block the smaller of 512 and n rounded up to a
    power of two (a block longer than n only scans padding)."""
    n = k_mont.shape[-1]
    block = min(512, 1 << max(0, n - 1).bit_length())
    return _curves(setup).msm("g1").msm_mont(k_mont, points, block=block)


def commit_poly(setup: KZGSetup, coeffs_mont: torch.Tensor) -> Point:
    """The commitment to coefficients (W, n'), n' <= n: the MSM over the
    first n' points of tau_g1 (kzg.py:104)."""
    n = coeffs_mont.shape[-1]
    if n > setup.tau_g1[0].shape[-1]:
        raise ValueError(f"{n} coefficients for a setup of "
                         f"{setup.tau_g1[0].shape[-1]} points")
    with prof.span("kzg.commit", coeffs_mont):
        return _msm(setup, coeffs_mont,
                    tuple(t[..., :n].contiguous() for t in setup.tau_g1))


def commit_values(setup: KZGSetup, values_mont: torch.Tensor) -> Point:
    """The commitment to the values on the domain (W, n): the MSM over the
    Lagrange SRS (kzg.py:112)."""
    with prof.span("kzg.commit", values_mont):
        return _msm(setup, values_mont, setup.lagrange_tau_g1)


def opening_proof(setup: KZGSetup, coeffs_mont: torch.Tensor,
                  x0: torch.Tensor) -> Tuple[torch.Tensor, Point]:
    """(y0 = p(x0), the commitment to (p - y0) / (x - x0)) for a point
    x0 (W,) (kzg.py:118)."""
    fr = _curves(setup).fr
    po = get_poly_ops(fr)
    with prof.span("kzg.open", coeffs_mont):
        y0 = po.eval_at(x0, coeffs_mont)
        shifted = coeffs_mont.clone()
        shifted[..., 0] = fr.sub(coeffs_mont[..., 0], y0)
        quot, _ = po.quot_by_vanishing(shifted, 1, x0)  # exact by construction
        return y0, commit_poly(setup, quot)


def verify_proof(setup: KZGSetup, commitment: Point, proof: Point,
                 x0: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """e(proof, [tau] G2) == e(commitment + [x0] proof - [y0] G1, G2) as
    ONE product e(proof, [tau] G2) e(-adj, G2) == 1 with one final
    exponentiation (kzg.py:132).  [x0] proof and [y0] G1 are one batched
    scalar multiplication.  Returns a bool tensor."""
    ck = _curves(setup)
    fr, g1 = ck.fr, ck.g1
    pk = get_pairing(setup.curve, setup.device)
    with prof.span("kzg.verify", x0):
        one = tuple(c.reshape(c.shape + (1,)) for c in proof)
        pts = tuple(torch.cat([a, b], -1)
                    for a, b in zip(one, ck.generator(1)))
        k = fr.from_mont(torch.stack([x0, y0], 1))
        m = g1.scalar_mul_fr_std(k, pts)
        x0q, y0g = (tuple(c[..., i] for c in m) for i in range(2))
        adj = g1.sub(g1.add(commitment, x0q), y0g)
        P = g1.to_affine(tuple(torch.stack([a, b], -1)
                               for a, b in zip(proof, g1.neg(adj))))
        Q = tuple(torch.cat([a, b], -1)
                  for a, b in zip(setup.tau_g2, setup.g2))
        f12 = pk.tower.fp12
        return f12.eq(pk.pairing_product(P, Q), f12.one(()))
