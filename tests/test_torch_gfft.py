"""The port's group FFT (ops/gfft.py) and windowed scalar multiplication
(`ProjCurveOps.scalar_mul_digits`) against the oracle, and the twiddle
digit planes against the JAX package's.

The points are [a_j] G for known a_j, so the FFT of the points is the
multiple of G by the oracle NTT of the a_j.  On the CPU every product
runs the plain version of kernel K1.
"""

import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu import params as JP
from zikkurat_algebra_tpu.ops.curve import get_curves
from zikkurat_algebra_tpu.ops.gfft import GroupFFT as JaxGroupFFT
from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.errors import DomainSizeError
from zikkurat_algebra_tpu_torch.ops.curve import CurveKernels
from zikkurat_algebra_tpu_torch.ops.gfft import (GroupFFT, get_group_fft,
                                                 to_digits)
from zikkurat_algebra_tpu_torch.oracle.ntt import intt, ntt

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)


def rand_ints(seed, r, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % r for _ in range(n)]


@pytest.fixture(scope="module")
def ck():
    return CurveKernels(P.BLS12_381, device="cpu")


def test_to_digits_vs_jax():
    """MSB-first 4-bit digit planes equal the JAX GroupFFT's."""
    jg = JaxGroupFFT(get_curves(JP.BLS12_381).g1, JP.BLS12_381_FR, 1)
    r = JP.BLS12_381_FR.p
    vals = rand_ints(1, r, 9) + [0, 1, r - 1]
    got = to_digits(vals, r.bit_length())
    assert got.shape == (64, 12)
    assert np.array_equal(got, np.asarray(jg._to_digits(vals)))


def test_scalar_mul_digits_vs_oracle(ck):
    """[k] P over G2 (the table axis after both coordinate axes) with
    16-bit scalars (4 digits), the zero scalar and the point at infinity
    included; G1 runs it in the group FFT test."""
    ks = [0, 1, 15, 16, 0xBEEF, 0xFFFF]
    og = ck.oracle_g2
    pts = [og.scalar_mul(a, og.gen) for a in rand_ints(2, og.r, 6)]
    pts[2] = None
    d = torch.from_numpy(to_digits(ks, 16))
    R = ck.g2.scalar_mul_digits(d, ck.g2.from_affine(ck.encode_g2(pts)))
    assert ck.decode_g2(ck.g2.to_affine(R)) == [og.scalar_mul(k, p)
                                                for k, p in zip(ks, pts)]


def test_group_fft_vs_oracle():
    """fft and ifft of [a_j] G at m = 2 are [ntt(a)_k] G and
    [intt(a)_k] G.  BN128 G1 (8-limb coordinates) keeps the CPU time
    down; chip_smoke.py runs BLS12-381 G1 at 2^14 on the card."""
    ck = CurveKernels(P.BN128, device="cpu")
    og = ck.oracle_g1
    a = rand_ints(3, og.r, 4)
    P_ = ck.g1.from_affine(ck.encode_g1([og.scalar_mul(x, og.gen)
                                         for x in a]))
    g = get_group_fft(ck.g1, P.BN128_FR, 2)
    assert get_group_fft(ck.g1, P.BN128_FR, 2) is g
    got = ck.decode_g1(ck.g1.to_affine(g.fft(P_)))
    assert got == [og.scalar_mul(v, og.gen) for v in ntt(og.r, g.gen, a)]
    got = ck.decode_g1(ck.g1.to_affine(g.ifft(P_)))
    assert got == [og.scalar_mul(v, og.gen) for v in intt(og.r, g.gen, a)]
    with pytest.raises(DomainSizeError):
        g.fft(tuple(c[:, :2] for c in P_))
    with pytest.raises(DomainSizeError):
        GroupFFT(ck.g1, P.BN128_FR, 29)              # 2-adicity is 28
