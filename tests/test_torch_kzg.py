"""The port's KZG commitment (protocols/kzg.py) and SRS files
(protocols/srs_io.py) against the JAX package and the oracle.

A setup made by the JAX `new_setup` (BN128, 2^3 points, the JAX test's
own size) is carried into the port by `utils/convert.kzg_setup_from_jax`;
on it the port's commitments and opening equal the JAX package's and the
oracle's, and the port's check accepts the honest proof, as the oracle's
does, and rejects a wrong value.  The JAX `verify_proof` is not run: its
pairing product alone compiles for about a minute on XLA:CPU.  The
port's own `new_setup` equals the oracle's by both Lagrange routes.  On
the CPU every product runs the plain version of kernel K1.
"""

import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu import params as JP
from zikkurat_algebra_tpu.ops.curve import get_curves as jax_get_curves
from zikkurat_algebra_tpu.protocols import kzg as jkzg
from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.oracle import kzg as okzg
from zikkurat_algebra_tpu_torch.oracle.poly import Poly
from zikkurat_algebra_tpu_torch.ops.curve import get_curves
from zikkurat_algebra_tpu_torch.protocols import kzg, srs_io
from zikkurat_algebra_tpu_torch.utils import convert

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)

LOG2 = 3
TAU = 0x0D2B4A7E9C3F5D6B8A0C2E4F6A8B0C1D3E5F7A9B1C3D5E7F9A1B3C5D7E9F1A


def rand_fr(rng, r, n):
    return [int.from_bytes(rng.bytes(40), "little") % r for _ in range(n)]


@pytest.fixture(scope="module")
def osetup():
    return okzg.new_setup(P.BN128, LOG2, TAU)


def test_kzg_on_jax_setup(osetup):
    """commit_poly, commit_values and opening_proof equal the JAX
    package's and the oracle's; verify_proof accepts the honest proof
    (as the oracle does) and rejects y0 + 1."""
    jsetup = jkzg.new_setup(JP.BN128, LOG2, TAU)
    setup = convert.kzg_setup_from_jax(jsetup, device="cpu")
    ck = get_curves(P.BN128, device="cpu")
    fr, dec = ck.fr, lambda pt: ck.decode_g1(ck.g1.to_affine(pt))
    jck = jax_get_curves(JP.BN128)
    jdec = lambda pt: jck.decode_g1(jck.g1.to_affine(pt))
    assert ck.decode_g1(setup.tau_g1) == osetup.tau_g1
    assert ck.decode_g1(setup.lagrange_tau_g1) == osetup.lagrange_tau_g1
    assert ck.decode_g2(setup.g2) == [osetup.g2]
    assert ck.decode_g2(setup.tau_g2) == [osetup.tau_g2]

    rng = np.random.default_rng(21)
    n = 1 << LOG2
    coeffs, values = rand_fr(rng, fr.p, n), rand_fr(rng, fr.p, n)
    x0 = rand_fr(rng, fr.p, 1)[0]
    cm, jcm = fr.encode(coeffs), jck.fr.encode(coeffs)
    com = kzg.commit_poly(setup, cm)
    assert dec(com) == jdec(jkzg.commit_poly(jsetup, jcm)) == \
        okzg.commit_poly(osetup, Poly(fr.p, coeffs))
    assert dec(kzg.commit_values(setup, fr.encode(values))) == jdec(
        jkzg.commit_values(jsetup, jck.fr.encode(values))) == \
        okzg.commit_values(osetup, values)

    y0, proof = kzg.opening_proof(setup, cm, fr.encode(x0))
    jy0, jproof = jkzg.opening_proof(jsetup, jcm, jck.fr.encode(x0))
    oy0, oproof = okzg.opening_proof(osetup, Poly(fr.p, coeffs), x0)
    assert fr.decode(y0) == jck.fr.decode(jy0) == oy0
    assert dec(proof) == jdec(jproof) == oproof

    assert bool(kzg.verify_proof(setup, com, proof, fr.encode(x0), y0))
    assert okzg.verify_proof(osetup, dec(com), oproof, x0, oy0)
    assert not bool(kzg.verify_proof(setup, com, proof, fr.encode(x0),
                                     fr.encode(oy0 + 1)))


@pytest.mark.parametrize("use_group_fft", [False, True],
                         ids=["scalar", "group_ifft"])
def test_new_setup_vs_oracle(osetup, use_group_fft):
    """The port's own setup, with the Lagrange SRS by its scalars or by
    the group iFFT of tau_g1, equals the oracle's."""
    ck = get_curves(P.BN128, device="cpu")
    s = kzg.new_setup(P.BN128, LOG2, TAU, use_group_fft=use_group_fft,
                      device="cpu")
    assert s.device == torch.device("cpu")
    assert ck.decode_g1(s.tau_g1) == osetup.tau_g1
    assert ck.decode_g1(s.lagrange_tau_g1) == osetup.lagrange_tau_g1
    assert ck.decode_g2(s.g2) == [osetup.g2]
    assert ck.decode_g2(s.tau_g2) == [osetup.tau_g2]


def test_srs_roundtrip_and_corruption(osetup, tmp_path):
    """save_setup / load_setup give back every array (of the oracle's
    setup, encoded); a changed limb or another format raises."""
    ck = get_curves(P.BN128, device="cpu")
    setup = kzg.KZGSetup(
        curve=P.BN128, log2_size=LOG2, tau_g1=ck.encode_g1(osetup.tau_g1),
        lagrange_tau_g1=ck.encode_g1(osetup.lagrange_tau_g1),
        g2=ck.encode_g2([osetup.g2]), tau_g2=ck.encode_g2([osetup.tau_g2]))
    path = tmp_path / "srs.npz"
    srs_io.save_setup(path, setup)
    back = srs_io.load_setup(path, device="cpu")
    assert back.curve is P.BN128 and back.log2_size == LOG2
    for name in ("tau_g1", "lagrange_tau_g1", "g2", "tau_g2"):
        for a, b in zip(getattr(setup, name), getattr(back, name)):
            assert torch.equal(a, b)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["lagrange_tau_g1_x"] = arrays["lagrange_tau_g1_x"].copy()
    arrays["lagrange_tau_g1_x"][0, 3] ^= 1
    bad = tmp_path / "bad.npz"
    np.savez_compressed(bad, **arrays)
    with pytest.raises(ValueError, match="digest"):
        srs_io.load_setup(bad, device="cpu")
    arrays = {k: v for k, v in arrays.items() if k != "meta"}
    other = tmp_path / "other.npz"
    np.savez_compressed(other, meta='{"version": 2}', **arrays)
    with pytest.raises(ValueError, match="format"):
        srs_io.load_setup(other, device="cpu")
