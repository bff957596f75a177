"""The port's curve extras (zikkurat_algebra_tpu_torch.ops.curve: eq, sub,
the host-scalar and per-element scalar multiplications, the subgroup
tests with GLV, cofactor clearing, random points, point compression, the
digit helpers; ops.tower.TowerKernels.fp2_sqrt) against the JAX package
and the pure-int oracle.

Points are compared as points (after `to_affine`, decoded) or as flags;
compressed x as the integer it encodes (the two packages keep different
limbs).  Scalars stay short where the check allows: a G2 scalar
multiplication by r on the CPU costs seconds.  On the CPU every product
runs the plain version of kernel K1.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu import params as JP
from zikkurat_algebra_tpu.ops import curve as jax_curve
from zikkurat_algebra_tpu.ops.curve import get_curves as jax_get_curves
from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.ops.curve import (CurveKernels, get_curves,
                                                  int_to_digits_msb,
                                                  limbs_to_bits,
                                                  limbs_to_digits_msb)
from zikkurat_algebra_tpu_torch.utils.convert import from_jax_limbs15

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)

CURVES = [(P.BLS12_381, JP.BLS12_381), (P.BN128, JP.BN128)]


@pytest.fixture(params=CURVES, ids=lambda c: c[0].name)
def curves(request):
    port, jax_params = request.param
    return get_curves(port, "cpu"), jax_get_curves(jax_params)


def group(ck, grp):
    if grp == "g1":
        return ck.g1, ck.oracle_g1, ck.encode_g1, ck.decode_g1
    return ck.g2, ck.oracle_g2, ck.encode_g2, ck.decode_g2


def outside_points(og, k, seed):
    """k curve points outside the r-subgroup (none exist for cofactor 1)."""
    f, r, out = og.f, random.Random(seed), []
    while len(out) < k:
        x = (r.randrange(f.p) if isinstance(og.b, int)
             else (r.randrange(f.p), r.randrange(f.p)))
        y = f.sqrt(f.add(f.mul(f.mul(x, x), x), og.b))
        if y is not None and og.scalar_mul_unreduced(og.r, (x, y)) is not None:
            out.append((x, y))
    return out


def test_eq_sub_vs_oracle(curves):
    ck, jck = curves
    ops, og = ck.g1, ck.oracle_g1
    r = random.Random(1)
    ps = [og.rnd(r) for _ in range(3)] + [None, None]
    qs = [ps[0], og.rnd(r), None, ps[1], None]
    A, B = ops.from_affine(ck.encode_g1(ps)), ops.from_affine(ck.encode_g1(qs))
    # the same points in other projective coordinates: (5X : 5Y : 5Z)
    A5 = tuple(ck.fp.scale_small(c, 5) for c in A)
    want = [p == q for p, q in zip(ps, qs)]
    assert ops.eq(A, B).tolist() == want
    assert ops.eq(A5, A).tolist() == [True] * 5
    jA = jck.g1.from_affine(jck.encode_g1(ps))
    jB = jck.g1.from_affine(jck.encode_g1(qs))
    assert np.asarray(jck.g1.eq(jA, jB)).tolist() == want
    got = ck.decode_g1(ops.to_affine(ops.sub(A, B)))
    assert got == [og.sub(p, q) for p, q in zip(ps, qs)]
    assert bool(ops.is_inf(ops.sub(A5, A)).all())


def test_scalar_mul_bits_and_static(curves):
    """Per-element bit planes and one host scalar (negative, zero) give the
    oracle's points; the two agree where the bits are the scalar's.
    (scalar_mul_fr_std is held by test_rnd_point_vs_oracle; the JAX
    package's scalar_mul_static by test_glv_subgroup_test_vs_slow.)"""
    ck, _ = curves
    ops, og = ck.g1, ck.oracle_g1
    r = random.Random(2)
    ps = [og.rnd(r) for _ in range(3)] + [None]
    A = ops.from_affine(ck.encode_g1(ps))
    ks = [r.randrange(1 << 16) for _ in range(3)] + [5]
    bits = torch.tensor([[(k >> i) & 1 for k in ks] for i in range(16)])
    got = ck.decode_g1(ops.to_affine(ops.scalar_mul_bits(bits, A)))
    assert got == [og.scalar_mul(k, p) for k, p in zip(ks, ps)]
    same = bits[:, 0:1].expand(16, 4)
    assert ops.eq(ops.scalar_mul_static(ks[0], A),
                  ops.scalar_mul_bits(same, A)).tolist() == [True] * 4
    assert ck.decode_g1(ops.to_affine(ops.scalar_mul_static(-3, A))) == [
        og.scalar_mul(-3, p) for p in ps]
    assert bool(ops.is_inf(ops.scalar_mul_static(0, A)).all())


def test_glv_subgroup_test_vs_slow(curves):
    """G1: the fast test (GLV for BLS12-381, on-curve for BN128's
    cofactor 1) agrees with [r] P = infinity and with the JAX package on
    subgroup points, infinity, points outside the subgroup and a point
    off the curve."""
    ck, jck = curves
    ops, og = ck.g1, ck.oracle_g1
    r = random.Random(3)
    pts = [og.rnd(r) for _ in range(3)] + [None]
    if ck.curve.cofactor != 1:
        pts += outside_points(og, 3, 4)
    x, y = og.rnd(r)
    pts.append((x, og.f.add(y, 1)))                 # off the curve
    want = [og.is_in_subgroup(p) for p in pts]
    assert want.count(True) == 4
    A = ops.from_affine(ck.encode_g1(pts))
    assert ops.is_in_subgroup(A).tolist() == want
    assert ops.is_in_subgroup_slow(A).tolist() == want
    jA = jck.g1.from_affine(jck.encode_g1(pts))
    assert np.asarray(jck.g1.is_in_subgroup(jA)).tolist() == want
    assert (ops._glv is not None) == (ck.curve.cofactor != 1)
    if ops._glv is not None:
        # the GLV test's [lambda] P, and phi(P), against the JAX package
        lam = ops._glv[1]
        assert lam == jck.g1._glv[1]
        got = ck.decode_g1(ops.to_affine(ops.scalar_mul_static(lam, A)))
        assert got == jck.decode_g1(jck.g1.to_affine(
            jck.g1.scalar_mul_static(lam, jA)))
        assert ck.decode_g1(ops.to_affine(ops.endo(A))) == jck.decode_g1(
            jck.g1.to_affine(jck.g1.endo(jA)))


def test_g2_subgroup_test_and_clear_cofactor():
    """G2 has no GLV: [r] P, on two points in and two outside the
    subgroup; clearing the G1 cofactor moves points into the subgroup."""
    ck = get_curves(P.BLS12_381, "cpu")
    og2 = ck.oracle_g2
    pts = [og2.rnd(random.Random(5)), None] + outside_points(og2, 2, 6)
    A = ck.g2.from_affine(ck.encode_g2(pts))
    assert ck.g2.is_in_subgroup(A).tolist() == [True, True, False, False]
    og = ck.oracle_g1
    outs = outside_points(og, 3, 7)
    C = ck.g1.clear_cofactor(ck.g1.from_affine(ck.encode_g1(outs)))
    assert ck.decode_g1(ck.g1.to_affine(C)) == [
        og.scalar_mul_unreduced(og.cofactor, p) for p in outs]
    assert ck.g1.is_in_subgroup(C).tolist() == [True] * 3


@pytest.mark.parametrize("curve,jcurve,grp", [
    (P.BLS12_381, JP.BLS12_381, "g1"), (P.BLS12_381, JP.BLS12_381, "g2"),
    (P.BN128, JP.BN128, "g1")], ids=["BLS12-381-g1", "BLS12-381-g2",
                                    "BN128-g1"])
def test_compress_decompress_vs_jax(curve, jcurve, grp):
    """compress: x as the same integer and the same flags as the JAX
    package (bit 0 y's parity, bit 1 infinity); decompress gives the
    points back, valid, with the JAX package's y (G2 through fp2_sqrt);
    an x with no point is invalid."""
    ck, jck = get_curves(curve, "cpu"), jax_get_curves(jcurve)
    _, og, enc, dec = group(ck, grp)
    _, _, jenc, _ = group(jck, grp)
    r = random.Random(8)
    pts = [og.rnd(r) for _ in range(3)] + [None]
    pts.insert(1, og.neg(pts[0]))
    comp = ck.compress_g1 if grp == "g1" else ck.compress_g2
    decomp = ck.decompress_g1 if grp == "g1" else ck.decompress_g2
    jcomp = jck.compress_g1 if grp == "g1" else jck.compress_g2
    jdecomp = jck.decompress_g1 if grp == "g1" else jck.decompress_g2
    x, flags = comp(enc(pts))
    jx, jflags = jcomp(jenc(pts))
    assert flags.tolist() == np.asarray(jflags).tolist()
    assert flags.tolist()[-1] == 2 and flags[0] != flags[1]
    assert torch.equal(x, torch.from_numpy(from_jax_limbs15(jx, ck.fp)))
    # x with no point last: x^3 + b no square
    f = og.f
    while True:
        xb = (r.randrange(f.p) if grp == "g1"
              else (r.randrange(f.p), r.randrange(f.p)))
        if f.sqrt(f.add(f.mul(f.mul(xb, xb), xb), og.b)) is None:
            break
    xs = torch.cat([x, enc([(xb, xb)])[0]], -1)
    fl = torch.cat([flags, flags.new_zeros(1)])
    A, valid = decomp(xs, fl)
    assert valid.tolist() == [True] * 5 + [False]
    assert dec(tuple(c[..., :5] for c in A)) == pts
    if grp == "g2":
        (_, jy, _), jvalid = jdecomp(jx, jflags)
        assert np.asarray(jvalid).all()
        assert ck.tower.decode_fp2(A[1][..., :4]) == jck.tower.decode_fp2(
            jy[..., :4])


@pytest.mark.parametrize("curve", [P.BLS12_381, P.BLS12_377],
                         ids=lambda c: c.name)
def test_fp2_sqrt_vs_oracle(curve):
    """Squares, non-squares, pure-c0 and pure-u values and 0, over
    u^2 = -1 and u^2 = -5: is_square as the oracle says, root^2 = a."""
    t = CurveKernels(curve, "cpu").tower
    from zikkurat_algebra_tpu_torch.oracle.groups import fp2_field

    o = fp2_field(curve)
    r = random.Random(11)
    vals = [(0, 0)]
    for _ in range(3):
        a = (r.randrange(o.p), r.randrange(o.p))
        vals += [a, o.sqr(a), (a[0], 0), (0, a[1]), o.sqr((a[0], 0)),
                 o.sqr((0, a[1]))]
    root, ok = t.fp2_sqrt(t.encode_fp2(vals))
    assert ok.tolist() == [o.sqrt(v) is not None for v in vals]
    for v, rt, k in zip(vals, t.decode_fp2(root), ok.tolist()):
        assert not k or o.sqr(rt) == v


def test_rnd_point_vs_oracle():
    """rnd_point draws its scalars with Fr's rnd: the same generator seed
    gives the scalars back, and the points are [k] G, in the subgroup."""
    ck = get_curves(P.BLS12_381, "cpu")
    P1 = ck.rnd_point(torch.Generator().manual_seed(4), (2, 2))
    ks = ck.fr.decode(ck.fr.rnd(torch.Generator().manual_seed(4), (4,)))
    assert P1[0].shape == (ck.fp.W, 2, 2)
    flat = tuple(c.reshape(c.shape[0], 4) for c in P1)
    og = ck.oracle_g1
    assert ck.decode_g1(ck.g1.to_affine(flat)) == [
        og.scalar_mul(k, og.gen) for k in ks]
    assert ck.g1.is_in_subgroup(flat).tolist() == [True] * 4
    with pytest.raises(ValueError):
        ck.rnd_point(torch.Generator(), (1,), grp="g3")


def test_digits_bits_vs_jax():
    """limbs_to_bits / limbs_to_digits_msb give the integers the JAX
    package's give (the counts of leading zero digits differ)."""
    ck, jck = get_curves(P.BN128, "cpu"), jax_get_curves(JP.BN128)
    vals = [0, 1, ck.fr.p - 1, 0xDEADBEEF << 100]
    a = ck.fr.encode(vals, mont=False)
    bits = limbs_to_bits(a)
    assert bits.shape[0] == 32 * ck.fr.W
    assert [sum(int(bits[i, j]) << i for i in range(bits.shape[0]))
            for j in range(4)] == vals
    for w in (4, 5):
        d = limbs_to_digits_msb(a, w).tolist()
        jd = np.asarray(jax_curve.limbs_to_digits_msb(
            jck.fr.encode(vals, mont=False), w)).tolist()
        for digits in (d, jd):
            got = [0] * 4
            for row in digits:
                got = [(g << w) | int(x) for g, x in zip(got, row)]
            assert got == vals
    for k in (0, 1, 16, 0xABCDEF):
        assert int_to_digits_msb(k) == jax_curve.int_to_digits_msb(k)
    with pytest.raises(ValueError):
        int_to_digits_msb(-1)


def test_get_curves_and_glv_mismatch():
    assert get_curves(P.BN128, "cpu") is get_curves(P.BN128,
                                                    torch.device("cpu"))
    beta, lam = P.BLS12_381.glv_beta_lambda
    bad = dataclasses.replace(P.BLS12_381, glv_beta_lambda=(beta + 1, lam))
    with pytest.raises(ValueError, match="GLV"):
        CurveKernels(bad, "cpu")
