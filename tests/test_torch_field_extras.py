"""The port's field extras (zikkurat_algebra_tpu_torch.ops.field: pow,
div, div2, muli, is_valid, sqrt, reduce_wide, the standard-rep ops, the
reference word format, rnd, get_field), its params and oracle copies,
against the JAX package and the pure-int oracle.

Results are compared as decoded integers mod p (the two packages keep
different limbs).  JAX calls stay small: one batch per function, at most
one square root per test.  Square roots on the primes at the limb
boundaries (one to four limbs, p above R/2, two-adicity up to 32) and on
the standard-curve fields are held against the oracle alone, as the JAX
package's own tests do above two-adicity 4.  On the CPU every product
runs the plain version of kernel K1; tests/test_torch_gpu.py holds the
kernel at every width against it.
"""

import random

import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu import params as JP
from zikkurat_algebra_tpu.ops.field import Field as JField
from zikkurat_algebra_tpu.ops.field import get_field as jax_get_field
from zikkurat_algebra_tpu.ops.field import ints_to_limbs15
from zikkurat_algebra_tpu.oracle import curve as jax_ocurve
from zikkurat_algebra_tpu.oracle import ext as jax_oext
from zikkurat_algebra_tpu.oracle import field as jax_ofield
from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.ops import limbs as lb
from zikkurat_algebra_tpu_torch.ops.field import Field, get_field
from zikkurat_algebra_tpu_torch.oracle import curve as ocurve
from zikkurat_algebra_tpu_torch.oracle import ext as oext
from zikkurat_algebra_tpu_torch.oracle import field as ofield
from zikkurat_algebra_tpu_torch.oracle.groups import fp2_field, g1_group

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)

PAIRS = [(P.BN128_FR, JP.BN128_FR), (P.BLS12_381_FP, JP.BLS12_381_FP)]
# the standard-curve fields that tests/test_curve_db.py runs on the device
DEVICE_SUBSET = [("Pallas", "base"), ("Secp256k1", "base"),
                 ("Curve25519", "scalar"), ("BabyJubJub", "scalar")]


def sample(seed, p, n=8):
    r = random.Random(seed)
    vals = [r.randrange(p) for _ in range(n)]
    vals[:3] = [0, 1, p - 1]
    return vals


def corner_values(p: int, W: int):
    """0, 1, 2, p - 1, p - 2, (p +- 1) / 2, 2^(32 k) +- 1 and all-ones
    limbs 2^(32 k) - 1 for k < W, reduced mod p, and random values."""
    vals = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2]
    for k in range(1, W + 1):
        vals += [((1 << (32 * k)) + d) % p for d in (-1, 0, 1)]
    r = random.Random(p % 9973)
    return vals + [r.randrange(p) for _ in range(4)]


@pytest.fixture(params=PAIRS, ids=[p[0].name for p in PAIRS])
def fields(request):
    port, jax_params = request.param
    return Field(port, device="cpu"), jax_get_field(jax_params)


def test_pow_div_muli_div2_vs_jax(fields):
    f, jf = fields
    av, bv = sample(1, f.p), sample(2, f.p)
    a, b, ja, jb = f.encode(av), f.encode(bv), jf.encode(av), jf.encode(bv)
    e = (f.p - 1) // 3 + 12345
    assert f.decode(f.pow_static(a, e)) == jf.decode(jf.pow_static(ja, e)) \
        == [pow(x, e, f.p) for x in av]
    assert f.decode(f.pow_static(a, 0)) == [1] * len(av)
    assert f.decode(f.pow_static(a, -3)) == [
        pow(x, -3, f.p) if x else 0 for x in av]
    # bits given on the host, with leading zero bits
    assert f.decode(f.pow_bits(a, [1, 0, 1, 0, 0])) == [
        pow(x, 5, f.p) for x in av]
    assert f.decode(f.pow_bits(a, np.zeros(3, np.uint8))) == [1] * len(av)
    assert f.decode(f.div(a, b)) == jf.decode(jf.div(ja, jb))
    assert f.decode(f.div2(a)) == jf.decode(jf.div2(ja))
    for k in (0, 1, 12):
        assert f.decode(f.muli(a, k)) == jf.decode(jf.muli(ja, k)) == [
            k * x % f.p for x in av]


def test_is_valid_vs_jax(fields):
    """Canonical values are valid, p and p + 5 are not (test_api.py:56)."""
    f, jf = fields
    good = f.encode([0, 1, f.p - 1], mont=False)
    bad = torch.from_numpy(lb.ints_to_limbs([f.p, f.p + 5], f.W))
    jgood = jf.encode([0, 1, f.p - 1], mont=False)
    jbad = ints_to_limbs15([f.p, f.p + 5], jf.L)
    assert f.is_valid(good).tolist() == np.asarray(
        jf.is_valid(jgood)).tolist() == [True] * 3
    assert f.is_valid(bad).tolist() == np.asarray(
        jf.is_valid(jbad)).tolist() == [False] * 2


def test_std_ops_vs_jax(fields):
    f, jf = fields
    av, bv = sample(3, f.p), sample(4, f.p)
    a, b = f.encode(av, mont=False), f.encode(bv, mont=False)
    ja, jb = jf.encode(av, mont=False), jf.encode(bv, mont=False)

    def both(port, jax_out):
        return f.decode(port, mont=False), jf.decode(jax_out, mont=False)

    got, want = both(f.std_mul(a, b), jf.std_mul(ja, jb))
    assert got == want == [x * y % f.p for x, y in zip(av, bv)]
    got, want = both(f.std_inv(a), jf.std_inv(ja))
    assert got == want == [pow(x, -1, f.p) if x else 0 for x in av]
    got, want = both(f.std_pow(a, 1234567), jf.std_pow(ja, 1234567))
    assert got == want
    # a standard-rep value at or above p reduces to its residue
    big = torch.from_numpy(lb.ints_to_limbs([f.p, f.p + 7, 3], f.W))
    assert f.decode(f.norm_std(big), mont=False) == [0, 7, 3]


def test_ref_mont_vs_jax(fields):
    f, jf = fields
    av = sample(5, f.p)
    words = f.export_ref_mont(f.encode(av))
    assert words == jf.export_ref_mont(jf.encode(av))
    assert f.decode(f.import_ref_mont(words)) == av
    assert jf.decode(jf.import_ref_mont(words)) == av


@pytest.mark.parametrize("name,R_ref", [("M31", 1 << 64), ("P64+", 1 << 128)])
def test_ref_mont_odd_widths(name, R_ref):
    """M31 (W = 1) and 2^64 + 13 (W = 3): the reference's R is not the
    port's 2^(32 W), and the words follow the reference's."""
    f = Field(P.TEST_PRIMES[name], device="cpu")
    assert f.R != R_ref == f.R_ref
    vals = corner_values(f.p, f.W)
    words = f.export_ref_mont(f.encode(vals))
    assert [sum(w << (64 * i) for i, w in enumerate(ws)) for ws in words] \
        == [v * R_ref % f.p for v in vals]
    jf = JField(JP.TEST_PRIMES[name])
    assert words == jf.export_ref_mont(jf.encode(vals))
    assert f.decode(f.import_ref_mont(words)) == vals


@pytest.mark.parametrize("prm,jprm", [(P.BLS12_381_FP, JP.BLS12_381_FP),
                                      (P.BLS12_381_FR, JP.BLS12_381_FR)],
                         ids=["BLS12-381/Fp", "BLS12-381/Fr"])
def test_sqrt_vs_jax_and_oracle(prm, jprm):
    """p = 3 mod 4 (Fp) and Tonelli-Shanks at two-adicity 32 (Fr), one
    batch of 8: squares, 0 and a non-residue.  The two packages run the
    same chain, so the roots are equal, not only +- each other."""
    f, jf, o = Field(prm, device="cpu"), jax_get_field(jprm), ofield.Fp(prm)
    vals = [x * x % f.p for x in sample(6, f.p, 6)]
    vals += [prm.multiplicative_gen, f.p - 1]
    root, ok = f.sqrt(f.encode(vals))
    jroot, jok = jf.sqrt(jf.encode(vals))
    assert f.decode(root) == jf.decode(jroot)
    assert ok.tolist() == np.asarray(jok).tolist() == [
        o.is_square(v) for v in vals]
    for v, r, k in zip(vals, f.decode(root), ok.tolist()):
        assert not k or r * r % f.p == v


@pytest.mark.parametrize(
    "prm", list(P.TEST_PRIMES.values())
    + [P.curve_db_field(c, w) for c, w in DEVICE_SUBSET],
    ids=lambda p: p.name)
def test_sqrt_corner_primes_vs_oracle(prm):
    """Square roots at every limb count and both p mod 4 classes
    (goldilocks: Tonelli-Shanks at two-adicity 32) on corner values: the
    squares have roots, +- the oracle's; the non-residue has none."""
    f, o = Field(prm, device="cpu"), ofield.Fp(prm)
    xs = corner_values(f.p, f.W)
    vals = [x * x % f.p for x in xs] + [prm.multiplicative_gen]
    root, ok = f.sqrt(f.encode(vals))
    assert ok.tolist() == [True] * len(xs) + [False]
    for v, r in zip(vals, f.decode(root)[:len(xs)]):
        assert r in (o.sqrt(v), o.neg(o.sqrt(v)))


@pytest.mark.parametrize("curve", sorted(P.CURVE_DB))
def test_curve_db_fields(curve):
    """Every standard-curve field gives a working Field: round trips and
    products against ints, its non-residue a genuine one."""
    for which in ("base", "scalar"):
        prm = P.curve_db_field(curve, which)
        f, p = Field(prm, device="cpu"), prm.p
        assert pow(prm.multiplicative_gen, (p - 1) // 2, p) == p - 1
        vals = [0, 1, 2, p - 1, (p - 1) // 2, pow(3, 100, p)]
        assert f.decode(f.encode(vals)) == vals
        assert f.decode(f.encode(vals, mont=False), mont=False) == vals
        a = f.encode(vals)
        assert f.decode(f.mul(a, a)) == [v * v % p for v in vals]


def test_reduce_wide_vs_jax():
    """The port's int64 columns and the JAX package's radix-2^15 columns
    of the same integers reduce to the same residues."""
    f, jf = Field(P.BN128_FR, device="cpu"), jax_get_field(JP.BN128_FR)
    rng = np.random.default_rng(8)
    cols = rng.integers(0, 1 << 62, (f.W, 6), dtype=np.int64)
    cols[:, 0] = (1 << 62) - 1
    vals = [sum(int(cols[i, j]) << (32 * i) for i in range(f.W))
            for j in range(cols.shape[1])]
    got = f.decode(f.reduce_wide(torch.from_numpy(cols)), mont=False)
    L = jf.L + 4                       # the value needs 32 W + 30 bits
    jcols = ints_to_limbs15(vals, L)
    want = jf.decode(jf.reduce_wide(jcols), mont=False)
    assert got == want == [v % f.p for v in vals]


def test_rnd_and_get_field():
    f = get_field(P.BLS12_381_FR, "cpu")
    assert get_field(P.BLS12_381_FR, torch.device("cpu")) is f
    a = f.rnd(torch.Generator().manual_seed(1), (3, 5))
    b = f.rnd(torch.Generator().manual_seed(1), (3, 5))
    c = f.rnd(torch.Generator().manual_seed(2), (3, 5))
    assert a.shape == (f.W, 3, 5) and torch.equal(a, b)
    assert not torch.equal(a, c)
    assert bool(f.is_valid(a).all()) and bool(f.is_valid(c).all())
    m = Field(P.TEST_PRIMES["M31"], device="cpu")
    v = m.decode(m.rnd(torch.Generator().manual_seed(3), (4000,)))
    assert len(set(v)) > 3990 and max(v) < m.p


def test_params_equal_jax():
    """The port's copies of the test primes, the curve database, the
    field registry and the GLV constants equal the JAX package's."""
    def key(fp):
        return (fp.name, fp.p, fp.multiplicative_gen, fp.fft_domain)

    assert {k: key(v) for k, v in P.TEST_PRIMES.items()} == {
        k: key(v) for k, v in JP.TEST_PRIMES.items()}
    assert {k: key(v) for k, v in P.FIELDS.items()} == {
        k: key(v) for k, v in JP.FIELDS.items()}
    assert P.CURVE_DB == JP.CURVE_DB
    for c in P.CURVE_DB:
        for which in ("base", "scalar"):
            assert key(P.curve_db_field(c, which)) == key(
                JP.curve_db_field(c, which))
    for name, curve in P.CURVES.items():
        assert curve.glv_beta_lambda == JP.CURVES[name].glv_beta_lambda
        assert P.sage_setup(curve) == JP.sage_setup(JP.CURVES[name])
    assert P.smallest_nonresidue(P.BLS12_381_FR.p) == 5
    with pytest.raises(ValueError):
        P.curve_db_field("Pallas", "neither")


def test_oracle_field_extras_vs_jax():
    prm = P.TEST_PRIMES["goldilocks"]
    o, jo = ofield.Fp(prm), jax_ofield.Fp(JP.TEST_PRIMES["goldilocks"])
    vals = corner_values(o.p, 2)
    for v in vals:
        assert o.sqrt(v) == jo.sqrt(v)
        assert o.is_square(v) == jo.is_square(v)
        assert o.div_by_2(v) == jo.div_by_2(v)
        assert o.pow(v, -5) == jo.pow(v, -5)
        assert o.sqr(v) == jo.sqr(v) and o.scale_int(7, v) == jo.scale_int(7, v)
    assert ofield.batch_inv(o, vals) == jax_ofield.batch_inv(jo, vals)
    for n in range(-30, 30):
        for k in (1, 3, 15, 97, 561):
            assert ofield.jacobi(n, k) == jax_ofield.jacobi(n, k)
    with pytest.raises(ValueError):
        ofield.jacobi(3, 4)


def test_oracle_fp2_and_curve_extras_vs_jax():
    """Fp2Field.sqrt, CurveGroup.sub / scalar_mul_unreduced / rnd against
    the JAX oracle.  is_in_subgroup differs on purpose: the JAX oracle's
    reduces r mod r, so it accepts every curve point; the port's copy
    multiplies by r itself and rejects points outside the subgroup."""
    f2 = fp2_field(P.BLS12_381)
    jf2 = jax_oext.Fp2Field(jax_ofield.Fp(JP.BLS12_381_FP), 1, 1)
    r = random.Random(9)
    for _ in range(6):
        a = (r.randrange(f2.p), r.randrange(f2.p))
        for v in (a, f2.sqr(a), (a[0], 0), (0, a[1]), (0, 0)):
            assert f2.sqrt(v) == jf2.sqrt(v)
    og = g1_group(P.BLS12_381)
    jog = jax_ocurve.CurveGroup(jax_ofield.Fp(JP.BLS12_381_FP), og.a, og.b,
                                og.r, og.gen, og.cofactor)
    Pt, Qt = og.rnd(random.Random(1)), og.rnd(random.Random(2))
    assert Pt == jog.rnd(random.Random(1))
    assert og.sub(Pt, Qt) == jog.sub(Pt, Qt)
    assert og.scalar_mul_unreduced(-og.r - 3, Pt) == \
        jog.scalar_mul_unreduced(-og.r - 3, Pt)
    f = og.f
    while True:
        x = r.randrange(f.p)
        y = f.sqrt((x * x % f.p * x + og.b) % f.p)
        if y is not None:
            break
    assert og.is_in_subgroup(Pt) and jog.is_in_subgroup(Pt)
    assert jog.is_in_subgroup((x, y)) and not og.is_in_subgroup((x, y))
    assert isinstance(og, ocurve.CurveGroup)
    assert isinstance(f2, oext.Fp2Field)
