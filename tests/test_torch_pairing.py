"""The port's tower (Fp6, Fp12, Frobenius maps) and pairing against the JAX
package's TowerKernels and PairingKernels and the oracle.

Values come from a numpy generator with a fixed seed; the JAX encodings
are carried into the port by utils/convert.py.  Results are compared as
decoded integers mod p, exactly: the Miller loop's value too, since the
port's G2 doubling and mixed addition follow the JAX package's operation
order.  On the CPU every product runs the plain version of kernel K1.
A port pairing costs 5-8 s here and a JAX `final_exp` compiles for
25-30 s, so each curve runs the port's Miller loop and final
exponentiation three times in all, every case of a call in one batch,
and the JAX functions once, at the JAX tests' own batch of two pairs.
"""

import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu import params as JP
from zikkurat_algebra_tpu.ops.pairing import get_pairing as jax_get_pairing
from zikkurat_algebra_tpu.ops.tower import get_tower
from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.errors import UnsupportedError
from zikkurat_algebra_tpu_torch.ops import kernel_field
from zikkurat_algebra_tpu_torch.ops.pairing import get_pairing
from zikkurat_algebra_tpu_torch.ops.tower import TowerKernels
from zikkurat_algebra_tpu_torch.utils import convert

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)

CURVES = [(P.BN128, JP.BN128), (P.BLS12_381, JP.BLS12_381)]
IDS = ["BN128", "BLS12-381"]


def rand_ints(rng, p, n):
    return [int.from_bytes(rng.bytes(64), "little") % p for _ in range(n)]


def rand_fp12(rng, p, n):
    """n Fp12 values ((A0, A1, A2), (B0, B1, B2)) of Fp2 pairs, the first
    two 0 and 1, the rest uniform."""
    out = []
    for _ in range(n):
        c = rand_ints(rng, p, 12)
        fp2 = [(c[2 * k], c[2 * k + 1]) for k in range(6)]
        out.append((tuple(fp2[:3]), tuple(fp2[3:])))
    zero = ((0, 0),) * 3
    out[0] = (zero, zero)
    out[1] = (((1, 0), (0, 0), (0, 0)), zero)
    return out


def carried(tw, jarr, level):
    """A JAX tower array carried into the port."""
    return torch.from_numpy(convert.from_jax_tower(np.asarray(jarr), tw.fp,
                                                   level))


def rand_points(rng, og, n):
    return [og.scalar_mul(int(k), og.gen)
            for k in rng.integers(1, 1 << 62, n)]


@pytest.mark.parametrize("pair", CURVES, ids=IDS)
def test_tower_vs_jax(pair):
    """Fp6 and Fp12 mul_list, sqr, inv and mul_by_v, mul_xi, the Frobenius
    maps of every level and fp12_conj against the JAX TowerKernels (their
    inputs carried by utils/convert.py), and against the oracle; an
    Fp12 batch of products is ONE product launch."""
    rng = np.random.default_rng(11)
    tw, jt = TowerKernels(pair[0], device="cpu"), get_tower(pair[1])
    o = tw.oracle
    p = tw.fp.p
    av, bv = rand_fp12(rng, p, 6), rand_fp12(rng, p, 6)[::-1]
    ja, jb = jt.encode_fp12(av), jt.encode_fp12(bv)
    a, b = carried(tw, ja, "fp12"), carried(tw, jb, "fp12")
    assert tw.decode_fp12(a) == av
    assert jt.decode_fp12(convert.to_jax_tower(a, tw.fp, "fp12")) == av
    dec, jdec = tw.decode_fp12, jt.decode_fp12

    got = [dec(t) for t in tw.fp12.mul_list([(a, b), (a, a)])]
    assert got == [jdec(t) for t in jt.fp12.mul_list([(ja, jb), (ja, ja)])]
    assert got[0] == [o.fp12.mul(x, y) for x, y in zip(av, bv)]
    assert dec(tw.fp12.sqr(b)) == [o.fp12.sqr(y) for y in bv]
    inv = dec(tw.fp12.inv(a))
    assert inv == jdec(jt.fp12.inv(ja)) == [o.fp12.inv(x) for x in av]
    assert inv[0] == o.fp12.zero                       # inv(0) = 0
    for k in (1, 2):
        assert dec(tw.fp12_frobenius(a, k)) == jdec(jt.fp12_frobenius(ja, k))
    assert dec(tw.fp12_frobenius(a, 1)) == [o.fp12.frobenius(x) for x in av]
    assert dec(tw.fp12_frobenius(b, 12)) == bv
    assert dec(tw.fp12_conj(a)) == jdec(jt.fp12_conj(ja))
    assert dec(tw.fp12.pow_static(b, 5)) == [o.fp12.pow(y, 5) for y in bv]

    a6, ja6 = a[:, 1], ja[:, 1]                         # the Fp6 halves
    a6v = [x[1] for x in av]
    d6, jd6 = tw.decode_fp6, jt.decode_fp6
    prods = tw.fp6.mul_list([(a6, b[:, 0]), (a6, a6)])
    jprods = jt.fp6.mul_list([(ja6, jb[:, 0]), (ja6, ja6)])
    assert [d6(t) for t in prods] == [jd6(t) for t in jprods]
    assert d6(tw.fp6.sqr(a6)) == d6(prods[1])
    assert d6(tw.fp6.inv(a6)) == jd6(jt.fp6.inv(ja6)) == [o.fp6.inv(x)
                                                          for x in a6v]
    assert d6(tw.fp6.mul_by_v(a6)) == jd6(jt.fp6.mul_by_v(ja6))
    assert d6(tw.fp6_frobenius(a6)) == jd6(jt.fp6_frobenius(ja6))
    assert d6(tw.fp6_frobenius(a6)) == [o.fp6.pow(x, p) for x in a6v[:3]] \
        + [o.fp6.frobenius(x) for x in a6v[3:]]

    a2, ja2 = a[:, 0, 1], ja[:, 0, 1]
    d2, jd2 = tw.decode_fp2, jt.decode_fp2
    assert d2(tw.mul_xi(a2)) == jd2(jt.mul_xi(ja2))
    assert d2(tw.fp2_frobenius(a2)) == jd2(jt.fp2_frobenius(ja2))
    assert d2(tw.fp2_frobenius(a2)) == [o.fp2.pow(x[0][1], p) for x in av]
    assert d2(tw.fp2.div(a2, a2))[2:] == [(1, 0)] * 4

    calls = []
    plain = kernel_field.mont_mul_plain

    def counting(x, y, f):
        calls.append(x.shape)
        return plain(x, y, f)

    tw.fp._mont_mul = counting
    try:
        tw.fp12.mul_list([(a, b), (b, a), (a, a)])
    finally:
        tw.fp._mont_mul = kernel_field.mont_mul
    assert len(calls) == 1 and np.prod(calls[0][1:]) == 54 * 3 * 6


def test_tower_general_qnr():
    """BLS12-377's tower (u^2 = -5, xi = u) against the oracle: it has no
    G2 and no pairing, and get_pairing says so."""
    rng = np.random.default_rng(12)
    tw = TowerKernels(P.BLS12_377, device="cpu")
    o = tw.oracle
    av, bv = rand_fp12(rng, tw.fp.p, 4), rand_fp12(rng, tw.fp.p, 4)
    a, b = tw.encode_fp12(av), tw.encode_fp12(bv)
    assert tw.decode_fp12(tw.fp12.mul(a, b)) == [o.fp12.mul(x, y)
                                                 for x, y in zip(av, bv)]
    assert tw.decode_fp12(tw.fp12.inv(b)) == [o.fp12.inv(y) for y in bv]
    assert tw.decode_fp12(tw._frob1(b)) == [o.fp12.frobenius(y) for y in bv]
    with pytest.raises(UnsupportedError):
        get_pairing(P.BLS12_377, device="cpu")


@pytest.mark.parametrize("pair", CURVES, ids=IDS)
def test_miller_loop_and_final_exp_vs_jax(pair):
    """miller_loop and final_exp equal the JAX functions on two pairs,
    decoded exactly (the final exponentiation on the JAX Miller values
    carried into the port), and the first pairing value the oracle's."""
    rng = np.random.default_rng(13)
    pk, jpk = get_pairing(pair[0], device="cpu"), jax_get_pairing(pair[1])
    ck, tw = pk.ck, pk.tower
    ps = rand_points(rng, ck.oracle_g1, 2)
    qs = rand_points(rng, ck.oracle_g2, 2)
    jf = jpk.miller_loop(jpk.ck.encode_g1(ps), jpk.ck.encode_g2(qs))
    f = pk.miller_loop(ck.encode_g1(ps), ck.encode_g2(qs))
    assert tw.decode_fp12(f) == jpk.tower.decode_fp12(jf)
    want = jpk.tower.decode_fp12(jpk.final_exp(jf))
    assert tw.decode_fp12(pk.final_exp(carried(tw, jf, "fp12"))) == want
    assert want[0] == pk.oracle.pairing(ps[0], qs[0])


@pytest.mark.parametrize("pair", CURVES, ids=IDS)
def test_pairing_vs_oracle(pair):
    """`pairing` equals the oracle, is bilinear (e([a]P, Q) = e(P, [a]Q)
    = e(P, Q)^a) and gives 1 at infinity; `pairing_product` of an odd
    batch with a pair at infinity cancels e(P, Q) e(-P, Q); the G2
    Frobenius map equals the oracle's."""
    rng = np.random.default_rng(14)
    pk = get_pairing(pair[0], device="cpu")
    ck, tw, o12 = pk.ck, pk.tower, pk.oracle.f12
    og1, og2 = ck.oracle_g1, ck.oracle_g2
    (p0, p1), (q0, q1) = rand_points(rng, og1, 2), rand_points(rng, og2, 2)
    e01 = pk.oracle.pairing(p1, q1)
    a = int(rng.integers(2, 1 << 30))
    Pb = ck.encode_g1([p0, og1.scalar_mul(a, p0), p1, None, p0])
    Qb = ck.encode_g2([og2.scalar_mul(a, q0), q0, q1, q0, None])
    e = tw.decode_fp12(pk.pairing(Pb, Qb))
    assert e[2] == e01
    assert e[0] == e[1] != o12.one
    assert e[0] == o12.pow(pk.oracle.pairing(p0, q0), a)
    assert e[3] == e[4] == o12.one

    prod = pk.pairing_product(ck.encode_g1([p0, og1.neg(p0), p1, None, p0]),
                              ck.encode_g2([q0, q0, q1, q0, None]))
    assert tw.decode_fp12(prod) == e01

    gx, gy = pk.g2_frobenius(ck.encode_g2([q0, q1])[:2])
    assert list(zip(tw.decode_fp2(gx), tw.decode_fp2(gy))) == [
        pk.oracle.frobenius_g2(q) for q in (q0, q1)]
