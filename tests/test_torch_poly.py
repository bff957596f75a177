"""The port's polynomials (ops/poly.py) and vector operations
(ops/vector.py) against the JAX package's PolyOps and vector module and
against plain Python ints.

Inputs are made from numpy seeds (coefficient counts N <= 32) and fed to
both packages; results are compared as decoded integers mod p, exactly.
JAX `PolyOps.mul_ntt` reaches the JAX `get_domain` cache, which other
tests can leave holding values traced under `shard_map`; the
`fresh_jax_domains` fixture empties it for the test and puts it back
after.
"""

import json

import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu import params as JP
from zikkurat_algebra_tpu.ops import ntt as jntt
from zikkurat_algebra_tpu.ops import vector as JV
from zikkurat_algebra_tpu.ops.field import get_field
from zikkurat_algebra_tpu.ops.poly import PolyOps as JaxPolyOps
from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.errors import DimensionError
from zikkurat_algebra_tpu_torch.ops import vector as V
from zikkurat_algebra_tpu_torch.ops.field import Field
from zikkurat_algebra_tpu_torch.ops.poly import PolyOps, get_poly_ops
from zikkurat_algebra_tpu_torch.utils import profiling

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)


def rand_ints(seed, p, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % p for _ in range(n)]


@pytest.fixture(scope="module")
def fields():
    f = Field(P.BLS12_381_FR, device="cpu")
    return f, get_field(JP.BLS12_381_FR)


@pytest.fixture(scope="module")
def polys(fields):
    f, jf = fields
    return PolyOps(f), JaxPolyOps(jf)


@pytest.fixture
def fresh_jax_domains():
    saved = dict(jntt._DOMAIN_CACHE)
    jntt._DOMAIN_CACHE.clear()
    try:
        yield
    finally:
        jntt._DOMAIN_CACHE.clear()
        jntt._DOMAIN_CACHE.update(saved)


def both(fields, vals):
    f, jf = fields
    return f.encode(vals), jf.encode(vals)


def test_vector_ops_vs_jax(fields):
    f, jf = fields
    p = f.p
    n = 33
    av, bv, cv = (rand_ints(s, p, n) for s in (1, 2, 3))
    (a, ja), (b, jb), (c, jc) = (both(fields, v) for v in (av, bv, cv))
    s1, s2 = av[0], bv[0]
    (x1, jx1), (x2, jx2) = both(fields, s1), both(fields, s2)

    def same(got, want, ints):
        assert f.decode(got) == jf.decode(want) == ints

    same(V.sum_mod(f, a), JV.sum_mod(jf, ja), sum(av) % p)
    same(V.dot_prod(f, a, b), JV.dot_prod(jf, ja, jb),
         sum(x * y for x, y in zip(av, bv)) % p)
    same(V.mul_add(f, a, b, c), JV.mul_add(jf, ja, jb, jc),
         [(x * y + z) % p for x, y, z in zip(av, bv, cv)])
    same(V.mul_sub(f, a, b, c), JV.mul_sub(jf, ja, jb, jc),
         [(x * y - z) % p for x, y, z in zip(av, bv, cv)])
    same(V.scale(f, x1, a), JV.scale(jf, jx1, ja), [s1 * x % p for x in av])
    same(V.ax_plus_y(f, x1, a, b),
         JV.ax_plus_y(jf, jx1.reshape(jf.L, 1), ja, jb),
         [(s1 * x + y) % p for x, y in zip(av, bv)])
    same(V.ax_plus_by(f, x1, a, x2, b),
         JV.ax_plus_by(jf, jx1.reshape(jf.L, 1), ja, jx2.reshape(jf.L, 1), jb),
         [(s1 * x + s2 * y) % p for x, y in zip(av, bv)])
    same(V.powers(f, x1, x2, 6), JV.powers(jf, jx1, jx2, 6),
         [s1 * pow(s2, k, p) % p for k in range(6)])
    assert f.decode(V.powers(f, x1, x2, 17)) == [s1 * pow(s2, k, p) % p
                                                 for k in range(17)]
    coeffs = av[:3]
    vecs = np.array(bv[:30], dtype=object).reshape(3, 10)
    cf, jcf = both(fields, coeffs)
    vv, jvv = both(fields, list(vecs.reshape(-1)))
    same(V.lin_comb(f, cf, vv.reshape(f.W, 3, 10)),
         JV.lin_comb(jf, jcf, jvv.reshape(jf.L, 3, 10)),
         [sum(coeffs[k] * vecs[k, i] for k in range(3)) % p
          for i in range(10)])


def test_sum_mod_chunks_and_extremes(fields, monkeypatch):
    """Sums over several int64 chunks, of p - 1 repeated, along an inner
    axis, and of nothing."""
    f, _ = fields
    p = f.p
    vals = [p - 1] * 40 + rand_ints(4, p, 60)
    a = f.encode(vals)
    assert f.decode(V.sum_mod(f, a)) == sum(vals) % p
    monkeypatch.setattr(V, "_CHUNK", 7)
    assert f.decode(V.sum_mod(f, a)) == sum(vals) % p
    m = a.reshape(f.W, 10, 10)
    assert f.decode(V.sum_mod(f, m, axis=1)) == [
        sum(vals[i::10]) % p for i in range(10)]
    assert f.decode(V.sum_mod(f, a[:, :0])) == 0
    with pytest.raises(ValueError):
        V.sum_mod(f, a, axis=0)


def test_poly_ring_ops_vs_jax(fields, polys):
    f, jf = fields
    po, jpo = polys
    p = f.p
    av, bv = rand_ints(5, p, 13), rand_ints(6, p, 9)
    (a, ja), (b, jb) = both(fields, av), both(fields, bv)
    for name in ("add", "sub"):
        assert f.decode(getattr(po, name)(a, b)) == jf.decode(
            getattr(jpo, name)(ja, jb))
    assert f.decode(po.neg(a)) == jf.decode(jpo.neg(ja))
    s, js = both(fields, bv[0])
    assert f.decode(po.scale(s, a)) == jf.decode(jpo.scale(js, ja))
    assert f.decode(po.mul_by_xn(a, 3)) == jf.decode(jpo.mul_by_xn(ja, 3))
    padded, jpadded = po.pad_to(a, 20), jpo.pad_to(ja, 20)
    assert int(po.degree(padded)) == int(jpo.degree(jpadded)) == 12
    z, jz = both(fields, [0] * 5)
    assert int(po.degree(z)) == int(jpo.degree(jz)) == -1
    assert bool(po.is_zero(z)) and not bool(po.is_zero(a))
    assert bool(po.eq(a, padded)) == bool(jpo.eq(ja, jpadded)) is True
    assert not bool(po.eq(a, b))
    assert f.decode(po.get_coeff(a, 4)) == av[4]
    assert f.decode(po.get_coeff(a, 40)) == 0
    assert bool(po.is_constant(po.pad_to(a[:, :1], 6)))
    assert not bool(po.is_constant(a))
    assert f.decode(po.lincomb([s, s], [a, b])) == jf.decode(
        jpo.lincomb([js, js], [ja, jb]))
    with pytest.raises(DimensionError):
        po.pad_to(a, 5)
    assert get_poly_ops(f) is get_poly_ops(f)


@pytest.mark.parametrize("na,nb", [(5, 7), (13, 19)])
def test_poly_mul_vs_jax(fields, polys, fresh_jax_domains, na, nb):
    f, jf = fields
    po, jpo = polys
    av, bv = rand_ints(na, f.p, na), rand_ints(nb, f.p, nb)
    (a, ja), (b, jb) = both(fields, av), both(fields, bv)
    want = [sum(av[i] * bv[k - i] for i in range(max(0, k - nb + 1),
                                                min(k, na - 1) + 1)) % f.p
            for k in range(na + nb - 1)]
    assert f.decode(po.mul_naive(a, b)) == jf.decode(jpo.mul_naive(ja, jb)) \
        == want
    assert f.decode(po.mul_ntt(a, b)) == jf.decode(jpo.mul_ntt(ja, jb)) \
        == want
    assert f.decode(po.mul(a, b)) == want
    # a batch of two against one polynomial, through the NTT
    ab = torch.stack([a, a], 1)
    assert f.decode(po.mul_ntt(ab, b)) == want + want


def test_poly_eval_vs_jax(fields, polys):
    f, jf = fields
    po, jpo = polys
    p = f.p
    av = rand_ints(7, p, 12)
    a, ja = both(fields, av)
    x = rand_ints(8, p, 1)[0]
    xe, jxe = both(fields, x)
    want = sum(c * pow(x, i, p) for i, c in enumerate(av)) % p
    assert f.decode(po.eval_at(xe, a)) == jf.decode(jpo.eval_at(jxe, ja)) \
        == want
    xs = rand_ints(9, p, 5)
    xse, jxse = both(fields, xs)
    assert f.decode(po.eval_many(xse, a)) == jf.decode(
        jpo.eval_many(jxse, ja)) == [
            sum(c * pow(t, i, p) for i, c in enumerate(av)) % p for t in xs]


def test_long_div_vs_jax(fields, polys):
    f, jf = fields
    po, jpo = polys
    av, bv = rand_ints(10, f.p, 16), rand_ints(11, f.p, 5)
    (a, ja), (b, jb) = both(fields, av), both(fields, bv)
    q, r = po.long_div(a, b)
    jq, jr = jpo.long_div(ja, jb)
    assert f.decode(q) == jf.decode(jq) and len(f.decode(q)) == 12
    assert f.decode(r) == jf.decode(jr)
    # a = q b + r
    assert po.eq(po.add(po.mul(q, b), r), a)
    assert torch.equal(po.quot(a, b), q) and torch.equal(po.rem(a, b), r)
    with pytest.raises(DimensionError):
        po.long_div(b, a)


@pytest.mark.parametrize("na,n", [(17, 4), (16, 4), (7, 8), (30, 5),
                                  (32, 1)])
def test_div_by_vanishing_vs_jax(fields, polys, na, n):
    f, jf = fields
    po, jpo = polys
    av = rand_ints(12 + na, f.p, na)
    eta = rand_ints(13 + n, f.p, 1)[0]
    (a, ja), (e, je) = both(fields, av), both(fields, eta)
    q, r = po.div_by_vanishing(a, n, e)
    jq, jr = jpo.div_by_vanishing(ja, n, je)
    assert q.shape[-1] == max(0, na - n) and r.shape[-1] == n
    if na > n:
        assert f.decode(q) == jf.decode(jq)
    assert f.decode(r) == jf.decode(jr)
    # exact: (x^n - eta) q0 divides; off by one in coefficient 0: not exact
    q0 = rand_ints(14, f.p, 6)
    prod = [0] * (6 + n)
    for i, c in enumerate(q0):
        prod[i] = (prod[i] - eta * c) % f.p
        prod[i + n] = (prod[i + n] + c) % f.p
    qq, ok = po.quot_by_vanishing(f.encode(prod), n, e)
    assert bool(ok) and f.decode(qq) == q0
    prod[0] = (prod[0] + 1) % f.p
    _, ok = po.quot_by_vanishing(f.encode(prod), n, e)
    assert not bool(ok)


POLY_SPANS = {"poly.mul_ntt": None, "poly.lift": "poly.mul_ntt",
              "ntt.forward": "poly.mul_ntt", "poly.pointwise": "poly.mul_ntt",
              "ntt.inverse": "poly.mul_ntt"}


def test_mul_ntt_spans(fields, polys, tmp_path):
    """A product of 2^6 through the NTT: under recording() its spans nest
    as `PolyOps.mul_ntt` runs them, each transform holding one gather
    and one set of K5 passes; under profiling.trace they are `zk.`
    ranges of the Chrome trace."""
    f, _ = fields
    po, _ = polys
    av, bv = rand_ints(60, f.p, 32), rand_ints(61, f.p, 32)
    a, b = f.encode(av), f.encode(bv)
    profiling.reset()
    with profiling.recording():
        c = po.mul_ntt(a, b)
    assert f.decode(c) == f.decode(po.mul_naive(a, b))
    recs = profiling.records()
    assert {r.op for r in recs} == {recs[-1].op}
    assert {r.name: r.parent for r in recs
            if r.parent in (None, "poly.mul_ntt")} == POLY_SPANS
    inner = sorted((r.parent, r.name) for r in recs
                   if r.name in ("ntt.gather", "ntt.passes"))
    assert inner == [(t, n) for t in ("ntt.forward", "ntt.inverse")
                     for n in ("ntt.gather", "ntt.passes")]
    profiling.reset()
    with profiling.trace(str(tmp_path)):
        po.mul_ntt(a, b)
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert {"zk." + n for n in POLY_SPANS} | {"zk.ntt.gather",
                                              "zk.ntt.passes"} <= names
