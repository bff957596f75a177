"""The port's Fp2 (zikkurat_algebra_tpu_torch.ops.tower) against the JAX
package's QuadExt and the oracle Fp2.

The same numpy-seeded values go to both packages; results are compared
as decoded pairs of integers mod p, exactly.  On the CPU every product
runs the plain version of kernel K1.
"""

import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu import params as JP
from zikkurat_algebra_tpu.ops.tower import get_tower
from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.oracle.groups import fp2_field
from zikkurat_algebra_tpu_torch.ops.tower import TowerKernels

torch.set_num_threads(1)

N = 16


def sample(p, seed, n=N):
    """n Fp2 values with zero, one, u and p - 1 components first."""
    rng = np.random.default_rng(seed)
    vals = [((int(a) << 250 | int(b)) % p, (int(b) << 190 | int(a)) % p)
            for a, b in rng.integers(0, 1 << 62, (n, 2))]
    vals[:4] = [(0, 0), (1, 0), (0, 1), (p - 1, p - 1)]
    return vals


@pytest.mark.parametrize("pair", [(P.BLS12_381, JP.BLS12_381),
                                  (P.BN128, JP.BN128)],
                         ids=lambda pr: pr[0].name)
def test_fp2_vs_jax(pair):
    """mul_list, add, sub, neg, conj, inv and batch_inv against the JAX
    QuadExt (its inv, elementwise, for batch_inv) and the oracle."""
    tw, jt = TowerKernels(pair[0], device="cpu"), get_tower(pair[1])
    f2, jf2, o2 = tw.fp2, jt.fp2, fp2_field(pair[0])
    av, bv = sample(f2.p, 1), sample(f2.p, 2)[::-1]
    a, b = tw.encode_fp2(av), tw.encode_fp2(bv)
    ja, jb = jt.encode_fp2(av), jt.encode_fp2(bv)
    dec, jdec = tw.decode_fp2, jt.decode_fp2

    got = [dec(t) for t in f2.mul_list([(a, b), (a, a), (b, a)])]
    want = [jdec(t) for t in jf2.mul_list([(ja, jb), (ja, ja), (jb, ja)])]
    assert got == want
    assert got[0] == [o2.mul(x, y) for x, y in zip(av, bv)] == got[2]
    assert dec(f2.add(a, b)) == jdec(jf2.add(ja, jb))
    assert dec(f2.sub(a, b)) == jdec(jf2.sub(ja, jb))
    assert dec(f2.neg(a)) == jdec(jf2.neg(ja))
    assert dec(f2.conj(a)) == jdec(jf2.conj(ja))
    winv = jdec(jf2.inv(ja))
    assert dec(f2.inv(a)) == winv == [o2.inv(x) for x in av]
    assert dec(f2.batch_inv(a)) == winv
    assert winv[0] == (0, 0)                        # inv(0) = 0


def test_fp2_helpers_and_general_qnr():
    """Selection, predicates, constants, scale_small and the product by
    the nonresidue; u^2 = -5 (BLS12-377, whose tower has no G2) against
    the oracle."""
    for curve in (P.BLS12_381, P.BLS12_377):
        tw = TowerKernels(curve, device="cpu")
        f2, o2 = tw.fp2, fp2_field(curve)
        av, bv = sample(f2.p, 3), sample(f2.p, 4)
        a, b = tw.encode_fp2(av), tw.encode_fp2(bv)
        assert tw.decode_fp2(f2.mul(a, b)) == [o2.mul(x, y)
                                               for x, y in zip(av, bv)]
        assert tw.decode_fp2(f2.sqr(a)) == [o2.mul(x, x) for x in av]
        assert tw.fp.decode(f2.mul_u2(a[:, 1])) == [
            curve.tower.qnr * x[1] % f2.p for x in av]
        pred = torch.arange(N) % 3 == 0
        assert tw.decode_fp2(f2.select(pred, a, b)) == [
            x if i % 3 == 0 else y for i, (x, y) in enumerate(zip(av, bv))]
        assert f2.is_zero(a).tolist() == [x == (0, 0) for x in av]
        assert f2.eq(a, a).all() and not f2.eq(a, f2.add(a, f2.one((N,)))).any()
        assert tw.decode_fp2(f2.scale_small(a, 3)) == [
            o2.mul(x, (3, 0)) for x in av]
        c = f2.const((5, 7), (2, 3))
        assert c.shape == (tw.fp.W, 2, 2, 3)
        assert tw.decode_fp2(c.reshape(tw.fp.W, 2, -1)) == [(5, 7)] * 6
        assert tw.decode_fp2(tw.encode_fp2_const((5, 7))) == (5, 7)
        assert tw.decode_fp2(f2.one()) == (1, 0)
        assert tw.decode_fp2(f2.zero((2,))) == [(0, 0)] * 2
