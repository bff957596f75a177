"""The port's prime field (zikkurat_algebra_tpu_torch.ops.field) against
the JAX package's Field and plain Python ints.

The inputs are the vectors of tests/test_field.py (random values with 0,
1, p-1 and p-2 first), fed to both packages; results are compared as
decoded integers mod p, exactly.  On the CPU every product runs the plain
version of kernel K1; tests/test_torch_gpu.py holds the kernel against it.
"""

import random

import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu import params as JP
from zikkurat_algebra_tpu.ops.field import get_field
from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.ops import kernel_field
from zikkurat_algebra_tpu_torch.ops import limbs as lb
from zikkurat_algebra_tpu_torch.ops.field import Field

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)

N = 48
PAIRS = [
    (P.BLS12_381_FP, JP.BLS12_381_FP),
    (P.BLS12_381_FR, JP.BLS12_381_FR),
    (P.BN128_FP, JP.BN128_FP),
]
IDS = [p[0].name for p in PAIRS]


def sample(seed, p, n=N):
    r = random.Random(seed)
    vals = [r.randrange(p) for _ in range(n)]
    vals[:4] = [0, 1, p - 1, p - 2]
    return vals


@pytest.fixture(params=PAIRS, ids=IDS)
def fields(request):
    port, jax_params = request.param
    return Field(port, device="cpu"), get_field(jax_params)


def test_limb_roundtrip():
    p = P.BLS12_381_FP.p
    vals = sample(1, p) + [(1 << 384) - 1]
    arr = lb.ints_to_limbs(vals, 12)
    assert arr.dtype == np.int32 and arr.shape == (12, N + 1)
    assert lb.limbs_to_ints(arr) == vals
    assert lb.limbs_to_ints(torch.from_numpy(arr)) == vals


def test_mont_mul_plain_vs_jax(fields):
    """K1's plain version against the JAX Field.mul (the rl.mont_mul scan
    path): the same products, decoded."""
    f, jf = fields
    av, bv = sample(11, f.p), sample(12, f.p)
    got = f.decode(kernel_field.mont_mul_plain(f.encode(av), f.encode(bv), f))
    want = jf.decode(jf.mul(jf.encode(av), jf.encode(bv)))
    assert got == want == [x * y % f.p for x, y in zip(av, bv)]


def test_ring_ops_vs_jax(fields):
    f, jf = fields
    av, bv = sample(21, f.p), sample(22, f.p)
    a, b = f.encode(av), f.encode(bv)
    ja, jb = jf.encode(av), jf.encode(bv)
    assert f.decode(f.add(a, b)) == jf.decode(jf.add(ja, jb))
    assert f.decode(f.sub(a, b)) == jf.decode(jf.sub(ja, jb))
    assert f.decode(f.neg(a)) == jf.decode(jf.neg(ja))
    assert f.decode(f.sqr(a)) == jf.decode(jf.sqr(ja))
    assert f.decode(f.scale_small(a, 12)) == jf.decode(jf.muli(ja, 12))
    s, d = f.add_list([(a, b), (b, b)]), f.sub_list([(a, b), (b, a)])
    assert f.decode(s[1]) == [2 * y % f.p for y in bv]
    assert f.decode(d[1]) == [(y - x) % f.p for x, y in zip(av, bv)]
    prods = f.mul_list([(a, b), (a, a), (b, b)])
    assert [f.decode(t) for t in prods] == [
        f.decode(f.mul(a, b)), f.decode(f.sqr(a)), f.decode(f.sqr(b))]


def test_conversions_and_predicates(fields):
    f, jf = fields
    vals = sample(31, f.p)
    a_std = f.encode(vals, mont=False)
    a = f.to_mont(a_std)
    assert f.decode(a) == vals
    assert f.decode(f.from_mont(a), mont=False) == vals
    assert f.decode(f.from_mont(a), mont=False) == jf.decode(
        jf.from_mont(jf.encode(vals)), mont=False)
    assert f.norm(a).equal(a)
    # a value in [p, 2^(32 W)) reduces to its residue
    big = torch.from_numpy(lb.ints_to_limbs([f.p + 5, 2 * f.p + 1], f.W))
    assert lb.limbs_to_ints(f.norm(big)) == [5, 1]
    assert f.is_zero(a).tolist() == [v == 0 for v in vals]
    assert f.eq(a, a).all() and not f.eq(a, f.add(a, f.one((N,)))).any()
    pred = torch.tensor([i % 2 == 0 for i in range(N)])
    b = f.neg(a)
    assert f.decode(f.select(pred, a, b)) == [
        v if i % 2 == 0 else (-v) % f.p for i, v in enumerate(vals)]


def test_inv_and_batch_inv_vs_jax(fields):
    """Fermat inverse and batch inversion, with zeros mapped to zero
    without poisoning the batch (field.py:361-381)."""
    f, jf = fields
    vals = sample(41, f.p)
    vals[10] = 0
    a = f.encode(vals)
    want = jf.decode(jf.batch_inv(jf.encode(vals)))
    assert f.decode(f.batch_inv(a)) == want
    assert want == [pow(v, -1, f.p) if v else 0 for v in vals]
    assert f.decode(f.inv(a[:, :6])) == want[:6]


def test_field_on_cuda_raises_without_card():
    """device='cuda' (the default) never runs on the CPU instead."""
    if torch.cuda.is_available():
        assert Field(P.BN128_FP).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        Field(P.BN128_FP)
    with pytest.raises(RuntimeError, match="cuda"):
        Field(P.BN128_FP, device="cuda")


def test_mont_mul_rejects_bad_input():
    f = Field(P.BN128_FP, device="cpu")
    a = f.encode([1, 2, 3])
    with pytest.raises(ValueError):
        kernel_field.mont_mul(a, a[:, :2], f)
    with pytest.raises(TypeError):
        kernel_field.mont_mul(a.long(), a.long(), f)
    with pytest.raises(ValueError):
        kernel_field.mont_mul(a.to("meta"), a.to("meta"), f)
