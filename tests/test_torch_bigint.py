"""The port's BigInt (zikkurat_algebra_tpu_torch.ops.bigint) against the
JAX package's `bigint` at 128, 256, 384 and 768 bits, as in
tests/test_api.py::test_bigint_widths and ::test_bigint_inc_dec.

The same integers, from a numpy seed with the edge values 0, 1 and
2^bits - 1 among them, go through both packages; values are compared as
decoded integers and the carry and borrow planes as lists, exactly.  The
JAX package's scale_ext takes a 16-bit word, so the words are drawn
below 2^16 for the comparison; the port's full 32-bit words are held to
Python integers.
"""

import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu.ops.bigint import bigint as jax_bigint
from zikkurat_algebra_tpu_torch.ops.bigint import BigInt, bigint
from zikkurat_algebra_tpu_torch.utils.convert import (from_jax_bigint,
                                                      to_jax_bigint)

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)


def values(bits, seed, n=6):
    rng = np.random.default_rng(seed)
    top = 1 << bits
    rand = [int.from_bytes(rng.bytes(bits // 8), "little") for _ in range(n)]
    return [0, 1, top - 1] + rand


@pytest.mark.parametrize("bits", [128, 256, 384, 768])
def test_bigint_widths_vs_jax(bits):
    B, J = bigint(bits, "cpu"), jax_bigint(bits)
    top = 1 << bits
    av, bv = values(bits, bits), values(bits, bits + 1)[::-1]
    a, b = B.encode(av), B.encode(bv)
    ja, jb = J.encode(av), J.encode(bv)

    def same(port, jax, want):
        assert B.decode(port) == J.decode(jax) == want

    def same_plane(port, jax, want):
        assert port.tolist() == np.asarray(jax).tolist() == want

    s, c = B.add(a, b)
    js, jc = J.add(ja, jb)
    same(s, js, [(x + y) % top for x, y in zip(av, bv)])
    same_plane(c, jc, [(x + y) // top for x, y in zip(av, bv)])
    d, br = B.sub(a, b)
    jd, jbr = J.sub(ja, jb)
    same(d, jd, [(x - y) % top for x, y in zip(av, bv)])
    same_plane(br, jbr, [int(x < y) for x, y in zip(av, bv)])
    same(B.neg(a), J.neg(ja), [(-x) % top for x in av])
    same(B.mul_ext(a, b), J.mul_ext(ja, jb), [x * y for x, y in zip(av, bv)])
    same(B.mul(a, b), J.mul(ja, jb), [x * y % top for x, y in zip(av, bv)])
    same(B.sqr_ext(a), J.sqr_ext(ja), [x * x for x in av])
    for k in (17, 64 + 5):
        same(B.shift_left(a, k), J.shift_left(ja, k),
             [(x << k) % top for x in av])
        same(B.shift_right(a, k), J.shift_right(ja, k), [x >> k for x in av])

    rng = np.random.default_rng(bits + 2)
    w16 = rng.integers(0, 1 << 16, len(av)).astype(np.uint32)
    w16[:2] = (0, 0xFFFF)
    same(B.scale_ext(torch.from_numpy(w16.astype(np.int64)), a),
         J.scale_ext(w16, ja), [int(w) * x for w, x in zip(w16, av)])
    w32 = rng.integers(0, 1 << 32, len(av), dtype=np.uint64)
    w32[0] = (1 << 32) - 1
    assert B.decode(B.scale_ext(torch.from_numpy(w32.astype(np.int64)), a)) \
        == [int(w) * x for w, x in zip(w32, av)]

    for name in ("is_zero", "is_one"):
        same_plane(getattr(B, name)(a), getattr(J, name)(ja),
                   [x == (name == "is_one") for x in av])
    same_plane(B.eq(a, a), J.eq(ja, ja), [True] * len(av))
    same_plane(B.geq(a, b), J.geq(ja, jb), [x >= y for x, y in zip(av, bv)])


def test_bigint_inc_dec_vs_jax():
    B, J = bigint(256, "cpu"), jax_bigint(256)
    top = 1 << 256
    av = values(256, 3)
    a, ja = B.encode(av), J.encode(av)
    for port, jax, want, out in (
            (B.inc(a), J.inc(ja), [(v + 1) % top for v in av],
             [(v + 1) // top for v in av]),
            (B.dec(a), J.dec(ja), [(v - 1) % top for v in av],
             [int(v == 0) for v in av])):
        assert B.decode(port[0]) == J.decode(jax[0]) == want
        assert port[1].tolist() == np.asarray(jax[1]).tolist() == out


def test_bigint_convert_and_cache():
    """JAX BigInt planes -> port limbs -> JAX planes, the same integers;
    the port's product of the carried operands equals the JAX one; the
    cache is keyed by (bits, device) and a width not a multiple of 64
    raises."""
    B, J = bigint(384, "cpu"), jax_bigint(384)
    av, bv = values(384, 5), values(384, 6)
    ja, jb = J.encode(av), J.encode(bv)
    a = torch.from_numpy(from_jax_bigint(ja))
    b = torch.from_numpy(from_jax_bigint(jb))
    assert B.decode(a) == av
    assert np.array_equal(to_jax_bigint(a), np.asarray(ja))
    assert J.decode(to_jax_bigint(B.mul_ext(a, b))) == \
        J.decode(J.mul_ext(ja, jb))
    assert bigint(384, "cpu") is B and bigint(384, torch.device("cpu")) is B
    assert B.W == 12 and B.encode(5).shape == (12,)
    with pytest.raises(ValueError):
        BigInt(100, "cpu")
