"""Field exponentiation of the port (Field.pow_bits, pow_static, inv and
sqrt) against Python's pow through the oracle, at W = 1, 2, 3, 4, 8 and
12, and the split of an exponent into the launches of kernel P2
(`kernel_field._pow_chunks`) replayed on Python ints.

On the CPU `Field.pow_bits` runs `kernel_field.field_pow_plain`, the
square-and-multiply loop over the plain product that P2 is held to limb
for limb on the card (tests/test_torch_gpu.py).  The file imports
neither JAX nor the JAX package.
"""

import random

import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.ops import kernel_field
from zikkurat_algebra_tpu_torch.ops.field import Field, int_to_bits
from zikkurat_algebra_tpu_torch.oracle.field import Fp

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)

# one field per kernel width: W = 1, 2, 3, 4, 8, 12
FIELDS = [P.TEST_PRIMES["M31"], P.TEST_PRIMES["goldilocks"],
          P.TEST_PRIMES["P64+"], P.TEST_PRIMES["M127"], P.BLS12_381_FR,
          P.BLS12_381_FP]
FIELD_IDS = [f"W{Field(prm, 'cpu').W}" for prm in FIELDS]
BLOCK_BITS = 32 * kernel_field.POW_WORDS
# longer than one launch's parameter block (two launches of P2), and
# sparse, so that the plain chain stays short on the CPU
LONG = 1 << BLOCK_BITS + 1 | random.Random(17).getrandbits(64) | 1
EXPONENTS = {"0": lambda p: 0, "1": lambda p: 1, "2": lambda p: 2,
             "p-2": lambda p: p - 2, "(p+1)/4": lambda p: (p + 1) // 4,
             "long": lambda p: LONG}
# (field, exponent) cases: every exponent at every width, the long one at
# W = 1, 8 and 12 (a product of the plain version costs about 1 ms here)
CASES = [(prm, e) for prm, w in zip(FIELDS, FIELD_IDS) for e in EXPONENTS
         if e != "long" or w in ("W1", "W8", "W12")]


def batch(p: int, seed: int, n: int = 6):
    """0 and 1, p - 1, then random values below p."""
    r = random.Random(seed)
    return [0, 1, p - 1] + [r.randrange(p) for _ in range(n - 3)]


@pytest.mark.parametrize("prm,ename", CASES, ids=[
    f"{Field(prm, 'cpu').W}-{e}" for prm, e in CASES])
def test_pow_bits_vs_python_pow(prm, ename):
    """pow_bits, pow_static and inv (for p - 2) equal Python's pow
    through the oracle: a^0 = 1 for a = 0 too, 0^e = 0 for e > 0,
    inv(0) = 0.  One chain a case, by the entry point its exponent
    comes through in the port."""
    f, o = Field(prm, device="cpu"), Fp(prm)
    e = EXPONENTS[ename](f.p)
    vals = batch(f.p, e % 1009)
    a = f.encode(vals)
    if ename == "p-2":
        got, want = f.inv(a), [o.inv(x) for x in vals]
    elif ename == "(p+1)/4":
        got, want = f.pow_static(a, e), [o.pow(x, e) for x in vals]
    else:
        got, want = f.pow_bits(a, int_to_bits(e)), [o.pow(x, e) for x in vals]
    assert got.shape == a.shape and got.dtype == torch.int32
    assert f.decode(got) == want == [pow(x, e, f.p) for x in vals]


@pytest.mark.parametrize("prm", [FIELDS[0], FIELDS[2], FIELDS[5]],
                         ids=["W1", "W3", "W12"])
def test_sqrt_vs_oracle(prm):
    """sqrt of squares and of a non-residue, against the oracle: the
    fixed power for p = 3 mod 4 (W = 1, 12), Tonelli-Shanks' first power
    and its one level for 2^64 + 13 (W = 3, two-adicity 2)."""
    f, o = Field(prm, device="cpu"), Fp(prm)
    vals = batch(f.p, 5, 4)
    sq = [x * x % f.p for x in vals] + [prm.multiplicative_gen % f.p]
    root, ok = f.sqrt(f.encode(sq))
    assert ok.tolist() == [True] * len(vals) + [False]
    assert [r * r % f.p for r in f.decode(root)][:-1] == sq[:-1]
    assert o.sqrt(sq[-1]) is None


@pytest.mark.parametrize("e", [0, 1, 2, 3, (1 << BLOCK_BITS) - 1,
                               1 << BLOCK_BITS, LONG,
                               (1 << 2 * BLOCK_BITS + 5) + 12345],
                         ids=["0", "1", "2", "3", "block-1", "block",
                              "long", "three_blocks"])
def test_pow_chunks_replay(e):
    """P2's launches for e, replayed as the kernel runs them on Python
    ints (the top chunk starts at a and skips its top bit; a later chunk
    squares the previous output once per bit), give a^e; e = 0 is one
    launch of 0 bits, and a launch holds at most 32 POW_WORDS bits."""
    p = P.BLS12_381_FP.p
    chunks = kernel_field._pow_chunks(e)
    assert len(chunks) == max(1, -(-e.bit_length() // BLOCK_BITS))
    assert chunks[0][0] == (e.bit_length() - 1) % BLOCK_BITS + 1 if e else \
        chunks == [(0, chunks[0][1])]
    assert all(nb <= BLOCK_BITS for nb, _ in chunks)
    for x in (0, 1, 7, p - 1, 0x1234567 << 200):
        acc = None
        for nbits, words in chunks:
            bits = sum(int(w) << 32 * i for i, w in enumerate(words))
            assert bits >> nbits == 0
            if nbits == 0:
                acc = 1
                continue
            i = nbits - 1
            if acc is None:
                acc, i = x, i - 1
            for k in range(i, -1, -1):
                acc = acc * acc % p
                if bits >> k & 1:
                    acc = acc * x % p
        assert acc == pow(x, e, p)


def test_field_pow_rejects_bad_input():
    """The checks of mont_mul: dtype, width, device."""
    f = Field(P.BN128_FP, device="cpu")
    a = f.encode([1, 2, 3])
    with pytest.raises(TypeError):
        kernel_field.field_pow(a.long(), 5, f)
    with pytest.raises(ValueError):
        kernel_field.field_pow(a[:4], 5, f)
    with pytest.raises(ValueError):
        kernel_field.field_pow(a.to("meta"), 5, f)
    assert f.plain()._pow is kernel_field.field_pow_plain
    assert f._pow is kernel_field.field_pow
    assert np.array_equal(int_to_bits(0), [0])
