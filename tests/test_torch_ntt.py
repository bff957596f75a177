"""The port's NTT (zikkurat_algebra_tpu_torch.ops.ntt) and the plain
version of kernel K5 (ops/kernel_ntt.py) against the JAX package and the
oracle.

Inputs are made from numpy seeds and fed to both packages; results are
compared as decoded integers mod p, exactly.  JAX domains are built
fresh, never through the JAX `get_domain` cache, which other tests can
leave holding values traced under `shard_map`.  On the CPU every stage
runs K5's plain version; tests/test_torch_gpu.py holds the kernel
against it on the card.
"""

import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu import params as JP
from zikkurat_algebra_tpu.ops.field import get_field
from zikkurat_algebra_tpu.ops.ntt import NTTDomain as JaxNTTDomain
from zikkurat_algebra_tpu.ops.pallas_field import butterfly_pallas
from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.errors import DimensionError, DomainSizeError
from zikkurat_algebra_tpu_torch.ops import kernel_ntt
from zikkurat_algebra_tpu_torch.ops.field import Field
from zikkurat_algebra_tpu_torch.ops.ntt import NTTDomain, get_domain
from zikkurat_algebra_tpu_torch.oracle.ntt import intt, ntt, subgroup_gen

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)


def rand_ints(seed, p, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % p for _ in range(n)]


@pytest.fixture(scope="module")
def fr():
    return Field(P.BLS12_381_FR, device="cpu")


def test_ntt_stage_plain_vs_jax_butterfly(fr):
    """The last stage of a 512-point transform is one block: K5's plain
    version on it equals the JAX Pallas butterfly (interpret mode) on
    N = 256 as integers mod p."""
    f, jf = fr, get_field(JP.BLS12_381_FR)
    N = 256
    xs = rand_ints(1, f.p, 3 * N)
    u, v, tw = xs[:N], xs[N:2 * N], xs[2 * N:]
    hi, lo = butterfly_pallas(jf.encode(u), jf.encode(v), jf.encode(tw),
                              jf.p_np, jf.pinv15, tile=128, interpret=True)
    x = f.encode(u + v).reshape(f.W, 1, 2 * N, 1).contiguous()
    out = kernel_ntt.ntt_stage_plain(x, f.encode(tw), 9, f)
    assert out is x
    got = f.decode(x)
    assert got[:N] == jf.decode(hi) == [
        (a + b * t) % f.p for a, b, t in zip(u, v, tw)]
    assert got[N:] == jf.decode(lo) == [
        (a - b * t) % f.p for a, b, t in zip(u, v, tw)]


@pytest.mark.parametrize("B,S,lanes", [(1, 8, 1), (2, 16, 1), (3, 8, 4)])
def test_ntt_stage_plain_semantics(fr, B, S, lanes):
    """Every stage, batch and lane of the plain version against the
    butterfly written out on ints: row j of each block of 2 half rows
    becomes u + v tw[j], row j + half becomes u - v tw[j]."""
    f = fr
    vals = np.array(rand_ints(2, f.p, B * S * lanes), dtype=object).reshape(
        B, S, lanes)
    for s in range(1, S.bit_length()):
        half = 1 << (s - 1)
        tw = rand_ints(10 + s, f.p, half)
        want = vals.copy()
        for blk in range(0, S, 2 * half):
            for j in range(half):
                u, v = vals[:, blk + j], vals[:, blk + j + half]
                want[:, blk + j] = (u + v * tw[j]) % f.p
                want[:, blk + j + half] = (u - v * tw[j]) % f.p
        got = kernel_ntt.ntt_stage_plain(
            f.encode(list(vals.reshape(-1))).reshape(f.W, B, S, lanes)
            .contiguous(), f.encode(tw), s, f)
        assert f.decode(got) == list(want.reshape(-1))


@pytest.mark.parametrize("m", [0, 1, 3, 6])
def test_ntt_radix2_vs_jax_and_oracle(fr, m):
    """Radix-2 NTT and inverse on a batch of two against a fresh JAX
    radix-2 domain and the oracle; BN128/Fr against the oracle."""
    f, jf = fr, get_field(JP.BLS12_381_FR)
    n = 1 << m
    xs = rand_ints(20 + m, f.p, 2 * n)
    dom = NTTDomain(f, m)
    jdom = JaxNTTDomain(jf, m, four_step=False)
    assert dom.gen == jdom.gen == subgroup_gen(P.BLS12_381_FR, m)
    x = f.encode(xs).reshape(f.W, 2, n)
    jx = jf.encode(xs).reshape(jf.L, 2, n)
    got = f.decode(dom.ntt(x))
    assert got == jf.decode(jdom.ntt(jx))
    assert got == ntt(f.p, dom.gen, xs[:n]) + ntt(f.p, dom.gen, xs[n:])
    back = f.decode(dom.intt(x))
    assert back == jf.decode(jdom.intt(jx))
    assert back == intt(f.p, dom.gen, xs[:n]) + intt(f.p, dom.gen, xs[n:])

    g = Field(P.BN128_FR, device="cpu")
    ys = rand_ints(30 + m, g.p, n)
    gdom = NTTDomain(g, m)
    assert g.decode(gdom.ntt(g.encode(ys)).reshape(g.W, n)) == ntt(
        g.p, gdom.gen, ys)


@pytest.mark.parametrize("m", [2, 5])
def test_ntt_four_step_vs_radix2_and_oracle(fr, m):
    """The four-step schedule equals the radix-2 one limb for limb, and
    the oracle, forward and inverse, on a batch of three."""
    f = fr
    n = 1 << m
    xs = rand_ints(40 + m, f.p, 3 * n)
    x = f.encode(xs).reshape(f.W, 3, n)
    four, radix2 = NTTDomain(f, m, four_step=True), NTTDomain(f, m)
    assert four.four_step and not radix2.four_step
    y = four.ntt(x)
    assert torch.equal(y, radix2.ntt(x))
    assert f.decode(y) == sum((ntt(f.p, four.gen, xs[i * n:(i + 1) * n])
                               for i in range(3)), [])
    back = four.intt(y)
    assert torch.equal(back, radix2.intt(y))
    assert f.decode(back) == xs


def test_domain_cache_and_errors(fr):
    f = fr
    d = get_domain(f, 4)
    assert get_domain(f, 4) is d and not d.four_step
    assert get_domain(Field(P.BN128_FR, device="cpu"), 4) is not d
    with pytest.raises(DomainSizeError):
        d.ntt(f.encode(list(range(8))))
    with pytest.raises(DimensionError):
        d.intt(f.encode(list(range(16)))[:4])       # 4 limbs, not 8
    with pytest.raises(DomainSizeError):
        NTTDomain(f, 33)                             # 2-adicity is 32
    with pytest.raises(DomainSizeError):
        NTTDomain(Field(P.BLS12_381_FP, device="cpu"), 2)   # no FFT domain
    with pytest.raises(DomainSizeError):
        ntt(f.p, 5, [1, 2, 3])
    x = f.encode(list(range(8))).reshape(f.W, 1, 8, 1).contiguous()
    tw = f.encode([1, 2])
    with pytest.raises(ValueError):
        kernel_ntt.ntt_stage(x, tw, 1, f)            # table of stage 2
    with pytest.raises(ValueError):
        kernel_ntt.ntt_stage(x, tw, 4, f)            # 8 rows: stages 1..3
    with pytest.raises(ValueError):
        kernel_ntt.ntt_stage(x[:, :, :6].contiguous(), f.encode([1]), 1, f)
    with pytest.raises(TypeError):
        kernel_ntt.ntt_stage(x.long(), tw.long(), 2, f)
    with pytest.raises(ValueError):
        kernel_ntt.ntt_stage(x.to("meta"), tw.to("meta"), 2, f)
