"""Kernels K1 to K5 on the card against their plain torch versions (K2
and K4 as points, after `to_affine`; the others limb for limb; K1 at
every width it takes), small G1 and G2 MSMs and NTTs and the G1
decompression and subgroup test on the card against the oracle.

Every test here is marked `gpu` and skips, from inside the `cuda_device`
fixture, on a host without a CUDA card.  The file imports neither JAX nor
the JAX package, so on the H100 host it runs without them:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest \
        -o addopts="" -p no:cacheprovider -q
"""

import os
import random

import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.ops import (kernel_curve, kernel_field,
                                            kernel_ntt, kernel_sort)
from zikkurat_algebra_tpu_torch.ops import limbs as lb
from zikkurat_algebra_tpu_torch.ops.curve import CurveKernels
from zikkurat_algebra_tpu_torch.ops.field import Field
from zikkurat_algebra_tpu_torch.ops.ntt import NTTDomain
from zikkurat_algebra_tpu_torch.oracle.ntt import intt as oracle_intt
from zikkurat_algebra_tpu_torch.oracle.ntt import ntt as oracle_ntt
from zikkurat_algebra_tpu_torch.utils.convert import load_jax_seed_points

SEEDS_G1 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench_data", "seeds_BLS12_381_g1.npz")

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 host)")
    return "cuda"


def make_scan_inputs(f, nwin, nblk, m, npts, nbuckets, seed, fp2=False,
                     steps=(0, 0, 0, 1, 2), group=None):
    """Random K2 (or, with fp2, K4) inputs: per window row, sorted |digits|
    with long runs (segments spanning blocks), random signs, distinct
    point indices, and points of which some are at infinity.  `steps`:
    the increments of |digit| along a row, drawn uniformly.  The
    coordinates are random field values (random pairs for fp2), or,
    with an oracle `group` (G1, or G2 for fp2), points of that group
    (k G for a random k, then one G more each): the complete formulas
    are associative only on the curve.  Returns numpy arrays and the
    coordinates as Python ints (pairs for fp2)."""
    rng = np.random.default_rng(seed)
    n = nblk * m
    steps = rng.choice(list(steps), size=(nwin, n))
    a = np.minimum(np.cumsum(steps, 1) + rng.integers(0, 3, (nwin, 1)),
                   nbuckets)
    sign = np.where(rng.integers(0, 2, (nwin, n)) == 1, -1, 1)
    sd = (a * sign).astype(np.int32)
    idx = np.stack([rng.permutation(npts)[:n] for _ in range(nwin)])
    xs = [int(v) % f.p for v in rng.integers(0, 1 << 62, npts)]
    ys = [(int(v) << 200 | int(v)) % f.p
          for v in rng.integers(0, 1 << 62, npts)]
    inf = rng.integers(0, 5, npts) == 0
    if group is not None:
        pt = group.scalar_mul(int(rng.integers(1, 1 << 62)), group.gen)
        for i in range(npts):
            xs[i], ys[i] = pt
            pt = group.add(pt, group.gen)
    elif fp2:
        xs, ys = ([(c, (int(v) << 120 | c) % f.p)
                   for c, v in zip(cs, rng.integers(0, 1 << 62, npts))]
                  for cs in (xs, ys))
    return xs, ys, inf, sd, idx.astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("params", [P.BLS12_381_FP, P.BLS12_381_FR,
                                    P.BN128_FP], ids=lambda p: p.name)
def test_mont_mul_kernel_vs_plain(cuda_device, params):
    """Kernel K1 equals its plain version limb for limb."""
    f = Field(params, device=cuda_device)
    rng = np.random.default_rng(3)
    vals = [(int(v) << 300 | int(v)) % f.p
            for v in rng.integers(0, 1 << 62, 4099)]
    vals[:4] = [0, 1, f.p - 1, f.p - 2]
    a = f.encode(vals)
    b = f.encode(vals[::-1])
    before = kernel_field.mont_mul.launches
    got = kernel_field.mont_mul(a, b, f)
    torch.cuda.synchronize()
    assert kernel_field.mont_mul.launches == before + 1
    assert torch.equal(got, kernel_field.mont_mul_plain(a, b, f))
    assert f.decode(got) == [x * y % f.p for x, y in zip(vals, vals[::-1])]


def corner_values(p: int, W: int):
    """0, 1, p - 1 and its neighbours, (p +- 1) / 2, 2^(32 k) +- 1 and
    all-ones limbs 2^(32 k) - 1 for k = 1 .. W, reduced mod p."""
    vals = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2]
    for k in range(1, W + 1):
        vals += [((1 << (32 * k)) + d) % p for d in (-1, 0, 1)]
    return vals


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(P.TEST_PRIMES))
def test_mont_mul_kernel_widths(cuda_device, name):
    """K1 at W = 1, 2, 3, 4 and 8 on the primes at the limb boundaries
    (above R/2: goldilocks, 2^255 + 95) equals its plain version limb for
    limb and the products mod p, on corner values."""
    f = Field(P.TEST_PRIMES[name], device=cuda_device)
    rng = np.random.default_rng(f.W)
    vals = corner_values(f.p, f.W)
    vals += [int(v) % f.p for v in rng.integers(0, 1 << 62, 64 - len(vals))]
    a = f.encode(vals, mont=False)
    b = f.encode(vals[::-1], mont=False)
    got = kernel_field.mont_mul(a, b, f)
    torch.cuda.synchronize()
    assert torch.equal(got, kernel_field.mont_mul_plain(a, b, f))
    assert lb.limbs_to_ints(got) == [x * y * f.R_inv % f.p
                                     for x, y in zip(vals, vals[::-1])]


@pytest.mark.gpu
def test_decompress_and_subgroup_g1_on_card(cuda_device):
    """The 1024 committed BLS12-381 G1 seeds compressed and decompressed
    on the card equal the seeds; the GLV subgroup test accepts them and
    agrees with the slow test on points outside the subgroup."""
    ck = CurveKernels(P.BLS12_381, device=cuda_device)
    pts = load_jax_seed_points(SEEDS_G1, ck.fp)
    x, flags = ck.compress_g1(pts)
    before = kernel_field.mont_mul.launches
    A, valid = ck.decompress_g1(x, flags)
    torch.cuda.synchronize()
    assert kernel_field.mont_mul.launches > before
    assert bool(valid.all())
    assert ck.decode_g1(A) == ck.decode_g1(pts)
    assert bool(ck.g1.is_in_subgroup(ck.g1.from_affine(A)).all())
    og, f = ck.oracle_g1, ck.oracle_g1.f
    r, outs = random.Random(4), []
    while len(outs) < 3:
        xo = r.randrange(f.p)
        yo = f.sqrt((xo * xo % f.p * xo + og.b) % f.p)
        if yo is not None:
            outs.append((xo, yo))
    B = ck.g1.from_affine(ck.encode_g1(outs))
    assert ck.g1.is_in_subgroup(B).tolist() == [False] * 3
    assert ck.g1.is_in_subgroup_slow(B).tolist() == [False] * 3


def assert_same_points(ops, got, want):
    """Projective batches equal as points: after `to_affine` the same
    infinity flags and, where finite, the same canonical x and y (equal
    limbs of canonical values: equal mod p)."""
    ga, wa = ops.to_affine(got), ops.to_affine(want)
    assert torch.equal(ga[2], wa[2])
    live = ~wa[2]
    for g, w in zip(ga[:2], wa[:2]):
        assert torch.equal(g[..., live], w[..., live])


def check_bucket_scan(ck, xs, ys, inf, sd, idx, m, nbuckets, grp="g1"):
    """K2 (g1) or K4 (g2) on the card against its plain version, buckets
    and trailers compared as points; its counter steps by one, the other
    kernel's not at all."""
    ops, enc = ((ck.g1, ck.fp.encode) if grp == "g1"
                else (ck.g2, ck.tower.encode_fp2))
    mine, other = ((kernel_curve.bucket_scan, kernel_curve.bucket_scan2)
                   if grp == "g1" else
                   (kernel_curve.bucket_scan2, kernel_curve.bucket_scan))
    args = (enc(xs), enc(ys), torch.from_numpy(inf).cuda(),
            torch.from_numpy(sd).cuda(), torch.from_numpy(idx).cuda(), m,
            nbuckets)
    before, other_before = mine.launches, other.launches
    got = kernel_curve.bucket_scan(ops, *args)
    torch.cuda.synchronize()
    assert mine.launches == before + 1 and other.launches == other_before
    want = kernel_curve.bucket_scan_plain(ops.plain(), *args)
    for g, w in zip(got, want):
        assert g[0].shape == w[0].shape
        assert_same_points(ops, g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("curve", [P.BLS12_381, P.BN128],
                         ids=lambda c: c.name)
def test_bucket_scan_kernel_vs_plain(cuda_device, curve):
    """Kernel K2 equals its plain version after `to_affine`: buckets and
    trailers, with sign, infinity and restart cases."""
    ck = CurveKernels(curve, device=cuda_device)
    nwin, nblk, m, nbuckets = 3, 40, 16, 60
    check_bucket_scan(ck, *make_scan_inputs(ck.fp, nwin, nblk, m, 700,
                                            nbuckets, seed=9,
                                            group=ck.oracle_g1), m, nbuckets)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["long_runs_512", "m1", "m24", "m7", "m3",
                                  "infinite_sub_lane", "distinct_digits"])
@pytest.mark.parametrize("grp", ["g1", "g2"])
def test_bucket_scan_kernel_cases(cuda_device, grp, case):
    """K2's (g1, 8 sub-lanes) and K4's (g2, 4 sub-lanes) sub-lanes and
    their combine against the plain version: runs that cross sub-lanes
    and blocks at block 512, blocks with fewer positions than sub-lanes
    (1 and 3; 7 for K2) or not a multiple of them (3 and 7; 24 for K2),
    a sub-lane whose points are all at infinity, every position its own
    digit."""
    ck = CurveKernels(P.BLS12_381, device=cuda_device)
    nwin, nblk, m, nbuckets, npts = 2, 6, 24, 40, 700
    steps = (0, 0, 0, 1, 2)
    if case == "long_runs_512":
        nblk, m, npts, steps = 3, 512, 1600, (0,) * 99 + (1,)
    elif case == "m1":
        nblk, m = 90, 1
    elif case == "m7":
        nblk, m = 20, 7
    elif case == "m3":
        nblk, m = 40, 3
    xs, ys, inf, sd, idx = make_scan_inputs(
        ck.fp, nwin, nblk, m, npts, nbuckets, seed=len(case), steps=steps,
        fp2=grp == "g2", group=ck.oracle_g1 if grp == "g1" else ck.oracle_g2)
    if case == "infinite_sub_lane":
        # sub-lane 1 of block 1: K2 runs 8 sub-lanes of 3, K4 4 of 6
        lo, hi = (m + 3, m + 6) if grp == "g1" else (m + 6, m + 12)
        inf[:] = False
        inf[idx[0, lo:hi]] = True
    if case == "distinct_digits":
        n = nblk * m
        sd = (np.arange(1, n + 1) * np.where(sd < 0, -1, 1)).astype(np.int32)
        nbuckets = n
    check_bucket_scan(ck, xs, ys, inf, sd, idx, m, nbuckets, grp)


@pytest.mark.gpu
def test_msm_on_card_vs_oracle(cuda_device):
    """A small G1 MSM on the card goes through both kernels and equals
    the oracle (infinity input, zero scalar, n not a block multiple)."""
    ck = CurveKernels(P.BLS12_381, device=cuda_device)
    og = ck.oracle_g1
    r = random.Random(4)
    n = 37
    pts = [og.scalar_mul(r.randrange(1, og.r), og.gen) for _ in range(n)]
    ks = [r.randrange(og.r) for _ in range(n)]
    pts[3], ks[1] = None, 0
    k1, k2 = kernel_field.mont_mul.launches, kernel_curve.bucket_scan.launches
    res = ck.msm("g1").msm_std(ck.fr.encode(ks, mont=False),
                               ck.encode_g1(pts), 5, 16)
    got = ck.decode_g1(ck.g1.to_affine(res))
    assert kernel_field.mont_mul.launches > k1
    assert kernel_curve.bucket_scan.launches == k2 + 1
    assert got == og.msm(ks, pts)


@pytest.mark.gpu
@pytest.mark.parametrize("wc,n,R,key_bits", [
    (3, 5000, 1, 15),      # n not a power of two, several tiles, 2 passes
    (2, 2048, 3, 2),       # one tile, one pass, heavy duplication
    (1, 70001, 2, 20),     # 3 passes, a ragged last tile
])
def test_sort_kernel_vs_plain(cuda_device, wc, n, R, key_bits):
    """Kernel K3 equals its plain version exactly (it is stable, so the
    payload order is determined), and its counter steps by one."""
    g = np.random.default_rng(n)
    keys = torch.from_numpy(
        g.integers(0, 1 << key_bits, (wc, n)).astype(np.int32)).cuda()
    pay = torch.from_numpy(
        g.integers(-(1 << 31), 1 << 31, (R, wc, n)).astype(np.int32)).cuda()
    before = kernel_sort.sort_key_val.launches
    sk, sp = kernel_sort.sort_key_val(keys, pay, key_bits)
    torch.cuda.synchronize()
    assert kernel_sort.sort_key_val.launches == before + 1
    wk, wp = kernel_sort.sort_key_val_plain(keys, pay)
    assert torch.equal(sk, wk) and torch.equal(sp, wp)
    with pytest.raises(ValueError):
        kernel_sort.sort_key_val(keys, pay, key_bits - 1 if key_bits > 2
                                 else 1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["all_equal", "sorted", "reverse", "n1",
                                  "below_tile", "path"])
def test_sort_kernel_edge_cases(cuda_device, case):
    """K3 equals its plain version exactly where the look-back and the
    ragged last tile are stressed: one digit for every key, keys already
    in order and in reverse, n = 1, n below one tile, and the MSM's
    shape (18 rows of 2^20 keys of 15 bits, one payload row)."""
    g = np.random.default_rng(7)
    wc, n, key_bits = 3, 20000, 15
    keys = g.integers(0, 1 << key_bits, (wc, n))
    if case == "all_equal":
        keys[:] = 12345
    elif case == "sorted":
        keys.sort(1)
    elif case == "reverse":
        keys = -np.sort(-keys, 1)
    elif case == "n1":
        keys = keys[:, :1]
    elif case == "below_tile":
        keys = keys[:, :1000]
    elif case == "path":
        keys = g.integers(0, 1 << key_bits, (18, 1 << 20))
    keys = torch.from_numpy(keys.astype(np.int32)).cuda()
    pay = torch.arange(keys.numel(), dtype=torch.int32,
                       device="cuda").view(1, *keys.shape)
    got = kernel_sort.sort_key_val(keys, pay, key_bits)
    want = kernel_sort.sort_key_val_plain(keys, pay)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("curve", [P.BLS12_381, P.BN128],
                         ids=lambda c: c.name)
def test_bucket_scan2_kernel_vs_plain(cuda_device, curve):
    """Kernel K4 equals its plain version over Fp2 after `to_affine`:
    buckets and trailers of G2 points on the curve, with sign, infinity
    and restart cases."""
    ck = CurveKernels(curve, device=cuda_device)
    nwin, nblk, m, nbuckets = 3, 40, 16, 60
    xs, ys, inf, sd, idx = make_scan_inputs(ck.fp, nwin, nblk, m, 700,
                                            nbuckets, seed=11, fp2=True,
                                            group=ck.oracle_g2)
    check_bucket_scan(ck, xs, ys, inf, sd, idx, m, nbuckets, "g2")


@pytest.mark.gpu
def test_msm_g2_on_card_vs_oracle(cuda_device):
    """A small G2 MSM on the card goes through K1, K3 and K4 and equals
    the oracle (infinity input, zero scalar, n not a block multiple)."""
    ck = CurveKernels(P.BLS12_381, device=cuda_device)
    og = ck.oracle_g2
    r = random.Random(5)
    n = 21
    pts = [og.scalar_mul(r.randrange(1, og.r), og.gen) for _ in range(n)]
    ks = [r.randrange(og.r) for _ in range(n)]
    pts[3], ks[1] = None, 0
    counts = (kernel_field.mont_mul.launches,
              kernel_sort.sort_key_val.launches,
              kernel_curve.bucket_scan2.launches)
    res = ck.msm("g2").msm_std(ck.fr.encode(ks, mont=False),
                               ck.encode_g2(pts), 5, 8)
    got = ck.decode_g2(ck.g2.to_affine(res))
    assert kernel_field.mont_mul.launches > counts[0]
    assert kernel_sort.sort_key_val.launches == counts[1] + 1
    assert kernel_curve.bucket_scan2.launches == counts[2] + 1
    assert got == og.msm(ks, pts)


def _rand_fr(f, n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % f.p for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,lanes", [
    (1, 1024, 1),          # the radix-2 transform's layout
    (3, 64, 8),            # a batch, four-step column passes
    (2, 16, 64),           # more lanes than rows
])
def test_ntt_stage_kernel_vs_plain(cuda_device, B, S, lanes):
    """Kernel K5 equals its plain version limb for limb at every stage,
    and its counter steps by one per stage; W = 12 is refused."""
    f = Field(P.BLS12_381_FR, device=cuda_device)
    x = f.encode(_rand_fr(f, B * S * lanes, S + lanes)).reshape(
        f.W, B, S, lanes)
    for s in range(1, S.bit_length()):
        tw = f.encode(_rand_fr(f, 1 << (s - 1), 100 + s))
        before = kernel_ntt.ntt_stage.launches
        got = kernel_ntt.ntt_stage(x.clone(), tw, s, f)
        torch.cuda.synchronize()
        assert kernel_ntt.ntt_stage.launches == before + 1
        assert torch.equal(got, kernel_ntt.ntt_stage_plain(x.clone(), tw, s,
                                                           f))
    g = Field(P.BLS12_381_FP, device=cuda_device)
    y = g.encode([1, 2, 3, 4]).reshape(g.W, 1, 4, 1)
    with pytest.raises(ValueError):
        kernel_ntt.ntt_stage(y, g.encode([1]), 1, g)


@pytest.mark.gpu
@pytest.mark.parametrize("m,four_step", [(10, False), (9, True), (1, False)])
def test_ntt_on_card_vs_oracle(cuda_device, m, four_step):
    """NTT and inverse on the card, batch of two, against the oracle; a
    radix-2 transform launches K5 once per stage."""
    f = Field(P.BLS12_381_FR, device=cuda_device)
    n = 1 << m
    xs = _rand_fr(f, 2 * n, m)
    dom = NTTDomain(f, m, four_step=four_step).prepare()
    x = f.encode(xs).reshape(f.W, 2, n)
    before = kernel_ntt.ntt_stage.launches
    y = dom.ntt(x)
    torch.cuda.synchronize()
    assert kernel_ntt.ntt_stage.launches == before + m
    want = oracle_ntt(f.p, dom.gen, xs[:n]) + oracle_ntt(f.p, dom.gen, xs[n:])
    assert f.decode(y) == want
    assert f.decode(dom.intt(y)) == xs
    assert f.decode(dom.intt(x))[:n] == oracle_intt(f.p, dom.gen, xs[:n])
