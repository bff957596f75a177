"""Kernels K1 to K5 and P2 on the card against their plain torch versions
(K2 and K4 as points, after `to_affine`; the others limb for limb; K1 and
P2 at every width they take, K5 at W = 8 and 2, one stage and every pass
of stages a tile holds), P2's launches in an affine conversion and in a
blob operation, small G1 and G2 MSMs and NTTs
and the G1 decompression and subgroup test on the card against the
oracle, and the pairing and KZG on the card against the port on the CPU.

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


# one field per width of KERNEL_WIDTHS: W = 1, 2, 3, 4, 8, 12
POW_FIELDS = [P.TEST_PRIMES["M31"], P.TEST_PRIMES["goldilocks"],
              P.TEST_PRIMES["P64+"], P.TEST_PRIMES["M127"], P.BLS12_381_FR,
              P.BLS12_381_FP]


@pytest.mark.gpu
@pytest.mark.parametrize("params", POW_FIELDS, ids=lambda p: p.name)
def test_field_pow_kernel_vs_plain(cuda_device, params):
    """P2 equals its plain version (the square-and-multiply loop over the
    plain product) limb for limb at every width, for batches of 1, 6 and
    4097 (0 and 1 first), on the exponents 0, 1, 2, p - 2, (p + 1) / 4
    and one longer than a launch's parameter block (two launches)."""
    f = Field(params, device=cuda_device)
    rng = np.random.default_rng(f.W + 40)
    vals = corner_values(f.p, f.W)
    vals += [(int(v) << 62 | int(w)) % f.p for v, w in
             rng.integers(0, 1 << 62, (4097 - len(vals), 2))]
    a = f.encode(vals)
    block = 32 * kernel_field.POW_WORDS
    long_e = 1 << block + 40 | int(rng.integers(1, 1 << 62))
    for e in (0, 1, 2, f.p - 2, (f.p + 1) // 4, long_e):
        want = kernel_field.field_pow_plain(a, e, f)
        for n in (1, 6, 4097):
            before = kernel_field.field_pow.launches
            got = kernel_field.field_pow(a[:, :n].contiguous(), e, f)
            torch.cuda.synchronize()
            assert kernel_field.field_pow.launches == before + 1 + (
                e == long_e)
            assert torch.equal(got, want[:, :n]), (e, n)
        assert f.decode(want[:, :8]) == [pow(v, e, f.p) for v in vals[:8]]


@pytest.mark.gpu
def test_field_pow_launch_counts_on_card(cuda_device):
    """A batch-1 G1 to_affine launches P2 once and K1 at most 3 times.
    One blob operation of the benchmark's cell (prove_blobs of 6 blobs of
    4096 elements over the frozen setup) launches P2 4 times (two affine
    conversions, the decompression's square root, the opening's
    inversion) and K1 at most 100 times, and its bytes equal
    zkbench/eip4844.py."""
    import json
    from pathlib import Path

    from zkbench import eip4844 as ref, inputs
    from zikkurat_algebra_tpu_torch.protocols import eip4844
    from zikkurat_algebra_tpu_torch.utils import profiling

    ck = CurveKernels(P.BLS12_381, device=cuda_device)
    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "zkbench" / "configs" /
                      "bls12_381-kzg-blob4096.json").read_text())
    srs = inputs.load_srs(root, cfg)
    setup = eip4844.load_setup(srs["lagrange_g1"], device=cuda_device)
    rng = random.Random(71)
    blobs = [ref.polynomial_to_blob([rng.randrange(ck.fr.p)
                                     for _ in range(setup.n)])
             for _ in range(6)]
    eip4844.prove_blobs(setup, blobs[:1])               # warm
    outs, tots = [], []
    for fn in (lambda: ck.g1.to_affine(ck.generator(1)),
               lambda: eip4844.prove_blobs(setup, blobs)):
        profiling.reset()
        with profiling.recording():
            outs.append(fn())
        tots.append(profiling.totals())
        profiling.reset()
    (aff, (cms, proofs)), affine = outs, tots[0]["curve.to_affine"]
    op = tots[1]["kzg.blob_prove"]["launches"]
    assert ck.decode_g1(aff) == [ck.oracle_g1.gen]
    assert affine["calls"] == 1 and affine["launches"]["field_pow"] == 1
    assert affine["launches"]["mont_mul"] <= 3, affine
    assert op["field_pow"] == 4 and op["mont_mul"] <= 100, op
    prover = ref.Prover(srs["tau"], setup.n)
    assert [(bytes(c.cpu().numpy()), bytes(p.cpu().numpy()))
            for c, p in zip(cms, proofs)] == [prover.prove(b) for b in blobs]


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
    """Kernel K5 run one stage per launch equals its plain version limb for
    limb at every stage, and its counter steps by one per launch; W = 12
    is refused."""
    f = Field(P.BLS12_381_FR, device=cuda_device)
    x = f.encode(_rand_fr(f, B * S * lanes, S + lanes)).reshape(
        f.W, B, S, lanes)
    for s in range(1, S.bit_length()):
        tw = f.encode(_rand_fr(f, 1 << (s - 1), 100 + s))
        before = kernel_ntt.ntt_stages.launches
        got = kernel_ntt.ntt_stages(x.clone(), [None] * (s - 1) + [tw],
                                    s - 1, 1, f)
        torch.cuda.synchronize()
        assert kernel_ntt.ntt_stages.launches == before + 1
        assert torch.equal(got, kernel_ntt.ntt_stage_plain(x.clone(), tw, s,
                                                           f))
    g = Field(P.BLS12_381_FP, device=cuda_device)
    y = g.encode([1, 2, 3, 4]).reshape(g.W, 1, 4, 1)
    with pytest.raises(ValueError):
        kernel_ntt.ntt_stages(y, [g.encode([1])], 0, 1, g)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("prm", ["BLS12_381_FR", "goldilocks"])
def test_ntt_stages_kernel_every_pass(cuda_device, prm, lanes):
    """Kernel K5 running stages s0+1 .. s0+k in one launch equals its
    plain version limb for limb at every (s0, k) a tile holds, for S =
    2^12 rows in a batch (goldilocks: p above R / 2, p - 1 included); one
    launch each; k beyond the tile and W = 12 are refused."""
    f = Field(P.TEST_PRIMES[prm] if prm == "goldilocks" else P.BLS12_381_FR,
              device=cuda_device)
    B, m = (3, 12) if lanes == 1 else (2, 12)
    S = 1 << m
    vals = _rand_fr(f, B * S * lanes, 300 + lanes)
    vals[0] = f.p - 1
    x = f.encode(vals).reshape(f.W, B, S, lanes)
    tables = [f.encode(_rand_fr(f, 1 << (s - 1), 400 + s))
              for s in range(1, m + 1)]
    lt = kernel_ntt.tile_log(f.W)
    for s0 in range(m):
        for k in range(1, min(lt, m - s0) + 1):
            before = kernel_ntt.ntt_stages.launches
            got = kernel_ntt.ntt_stages(x.clone(), tables, s0, k, f)
            torch.cuda.synchronize()
            assert kernel_ntt.ntt_stages.launches == before + 1
            want = kernel_ntt.ntt_stages_plain(x.clone(), tables, s0, k, f)
            assert torch.equal(got, want), (s0, k)
    y = x.clone()
    for s0, k in kernel_ntt.pass_plan(m, lanes.bit_length() - 1, lt):
        kernel_ntt.ntt_stages(y, tables, s0, k, f)
    assert torch.equal(y, kernel_ntt.ntt_stages_plain(x.clone(), tables, 0,
                                                      m, f))
    big = [f.encode(_rand_fr(f, 1 << (s - 1), 500 + s))
           for s in range(1, lt + 3)]
    z = f.encode(_rand_fr(f, 1 << (lt + 2), 9)).reshape(f.W, 1, -1, 1)
    with pytest.raises(ValueError):
        kernel_ntt.ntt_stages(z, big, 0, lt + 1, f)
    g = Field(P.BLS12_381_FP, device=cuda_device)
    w = g.encode([1, 2, 3, 4]).reshape(g.W, 1, 4, 1)
    with pytest.raises(ValueError):
        kernel_ntt.ntt_stages(w, [g.encode([1]), g.encode([1, 2])], 0, 2, g)


@pytest.mark.gpu
@pytest.mark.parametrize("m,four_step", [(10, False), (9, True), (1, False)])
def test_ntt_on_card_vs_oracle(cuda_device, m, four_step):
    """NTT and inverse on the card, batch of two, against the oracle; a
    transform launches K5 once per pass of `pass_plan`."""
    f = Field(P.BLS12_381_FR, device=cuda_device)
    n = 1 << m
    xs = _rand_fr(f, 2 * n, m)
    dom = NTTDomain(f, m, four_step=four_step).prepare()
    x = f.encode(xs).reshape(f.W, 2, n)
    before = kernel_ntt.ntt_stages.launches
    y = dom.ntt(x)
    torch.cuda.synchronize()
    if four_step:
        mB = m // 2
        lt = kernel_ntt.tile_log(f.W)
        passes = (len(kernel_ntt.pass_plan(m - mB, mB, lt))
                  + len(kernel_ntt.pass_plan(mB, m - mB, lt)))
    else:
        passes = len(kernel_ntt.pass_plan(m, 0, kernel_ntt.tile_log(f.W)))
    assert kernel_ntt.ntt_stages.launches == before + passes
    want = oracle_ntt(f.p, dom.gen, xs[:n]) + oracle_ntt(f.p, dom.gen, xs[n:])
    assert f.decode(y) == want
    assert f.decode(dom.intt(y)) == xs
    assert f.decode(dom.intt(x))[:n] == oracle_intt(f.p, dom.gen, xs[:n])


@pytest.mark.gpu
def test_ntt_stage_kernel_goldilocks(cuda_device):
    """K5 at W = 2 (goldilocks, p above R / 2) equals its plain version at
    every stage, and a goldilocks NTT round trip on the card equals the
    oracle."""
    f = Field(P.TEST_PRIMES["goldilocks"], device=cuda_device)
    assert f.W == 2
    vals = _rand_fr(f, 3 * 256, 5)
    vals[0] = f.p - 1
    x = f.encode(vals).reshape(f.W, 3, 256, 1)
    for s in range(1, 9):
        tw = f.encode(_rand_fr(f, 1 << (s - 1), 200 + s))
        before = kernel_ntt.ntt_stages.launches
        got = kernel_ntt.ntt_stages(x.clone(), [None] * (s - 1) + [tw],
                                    s - 1, 1, f)
        torch.cuda.synchronize()
        assert kernel_ntt.ntt_stages.launches == before + 1
        assert torch.equal(got, kernel_ntt.ntt_stage_plain(x.clone(), tw, s,
                                                           f))
    m = 9
    xs = _rand_fr(f, 1 << m, 7)
    dom = NTTDomain(f, m).prepare()
    y = dom.ntt(f.encode(xs))
    assert f.decode(y) == oracle_ntt(f.p, dom.gen, xs)
    assert f.decode(dom.intt(y)) == xs


def _pairing_inputs(ck, n, seed):
    """n G1 and n G2 oracle points, the last pair with P at infinity."""
    rng = random.Random(seed)
    ps = [ck.oracle_g1.rnd(rng) for _ in range(n)]
    qs = [ck.oracle_g2.rnd(rng) for _ in range(n)]
    ps[-1] = None
    return ps, qs


@pytest.mark.gpu
@pytest.mark.parametrize("curve", [P.BLS12_381, P.BN128],
                         ids=["BLS12-381", "BN128"])
def test_pairing_on_card_vs_cpu(cuda_device, curve):
    """miller_loop, pairing and pairing_product on the card equal the port
    on the CPU, decoded; a batch of Fp12 products is one K1 launch."""
    from zikkurat_algebra_tpu_torch.ops.pairing import get_pairing

    gpu, cpu = get_pairing(curve, cuda_device), get_pairing(curve, "cpu")
    ps, qs = _pairing_inputs(gpu.ck, 3, 31)
    args = {k: (pk.ck.encode_g1(ps), pk.ck.encode_g2(qs))
            for k, pk in (("gpu", gpu), ("cpu", cpu))}
    dec = cpu.tower.decode_fp12
    f = gpu.miller_loop(*args["gpu"])
    assert dec(f.cpu()) == dec(cpu.miller_loop(*args["cpu"]))
    before = kernel_field.mont_mul.launches
    gpu.tower.fp12.mul_list([(f, f), (f, gpu.tower.fp12_conj(f))])
    torch.cuda.synchronize()
    assert kernel_field.mont_mul.launches == before + 1
    assert dec(gpu.pairing(*args["gpu"]).cpu()) == dec(
        cpu.pairing(*args["cpu"]))
    assert dec(gpu.pairing_product(*args["gpu"]).cpu()) == dec(
        cpu.pairing_product(*args["cpu"]))


@pytest.mark.gpu
def test_kzg_on_card_vs_cpu(cuda_device):
    """new_setup (both Lagrange routes), commit_poly, commit_values,
    opening_proof and verify_proof on the card equal the port on the CPU
    (BN128, 2^3 points)."""
    from zikkurat_algebra_tpu_torch.protocols import kzg

    rng = random.Random(41)
    curve = P.BN128
    tau = rng.randrange(2, curve.fr.p)
    out = {}
    for dev in (cuda_device, "cpu"):
        s = kzg.new_setup(curve, 3, tau, device=dev)
        sg = kzg.new_setup(curve, 3, tau, use_group_fft=True, device=dev)
        ck = CurveKernels(curve, device=dev)
        fr = ck.fr
        r = random.Random(42)
        coeffs = fr.encode([r.randrange(fr.p) for _ in range(8)])
        x0 = fr.encode(r.randrange(fr.p))
        com = kzg.commit_poly(s, coeffs)
        y0, proof = kzg.opening_proof(s, coeffs, x0)
        aff = lambda pt: ck.decode_g1(ck.g1.to_affine(pt))
        out[dev] = (ck.decode_g1(s.tau_g1), ck.decode_g1(s.lagrange_tau_g1),
                    ck.decode_g1(sg.lagrange_tau_g1), ck.decode_g2(s.tau_g2),
                    aff(com), aff(kzg.commit_values(s, coeffs)),
                    fr.decode(y0), aff(proof),
                    bool(kzg.verify_proof(s, com, proof, x0, y0)))
    assert out[cuda_device] == out["cpu"]
    assert out["cpu"][-1] and out["cpu"][1] == out["cpu"][2]


@pytest.mark.gpu
def test_bigint_768_on_card_vs_cpu(cuda_device):
    """BigInt at 768 bits on 2^16 values: every operation on the card
    equals the CPU's result limb for limb (plain torch ops on both)."""
    from zikkurat_algebra_tpu_torch.ops.bigint import bigint

    rng = np.random.default_rng(51)
    n = 1 << 16
    a, b = (torch.from_numpy(rng.integers(0, 1 << 32, (24, n), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
            for _ in range(2))
    w = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.int64))
    out = {}
    for dev in (cuda_device, "cpu"):
        B = bigint(768, dev)
        x, y, v = a.to(B.device), b.to(B.device), w.to(B.device)
        out[dev] = [B.add(x, y), B.sub(x, y), B.neg(x), B.mul(x, y),
                    B.mul_ext(x, y), B.sqr_ext(x), B.scale_ext(v, x),
                    B.inc(x), B.dec(x), B.shift_left(x, 77),
                    B.shift_right(x, 77), B.geq(x, y)]
    flat = lambda r: [t.cpu() for t in r] if isinstance(r, tuple) else [r.cpu()]
    for got, want in zip(out[cuda_device], out["cpu"]):
        assert all(torch.equal(g, w_) for g, w_ in zip(flat(got), flat(want)))


@pytest.mark.gpu
def test_curve_api_on_card_launches_kernels(cuda_device):
    """bls12_381("cuda"): msm_g1 and msm_g2 of 2^6 committed seed points
    launch K1, K3 and K2 or K4 and equal the oracle's MSM; ntt_domain(12)
    launches K5 and equals the same API on the CPU."""
    from zikkurat_algebra_tpu_torch import api

    a, cpu = api.bls12_381(cuda_device), api.bls12_381("cpu")
    rng = random.Random(52)
    n = 1 << 6
    ks = [rng.randrange(a.fr.p) for _ in range(n)]
    vals = [rng.randrange(a.fr.p) for _ in range(1 << 12)]
    counts = (kernel_field.mont_mul, kernel_sort.sort_key_val,
              kernel_curve.bucket_scan, kernel_curve.bucket_scan2,
              kernel_ntt.ntt_stages)
    for fn in counts:
        fn.launches = 0
    k = a.fr.encode(ks)
    got, want = [], []
    for grp, msm, dec, og in (("g1", a.msm_g1, a.decode_g1, a.curves.oracle_g1),
                              ("g2", a.msm_g2, a.decode_g2, a.curves.oracle_g2)):
        seeds = load_jax_seed_points(SEEDS_G1.replace("_g1", f"_{grp}"), a.fp)
        pts = tuple(t[..., :n].contiguous() for t in seeds)
        r = msm.msm_mont(k, pts)
        ops = a.g1 if grp == "g1" else a.g2
        got.append(dec(ops.to_affine(tuple(t.unsqueeze(-1) for t in r))))
        want.append([og.msm(ks, dec(pts))])
    y = a.ntt_domain(12).ntt(a.fr.encode(vals))
    torch.cuda.synchronize()
    assert all(fn.launches > 0 for fn in counts), [fn.launches for fn in counts]
    assert got == want
    assert a.fr.decode(y) == cpu.fr.decode(cpu.ntt_domain(12).ntt(
        cpu.fr.encode(vals)))


def _tiled_seed_points(ck, n):
    """The 1024 seed G1 points of `bench_data/` tiled to n."""
    seeds = load_jax_seed_points(SEEDS_G1, ck.fp)
    reps = -(-n // seeds[0].shape[-1])
    return tuple(t.repeat(*([1] * (t.ndim - 1)), reps)[..., :n].contiguous()
                 for t in seeds)


def _scalars(shape, seed, device):
    """Random canonical scalar limbs (8, *shape) below r."""
    g = torch.Generator().manual_seed(seed)
    k = torch.randint(-2**31, 2**31 - 1, (8,) + shape, generator=g,
                      dtype=torch.int32)
    k[7] &= 0x3FFFFFFF
    return k.to(device)


def _msm_launches(fn):
    """The result of fn() and the launches inside its msm.std spans."""
    from zikkurat_algebra_tpu_torch.utils import profiling

    profiling.reset()
    with profiling.recording():
        res = fn()
    tot = profiling.totals()
    profiling.reset()
    return res, tot["msm.std"]["calls"], tot["msm.std"]["launches"]


@pytest.mark.gpu
def test_msm_stage_seconds_on_card_one_wait(cuda_device, monkeypatch):
    """A 2^16 G1 MSM with stage_seconds waits for the card at most once
    (no synchronise between stages), gives the result of the untimed
    call, and its stage times add up to within 10% of the call's
    synchronised wall time; the stages' launches add up to the call's,
    its point operations each one launch of the point-op kernel."""
    import time

    from zikkurat_algebra_tpu_torch.ops.msm import STAGES
    from zikkurat_algebra_tpu_torch.utils import profiling

    ck = CurveKernels(P.BLS12_381, device=cuda_device)
    n = 1 << 16
    pts = _tiled_seed_points(ck, n)
    k = _scalars((n,), 61, cuda_device)
    m = ck.msm("g1")
    plain = ck.decode_g1(ck.g1.to_affine(m.msm_std(k, pts)))
    waits = []
    sync, ev_sync = torch.cuda.synchronize, torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: (waits.append("device"), sync(*a))[1])
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda ev: (waits.append("event"), ev_sync(ev))[1])
    profiling.reset()
    st = {}
    sync()
    t = time.perf_counter()
    res = m.msm_std(k, pts, stage_seconds=st)
    assert len(waits) <= 1, waits
    sync()
    wall = time.perf_counter() - t
    assert ck.decode_g1(ck.g1.to_affine(res)) == plain
    assert sorted(st) == sorted(STAGES)
    assert abs(sum(st.values()) - wall) <= 0.1 * wall, (st, wall)
    tot = profiling.totals()
    top = tot["msm.std"]["launches"]
    assert top["bucket_scan"] == 1 and top["sort_key_val"] == 1
    assert top["point_add"] > 0 and top["point_dbl"] > 0
    assert {c: sum(tot[f"msm.{s}"]["launches"][c] for s in STAGES)
            for c in top} == top
    profiling.reset()


@pytest.mark.gpu
def test_msm_batched_scalars_on_card(cuda_device):
    """Six scalar vectors over 4096 shared points (the blob prover's
    batch) in one msm_std equal six 2-D calls point for point after
    to_affine; the batched call launches K2 and K3 once each and as
    many point additions and doublings as one 2-D call."""
    ck = CurveKernels(P.BLS12_381, device=cuda_device)
    n, B = 4096, 6
    pts = _tiled_seed_points(ck, n)
    k = _scalars((B, n), 63, cuda_device)
    m = ck.msm("g1")
    res, calls, batched = _msm_launches(lambda: m.msm_std(k, pts, 8))
    assert calls == 1 and all(t.shape == (ck.fp.W, B) for t in res)
    got = ck.decode_g1(ck.g1.to_affine(res))
    singles = []
    for b in range(B):
        r, _, one = _msm_launches(lambda: m.msm_std(k[:, b].contiguous(),
                                                    pts, 8))
        singles.append(ck.decode_g1(ck.g1.to_affine(
            tuple(t.unsqueeze(-1) for t in r)))[0])
    assert got == singles
    assert batched["bucket_scan"] == one["bucket_scan"] == 1
    assert batched["sort_key_val"] == one["sort_key_val"] == 1
    assert batched["point_add"] == one["point_add"] > 0
    assert batched["point_dbl"] == one["point_dbl"] > 0
    assert batched["mont_mul"] == one["mont_mul"] == 0


@pytest.mark.gpu
def test_msm_2p20_launch_counts_on_card(cuda_device):
    """A 2-D G1 MSM of 2^20 points at c = 15 launches K3 and K2 once,
    the point kernels 71 and 275 times and no K1 inside msm.std."""
    ck = CurveKernels(P.BLS12_381, device=cuda_device)
    n = 1 << 20
    pts = _tiled_seed_points(ck, n)
    k = _scalars((n,), 64, cuda_device)
    _, calls, launches = _msm_launches(lambda: ck.msm("g1").msm_std(k, pts))
    assert calls == 1
    assert {c: launches[c] for c in ("sort_key_val", "bucket_scan",
                                     "point_add", "point_dbl",
                                     "mont_mul")} == dict(
        sort_key_val=1, bucket_scan=1, point_add=71, point_dbl=275,
        mont_mul=0)


@pytest.mark.gpu
def test_protocol_spans_on_card(cuda_device):
    """KZG commit, open and verify on the card under recording(): the
    spans kzg.commit (holding msm.std), kzg.open (holding kzg.commit)
    and kzg.verify (holding pairing.miller_loop and pairing.final_exp),
    each with a device interval read from its events."""
    from zikkurat_algebra_tpu_torch.protocols import kzg
    from zikkurat_algebra_tpu_torch.utils import profiling

    curve = P.BLS12_381
    s = kzg.new_setup(curve, 4, 12345, device=cuda_device)
    fr = CurveKernels(curve, device=cuda_device).fr
    r = random.Random(62)
    coeffs = fr.encode([r.randrange(fr.p) for _ in range(16)])
    x0 = fr.encode(r.randrange(fr.p))
    profiling.reset()
    with profiling.recording():
        com = kzg.commit_poly(s, coeffs)
        y0, proof = kzg.opening_proof(s, coeffs, x0)
        ok = bool(kzg.verify_proof(s, com, proof, x0, y0))
    assert ok
    tot = profiling.totals()
    pairs = {(rec.parent, rec.name) for rec in profiling.records()}
    assert {(None, "kzg.commit"), ("kzg.commit", "msm.std"),
            (None, "kzg.open"), ("kzg.open", "kzg.commit"),
            (None, "kzg.verify"), ("kzg.verify", "pairing.miller_loop"),
            ("kzg.verify", "pairing.final_exp")} <= pairs
    assert tot["kzg.commit"]["calls"] == 2
    assert all(tot[n]["device_s"] > 0 for n in tot)
    assert tot["pairing.final_exp"]["launches"]["mont_mul"] > 0
    profiling.reset()
