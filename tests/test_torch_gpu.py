"""Kernels K1, K2, K3 and K4 on the card against their plain torch
versions, and small G1 and G2 MSMs on the card against the oracle.

Every test here is marked `gpu` and skips, from inside the `cuda_device`
fixture, on a host without a CUDA card.  The file imports neither JAX nor
the JAX package, so on the H100 host it runs without them:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest \
        -o addopts="" -p no:cacheprovider -q
"""

import random

import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.ops import (kernel_curve, kernel_field,
                                            kernel_sort)
from zikkurat_algebra_tpu_torch.ops.curve import CurveKernels
from zikkurat_algebra_tpu_torch.ops.field import Field

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 host)")
    return "cuda"


def make_scan_inputs(f, nwin, nblk, m, npts, nbuckets, seed, fp2=False):
    """Random K2 (or, with fp2, K4) inputs: per window row, sorted |digits|
    with long runs (segments spanning blocks), random signs, distinct
    point indices, and points of which some are at infinity.  Returns
    numpy arrays and the coordinates as Python ints (pairs for fp2)."""
    rng = np.random.default_rng(seed)
    n = nblk * m
    steps = rng.choice([0, 0, 0, 1, 2], size=(nwin, n))
    a = np.minimum(np.cumsum(steps, 1) + rng.integers(0, 3, (nwin, 1)),
                   nbuckets)
    sign = np.where(rng.integers(0, 2, (nwin, n)) == 1, -1, 1)
    sd = (a * sign).astype(np.int32)
    idx = np.stack([rng.permutation(npts)[:n] for _ in range(nwin)])
    xs = [int(v) % f.p for v in rng.integers(0, 1 << 62, npts)]
    ys = [(int(v) << 200 | int(v)) % f.p
          for v in rng.integers(0, 1 << 62, npts)]
    inf = rng.integers(0, 5, npts) == 0
    if fp2:
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


@pytest.mark.gpu
@pytest.mark.parametrize("curve", [P.BLS12_381, P.BN128],
                         ids=lambda c: c.name)
def test_bucket_scan_kernel_vs_plain(cuda_device, curve):
    """Kernel K2 equals its plain version limb for limb: buckets and
    trailers, with sign, infinity and restart cases."""
    ck = CurveKernels(curve, device=cuda_device)
    f = ck.fp
    nwin, nblk, m, nbuckets = 3, 40, 16, 60
    xs, ys, inf, sd, idx = make_scan_inputs(f, nwin, nblk, m, 700, nbuckets,
                                            seed=9)
    args = (f.encode(xs), f.encode(ys), torch.from_numpy(inf).cuda(),
            torch.from_numpy(sd).cuda(), torch.from_numpy(idx).cuda(), m,
            nbuckets)
    before = kernel_curve.bucket_scan.launches
    got = kernel_curve.bucket_scan(ck.g1, *args)
    torch.cuda.synchronize()
    assert kernel_curve.bucket_scan.launches == before + 1
    want = kernel_curve.bucket_scan_plain(ck.g1.plain(), *args)
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            assert torch.equal(gc, wc)


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
@pytest.mark.parametrize("curve", [P.BLS12_381, P.BN128],
                         ids=lambda c: c.name)
def test_bucket_scan2_kernel_vs_plain(cuda_device, curve):
    """Kernel K4 equals its plain version limb for limb over Fp2: buckets
    and trailers, with sign, infinity and restart cases."""
    ck = CurveKernels(curve, device=cuda_device)
    tw = ck.tower
    nwin, nblk, m, nbuckets = 3, 40, 16, 60
    xs, ys, inf, sd, idx = make_scan_inputs(ck.fp, nwin, nblk, m, 700,
                                            nbuckets, seed=11, fp2=True)
    args = (tw.encode_fp2(xs), tw.encode_fp2(ys),
            torch.from_numpy(inf).cuda(), torch.from_numpy(sd).cuda(),
            torch.from_numpy(idx).cuda(), m, nbuckets)
    before = kernel_curve.bucket_scan2.launches
    k2_before = kernel_curve.bucket_scan.launches
    got = kernel_curve.bucket_scan(ck.g2, *args)
    torch.cuda.synchronize()
    assert kernel_curve.bucket_scan2.launches == before + 1
    assert kernel_curve.bucket_scan.launches == k2_before
    want = kernel_curve.bucket_scan_plain(ck.g2.plain(), *args)
    for g, w in zip(got, want):
        for gc, wc in zip(g, w):
            assert gc.shape == (ck.fp.W, 2) + gc.shape[2:]
            assert torch.equal(gc, wc)


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
