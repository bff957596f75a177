"""Kernels K1 and K2 on the card against their plain torch versions, and
a small MSM on the card against the oracle.

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
from zikkurat_algebra_tpu_torch.ops import kernel_curve, kernel_field
from zikkurat_algebra_tpu_torch.ops.curve import CurveKernels
from zikkurat_algebra_tpu_torch.ops.field import Field

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 host)")
    return "cuda"


def make_scan_inputs(f, nwin, nblk, m, npts, nbuckets, seed):
    """Random K2 inputs: per window row, sorted |digits| with long runs
    (segments spanning blocks), random signs, distinct point indices, and
    points of which some are at infinity.  Returns numpy arrays and the
    coordinates as Python ints."""
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
