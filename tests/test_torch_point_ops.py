"""The G1 point-operation kernel (`csrc/point_ops.cu`, wrappers
`ops/kernel_point.py`) and the dispatch of `ProjCurveOps.add` / `.dbl`.

On the CPU: the dispatch rule (G1 coordinates on a CUDA device, W = 8 or
12, over the kernel field; never G2, never `plain()`), the torch law on
CPU tensors with the new launch counters left at 0, and the wrappers'
checks.  On the card (marked `gpu`, skipped from inside the
`cuda_device` fixture on a host without one): `point_add` and
`point_dbl` against `plain()`'s torch law, limb for limb and as points
after `to_affine`, at W = 12 (BLS12-381) and W = 8 (BN254), with
infinity, P = Q and P = -Q, batches of 1, odd sizes and 2^16, broadcast
and strided operands; G1 MSMs at 2^12 over several windows against the
oracle; the launch counters.  The file imports neither JAX nor the JAX
package, so on the H100 host it runs without them:

    python -m pytest tests/test_torch_point_ops.py -m gpu --noconftest \
        -o addopts="" -p no:cacheprovider -q
"""

import os
import random

import pytest
import torch

from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.ops import kernel_field, kernel_point
from zikkurat_algebra_tpu_torch.ops import msm as msm_mod
from zikkurat_algebra_tpu_torch.ops.curve import CurveKernels
from zikkurat_algebra_tpu_torch.utils import profiling
from zikkurat_algebra_tpu_torch.utils.convert import load_jax_seed_points

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench_data")
SEEDS = {P.BLS12_381: "seeds_BLS12_381_g1.npz", P.BN128: "seeds_BN128_g1.npz"}
CURVES = [P.BLS12_381, P.BN128]
CUDA = torch.device("cuda")
ADD, DBL = kernel_point.point_add, kernel_point.point_dbl


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 host)")
    return "cuda"


def _counts():
    return ADD.launches, DBL.launches


def _refuse(*args, **kwargs):
    raise AssertionError("the point-op kernel was called")


def _points(ck, curve, n, seed):
    """n projective G1 points (W, n) from the committed seeds: a seed-drawn
    permutation of the seed points, each coordinate scaled by its own
    random nonzero lambda (another representation of the same point),
    with the products on the plain version."""
    f = ck.fp
    x, y, _ = load_jax_seed_points(os.path.join(DATA, SEEDS[curve]), f)
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, x.shape[-1], (n,), generator=g).to(x.device)
    lam = f.plain().rnd(g, (n,))
    one = f.one((n,))
    fp = f.plain()
    X, Y, Z = fp.mul_list([(x[:, idx], lam), (y[:, idx], lam), (one, lam)])
    return X, Y, Z


def _with_cases(ops, Pt, Qt):
    """Points 0-4 of the batch made the special cases: P = Q (other
    coordinates), P = -Q, P at infinity, Q at infinity, both; point 5 (if
    there) P = Q with equal coordinates."""
    n = Pt[0].shape[-1]
    Pt, Qt = [c.clone() for c in Pt], [c.clone() for c in Qt]
    inf = ops.infinity((1,))
    if n > 0:
        Qt[0][:, 0], Qt[1][:, 0], Qt[2][:, 0] = (
            ops.f.plain().mul(c[:, :1], ops.f.const(5, (1,)))[:, 0]
            for c in Pt)
    if n > 1:
        Qt[0][:, 1], Qt[2][:, 1] = Pt[0][:, 1], Pt[2][:, 1]
        Qt[1][:, 1] = ops.f.neg(Pt[1][:, 1:2])[:, 0]
    for i, (lhs, rhs) in ((2, (True, False)), (3, (False, True)),
                          (4, (True, True))):
        if n > i:
            for side, on in zip((Pt, Qt), (lhs, rhs)):
                if on:
                    for c, v in zip(side, inf):
                        c[:, i] = v[:, 0]
    if n > 5:
        for a, b in zip(Pt, Qt):
            b[:, 5] = a[:, 5]
    return tuple(Pt), tuple(Qt)


def _same(ops, got, want):
    """Equal limb for limb, hence as points after `to_affine` too."""
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g, w)
    ga, wa = ops.to_affine(got), ops.to_affine(want)
    assert all(torch.equal(g, w) for g, w in zip(ga, wa))


# -- the CPU: dispatch rule, torch law, checks --------------------------------

@pytest.mark.parametrize("curve", [P.BLS12_381, P.BN128, P.BLS12_377],
                         ids=lambda c: c.name)
def test_dispatch_rule(curve):
    """G1 over the kernel field on a CUDA device is fused; the same on the
    CPU, `plain()` anywhere and G2 anywhere are not."""
    ck = CurveKernels(curve, device="cpu")
    assert ck.fp.W in kernel_point.WIDTHS
    assert ck.fp.on_kernel and not ck.fp.plain().on_kernel
    assert ck.g1._fused(CUDA)
    assert not ck.g1._fused(torch.device("cpu"))
    assert not ck.g1.plain()._fused(CUDA)
    if ck.g2 is not None:
        assert not ck.g2._fused(CUDA)
        assert not ck.g2.plain()._fused(CUDA)


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5)], ids=str)
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_cpu_add_dbl_take_torch_law(curve, shape, monkeypatch):
    """On CPU tensors add and dbl run the torch law (the kernel wrappers
    are never called, their counters stay put) and equal `plain()`'s,
    with infinity, P = Q and P = -Q among the points."""
    ck = CurveKernels(curve, device="cpu")
    n = 1
    for s in shape:
        n *= s
    Pt, Qt = _with_cases(ck.g1, _points(ck, curve, n, 1),
                         _points(ck, curve, n, 2))
    Pt, Qt = (tuple(c.reshape((c.shape[0],) + shape) for c in pt)
              for pt in (Pt, Qt))
    monkeypatch.setattr(kernel_point, "point_add", _refuse)
    monkeypatch.setattr(kernel_point, "point_dbl", _refuse)
    before = _counts()
    pl = ck.g1.plain()
    _same(ck.g1, ck.g1.add(Pt, Qt), pl.add(Pt, Qt))
    _same(ck.g1, ck.g1.dbl(Pt), pl.dbl(Pt))
    assert _counts() == before


def test_g2_add_keeps_torch_law(monkeypatch):
    """A G2 addition and doubling never reach the kernel wrappers."""
    ck = CurveKernels(P.BLS12_381, device="cpu")
    monkeypatch.setattr(kernel_point, "point_add", _refuse)
    monkeypatch.setattr(kernel_point, "point_dbl", _refuse)
    Q = ck.generator(3, "g2")
    two = ck.g2.add(Q, Q)
    assert ck.g2.eq(two, ck.g2.dbl(Q)).all()
    assert not ck.g2.is_inf(two).any()


@pytest.mark.parametrize("bad", ["cpu_tensor", "int64", "width", "g2"])
def test_wrappers_check_operands(bad):
    """The wrappers refuse what the kernel does not take, before any
    launch: a field off the card, another dtype, another width, Fp2."""
    ck = CurveKernels(P.BLS12_381, device="cpu")
    ops, Pt = ck.g1, ck.generator(4)
    err = ValueError
    if bad == "int64":
        Pt, err = tuple(c.to(torch.int64) for c in Pt), TypeError
    elif bad == "width":
        Pt = tuple(c[:8] for c in Pt)
    elif bad == "g2":
        ops, Pt = ck.g2, ck.generator(4, "g2")
    before = _counts()
    with pytest.raises(err):
        ADD(ops, Pt, Pt)
    with pytest.raises(err):
        DBL(ops, Pt)
    assert _counts() == before


def test_cpu_msm_counts_no_point_launch():
    """A G1 MSM on the CPU records the point-op counters in its spans, at
    0: the counters are in `profiling.LAUNCHES`."""
    ck = CurveKernels(P.BLS12_381, device="cpu")
    og = ck.oracle_g1
    r = random.Random(5)
    pts = [og.scalar_mul(r.randrange(1, og.r), og.gen) for _ in range(8)]
    ks = [r.randrange(1 << 12) for _ in range(8)]
    m = msm_mod.MSM(ck.g1, 12)
    profiling.reset()
    with profiling.recording():
        res = m.msm_std(ck.fr.encode(ks, mont=False), ck.encode_g1(pts), 4, 8)
    assert ck.decode_g1(ck.g1.to_affine(res)) == og.msm(ks, pts)
    tot = profiling.totals()
    assert {"point_add", "point_dbl"} <= set(profiling.LAUNCHES)
    for name in ("msm.std", "msm.horner"):
        got = tot[name]["launches"]
        assert got["point_add"] == got["point_dbl"] == 0
    profiling.reset()


# -- the card -----------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 1 << 16])
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_point_ops_kernel_vs_torch_law(cuda_device, curve, n):
    """point_add and point_dbl equal `plain()`'s torch law limb for limb
    and after `to_affine`, one launch each per call; the special cases
    sit at the front of the batch."""
    ck = CurveKernels(curve, device=cuda_device)
    ops, pl = ck.g1, ck.g1.plain()
    Pt, Qt = _with_cases(ops, _points(ck, curve, n, 3),
                         _points(ck, curve, n, 4))
    a, d = _counts()
    got_add, got_dbl = ops.add(Pt, Qt), ops.dbl(Pt)
    assert _counts() == (a + 1, d + 1)
    _same(ops, got_add, pl.add(Pt, Qt))
    _same(ops, got_dbl, pl.dbl(Pt))
    _same(ops, ops.dbl(Qt), pl.dbl(Qt))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["P=Q", "P=-Q", "inf_left", "inf_right",
                                  "inf_both", "P=Q_same_coords"])
def test_point_ops_kernel_single_cases(cuda_device, case):
    """Each special case alone at batch 1 (W = 12)."""
    ck = CurveKernels(P.BLS12_381, device=cuda_device)
    ops, pl = ck.g1, ck.g1.plain()
    Pt, Qt = _with_cases(ops, _points(ck, P.BLS12_381, 6, 5),
                         _points(ck, P.BLS12_381, 6, 6))
    i = ["P=Q", "P=-Q", "inf_left", "inf_right", "inf_both",
         "P=Q_same_coords"].index(case)
    Pt, Qt = (tuple(c[:, i].contiguous() for c in pt) for pt in (Pt, Qt))
    _same(ops, ops.add(Pt, Qt), pl.add(Pt, Qt))
    _same(ops, ops.dbl(Pt), pl.dbl(Pt))
    if case == "P=-Q":
        assert bool(ops.is_inf(ops.add(Pt, Qt)))


@pytest.mark.gpu
@pytest.mark.parametrize("curve", CURVES, ids=lambda c: c.name)
def test_point_ops_kernel_broadcast_and_strided(cuda_device, curve):
    """Operands as the MSM hands them: the halves `_tree_sum` slices off
    a (W, rows, 2h) batch, the `expand` of `_wsum_bits`, one point against
    a batch, and a transposed batch; results against the torch law."""
    ck = CurveKernels(curve, device=cuda_device)
    ops, pl = ck.g1, ck.g1.plain()
    rows, h = 3, 5
    T = tuple(c.reshape(c.shape[0], rows, 2 * h)
              for c in _points(ck, curve, rows * 2 * h, 7))
    lo, hi = (tuple(c[..., :h] for c in T), tuple(c[..., h:] for c in T))
    assert not lo[0].is_contiguous()
    _same(ops, ops.add(lo, hi), pl.add(lo, hi))
    ex = tuple(c.unsqueeze(-2).expand(c.shape[:-1] + (4, 2 * h)) for c in T)
    _same(ops, ops.add(ex, ex), pl.add(ex, ex))
    _same(ops, ops.dbl(ex), pl.dbl(ex))
    one = tuple(c[:, :1, :1] for c in T)
    _same(ops, ops.add(one, T), pl.add(one, T))
    tr = tuple(c.transpose(-1, -2) for c in T)
    _same(ops, ops.add(tr, tr), pl.add(tr, tr))
    _same(ops, ops.dbl(tr), pl.dbl(tr))


def _fold_msm(og, ks, seeds, nseed):
    """The oracle MSM of points tiling `nseed` seeds: the seeds with the
    summed scalars of their positions."""
    folded = [0] * nseed
    for i, k in enumerate(ks):
        folded[i % nseed] = (folded[i % nseed] + k) % og.r
    return og.msm(folded, seeds)


@pytest.fixture(scope="module")
def msm_case():
    """2^12 points tiling 64 seed points, full-width scalars below r, one
    zero scalar, and the oracle's answer (computed once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 host)")
    out = {}
    for curve in CURVES:
        ck = CurveKernels(curve, device="cuda")
        og = ck.oracle_g1
        x, y, inf = load_jax_seed_points(os.path.join(DATA, SEEDS[curve]),
                                         ck.fp)
        nseed, n = 64, 1 << 12
        seeds = ck.decode_g1((x[:, :nseed], y[:, :nseed], inf[:nseed]))
        pts = tuple(t[..., :nseed].repeat(*([1] * (t.ndim - 1)), n // nseed)
                    .contiguous() for t in (x, y, inf))
        r = random.Random(8)
        ks = [r.randrange(og.r) for _ in range(n)]
        ks[5] = 0
        out[curve] = (ck, ck.fr.encode(ks, mont=False), pts,
                      _fold_msm(og, ks, seeds, nseed))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("curve,c", [(P.BLS12_381, 2), (P.BLS12_381, 3),
                                     (P.BLS12_381, 8), (P.BLS12_381, 9),
                                     (P.BLS12_381, 15), (P.BN128, 9)],
                         ids=lambda v: getattr(v, "name", v))
def test_msm_std_point_ops_vs_oracle(cuda_device, msm_case, curve, c):
    """msm_std of 2^12 points at window c equals the oracle; c <= 3 takes
    `_wsum_bits` alone.  Inside the MSM every point op is a kernel launch
    and K1 is not launched at all."""
    ck, k, pts, want = msm_case[curve]
    profiling.reset()
    with profiling.recording():
        res = ck.msm("g1").msm_std(k, pts, c, 64)
    tot = profiling.totals()["msm.std"]["launches"]
    assert ck.decode_g1(ck.g1.to_affine(res)) == want
    assert tot["mont_mul"] == 0
    assert tot["point_add"] > 0 and tot["point_dbl"] > 0
    profiling.reset()


@pytest.mark.gpu
def test_point_launch_counters_exact_2p20(cuda_device):
    """One launch per call; an empty batch launches nothing.  A 2^20 G1
    MSM at c = 15 shows 17 x 15 doublings and 17 additions inside
    `msm.horner`, and no K1 launch in the whole `msm.std`."""
    ck = CurveKernels(P.BLS12_381, device=cuda_device)
    ops = ck.g1
    Pt = ck.generator(3)
    a, d = _counts()
    ops.add(Pt, Pt)
    ops.dbl(Pt)
    ops.sub(Pt, Pt)
    empty = tuple(c[:, :0] for c in Pt)
    assert ops.add(empty, empty)[0].shape == (ck.fp.W, 0)
    assert ops.dbl(empty)[2].shape == (ck.fp.W, 0)
    assert _counts() == (a + 2, d + 1)
    x, y, inf = load_jax_seed_points(os.path.join(DATA, SEEDS[P.BLS12_381]),
                                     ck.fp)
    n = 1 << 20
    pts = tuple(t.repeat(*([1] * (t.ndim - 1)), n // t.shape[-1])
                .contiguous() for t in (x, y, inf))
    g = torch.Generator().manual_seed(9)
    k = torch.randint(-2**31, 2**31 - 1, (8, n), generator=g,
                      dtype=torch.int32)
    k[7] &= 0x3FFFFFFF                                 # below r
    k = k.to(cuda_device)
    profiling.reset()
    with profiling.recording():
        ck.g1.to_affine(ck.msm("g1").msm_std(k, pts, 15, 512))
    tot = profiling.totals()
    horner = tot["msm.horner"]["launches"]
    assert horner["point_dbl"] == 17 * 15 and horner["point_add"] == 17
    assert horner["mont_mul"] == 0
    assert tot["msm.std"]["launches"]["mont_mul"] == 0
    assert tot["curve.to_affine"]["launches"]["mont_mul"] > 0
    assert kernel_field.mont_mul.launches > 0
    profiling.reset()
