"""The port's G1 and G2 MSMs (zikkurat_algebra_tpu_torch.ops.msm) against
the JAX package's MSM stages and the oracle.

Digits, signed digits and the level-2 carries are held against the JAX
functions of the same name on the same inputs; one whole MSM of each
group is held against `msm_std` of the JAX package.  Projective values
from the two packages may differ by the order of additions, so points
are compared after `to_affine`.  The edge cases are held against the
oracle alone.  The stage spans of `utils.profiling` are checked on a
32-point MSM of 12-bit scalars (four windows), which the CPU runs in a
fraction of a second.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu import params as JP
from zikkurat_algebra_tpu.ops import msm as jmsm
from zikkurat_algebra_tpu.ops.curve import get_curves
from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.errors import DimensionError, UnsupportedError
from zikkurat_algebra_tpu_torch.ops import (kernel_curve, kernel_field,
                                            kernel_ntt, kernel_point,
                                            kernel_sort, msm)
from zikkurat_algebra_tpu_torch.ops.curve import CurveKernels
from zikkurat_algebra_tpu_torch.utils import profiling

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ck():
    return CurveKernels(P.BLS12_381, device="cpu")


@pytest.fixture(scope="module")
def jck():
    return get_curves(JP.BLS12_381)


def rand_points(og, n, seed):
    r = random.Random(seed)
    return [og.scalar_mul(r.randrange(1, og.r), og.gen) for _ in range(n)]


@pytest.mark.parametrize("c", [1, 5, 13, 15])
def test_digits_vs_jax(ck, jck, c):
    r = random.Random(c)
    ks = [r.randrange(ck.fr.p) for _ in range(9)] + [0, ck.fr.p - 1]
    nbits = ck.fr.p.bit_length()
    got = msm.digits_from_limbs(ck.fr.encode(ks, mont=False), c, nbits)
    want = jmsm.digits_from_limbs(jck.fr.encode(ks, mont=False), c, nbits)
    assert np.array_equal(got.numpy(), np.asarray(want))
    sgot = msm.signed_digits(got, c)
    swant = jmsm.signed_digits(want, c)
    assert np.array_equal(sgot.numpy(), np.asarray(swant))
    for j, k in enumerate(ks):
        assert sum(int(d) << (c * w) for w, d in enumerate(sgot[:, j])) == k


def test_level2_carries_vs_jax(ck, jck):
    """Carries and their landing buckets equal the JAX _level2_carries on
    the same sorted digits (runs spanning up to all blocks) and trailers."""
    og = ck.oracle_g1
    wc, nblk, m, nbuckets = 3, 8, 4, 9
    rng = np.random.default_rng(2)
    steps = rng.choice([0, 0, 0, 0, 1], size=(wc, nblk * m))
    steps[2] = 0                                   # one digit, all blocks
    d = np.minimum(np.cumsum(steps, 1), nbuckets - 1).astype(np.int32)
    d_blk = d.reshape(wc, nblk, m)
    pool = rand_points(og, 6, 3)
    pts = [pool[i] for i in rng.integers(0, 6, wc * nblk)]
    S = ck.g1.from_affine(ck.encode_g1(pts))
    S = tuple(s.reshape(ck.fp.W, wc, nblk) for s in S)
    jS = jck.g1.from_affine(jck.encode_g1(pts))
    jS = tuple(s.reshape(s.shape[0], wc, nblk) for s in jS)

    C, cidx = msm._level2_carries(ck.g1, torch.from_numpy(d_blk[..., 0]),
                                  torch.from_numpy(d_blk[..., -1]), S,
                                  nbuckets)
    jC, jcidx = jmsm._level2_carries(jck.g1, jnp.asarray(d_blk), jS,
                                     nbuckets)
    assert np.array_equal(cidx.numpy(), np.asarray(jcidx))
    got = ck.decode_g1(ck.g1.to_affine(tuple(c.reshape(ck.fp.W, -1)
                                             for c in C)))
    want = jck.decode_g1(jck.g1.to_affine(tuple(
        c.reshape(c.shape[0], -1) for c in jC)))
    assert got == want


def test_msm_std_vs_jax(ck, jck):
    """The whole slice: the shape of tests/test_msm.py's BLS-33-5 case,
    the JAX msm_std against the port's, compared after to_affine."""
    og = ck.oracle_g1
    n, c = 33, 5
    pts = rand_points(og, n, 5)
    r = random.Random(6)
    ks = [r.randrange(og.r) for _ in range(n)]
    pts[3], ks[1] = None, 0
    jres = jck.msm("g1").msm_std(jck.fr.encode(ks, mont=False),
                                 jck.encode_g1(pts), c)
    want = jck.decode_g1(jck.g1.to_affine(jres))
    res = ck.msm("g1").msm_std(ck.fr.encode(ks, mont=False),
                               ck.encode_g1(pts), c, 16)
    assert ck.decode_g1(ck.g1.to_affine(res)) == want == og.msm(ks, pts)
    res2 = ck.msm("g1").msm_mont(ck.fr.encode(ks), ck.encode_g1(pts), c, 16)
    assert ck.decode_g1(ck.g1.to_affine(res2)) == want


@pytest.mark.parametrize("n,c,block", [
    (1, None, 8),          # one point
    (20, 3, 8),            # long segments spanning blocks, n % block != 0
    (37, 4, 16),           # n not a multiple of the block
])
def test_msm_edge_cases_vs_oracle(ck, n, c, block):
    og = ck.oracle_g1
    pts = rand_points(og, n, 10 + n)
    r = random.Random(n)
    ks = [r.randrange(og.r) for _ in range(n)]
    if n > 4:
        pts[2] = None                               # infinity input
        ks[4] = 0                                   # zero scalar
        pts[5] = pts[6]                             # a repeated point
    res = ck.msm("g1").msm_std(ck.fr.encode(ks, mont=False),
                               ck.encode_g1(pts), c, block)
    assert ck.decode_g1(ck.g1.to_affine(res)) == og.msm(ks, pts)


def test_msm_zero_scalars_and_dimension_error(ck):
    og = ck.oracle_g1
    pts = rand_points(og, 4, 20)
    A = ck.encode_g1(pts)
    res = ck.msm("g1").msm_std(ck.fr.encode([0] * 4, mont=False), A, 2, 4)
    assert ck.decode_g1(ck.g1.to_affine(res)) is None
    with pytest.raises(DimensionError):
        ck.msm("g1").msm_std(ck.fr.encode([1] * 3, mont=False), A, 2, 4)


def test_window_size_matches_jax():
    for n in (1, 2, 33, 1 << 10, 1 << 16, 1 << 20, 1 << 24):
        assert msm.window_size(n) == jmsm.window_size(n)


def test_msm_g2_vs_jax(ck, jck):
    """The G2 slice as a whole: the shape of tests/test_msm.py's G2 case
    (n = 9, c = 4) with an infinity point, a zero scalar and n not a
    multiple of the block, the JAX msm_std against the port's and the
    oracle, compared after to_affine."""
    og = ck.oracle_g2
    n, c = 9, 4
    pts = rand_points(og, n, 30)
    r = random.Random(31)
    ks = [r.randrange(og.r) for _ in range(n)]
    pts[2], ks[4] = None, 0
    jres = jck.msm("g2").msm_std(jck.fr.encode(ks, mont=False),
                                 jck.encode_g2(pts), c)
    want = jck.decode_g2(jck.g2.to_affine(jres))
    res = ck.msm("g2").msm_std(ck.fr.encode(ks, mont=False),
                               ck.encode_g2(pts), c, 4)
    assert ck.decode_g2(ck.g2.to_affine(res)) == want == og.msm(ks, pts)


def test_msm_g2_edge_cases_vs_oracle():
    """BN128 G2 (b3 a full Fp2 value, W = 8): a repeated point, an
    infinity point, a zero scalar, segments spanning blocks and n not a
    multiple of the block, through msm_mont."""
    ck = CurveKernels(P.BN128, device="cpu")
    og = ck.oracle_g2
    n = 7
    pts = rand_points(og, n, 40)
    r = random.Random(41)
    ks = [r.randrange(og.r) for _ in range(n)]
    pts[1], ks[3], pts[5] = None, 0, pts[6]
    res = ck.msm("g2").msm_mont(ck.fr.encode(ks), ck.encode_g2(pts), 3, 2)
    assert ck.decode_g2(ck.g2.to_affine(res)) == og.msm(ks, pts)


def test_msm_group_names():
    """G2 exists where the curve has a twist; BLS12-377 has none."""
    with pytest.raises(UnsupportedError):
        CurveKernels(P.BLS12_377, device="cpu").msm("g2")
    ck = CurveKernels(P.BN128, device="cpu")
    with pytest.raises(ValueError):
        ck.msm("g3")
    assert ck.msm("g2").ops is ck.g2 and ck.msm("g1").ops is ck.g1


@pytest.fixture(scope="module")
def small_msm(ck):
    """An MSM of 32 points (4 distinct) with 12-bit scalars at c = 4: the
    MSM, its scalars, its points and the oracle's answer."""
    og = ck.oracle_g1
    base = rand_points(og, 4, 50)
    pts = [base[i % 4] for i in range(32)]
    r = random.Random(51)
    ks = [r.randrange(1 << 12) for _ in range(32)]
    return (msm.MSM(ck.g1, 12), ck.fr.encode(ks, mont=False),
            ck.encode_g1(pts), og.msm(ks, pts))


def test_msm_stage_spans(ck, small_msm):
    """Under recording() each stage is a span once per call, a child of
    msm.std with the call's operation id; a stage_seconds dict alone
    turns recording on, its keys are the stage spans' and it adds up
    across calls; the children's launches add up to the call's."""
    m, k, A, want = small_msm
    profiling.reset()
    st = {}
    with profiling.recording():
        res = m.msm_std(k, A, 4, 16)
        m.msm_std(k, A, 4, 16, stage_seconds=st)
    first = dict(st)
    m.msm_std(k, A, 4, 16, stage_seconds=st)
    assert ck.decode_g1(ck.g1.to_affine(res)) == want
    by_op = {}
    for r in profiling.records():
        by_op.setdefault(r.op, []).append(r)
    assert len(by_op) == 3
    stage_spans = sorted(f"msm.{s}" for s in msm.STAGES)
    for recs in by_op.values():
        assert [r.name for r in recs if r.parent is None] == ["msm.std"]
        kids = [r for r in recs if r.parent == "msm.std"]
        assert sorted(r.name for r in kids) == stage_spans
        assert len(recs) == 1 + len(kids)
        top = recs[-1]
        assert top.name == "msm.std"
        assert sum(r.host_s for r in kids) <= top.host_s
        assert [sum(x) for x in zip(*(r.launches for r in kids))] == \
            list(top.launches)
    assert sorted(f"msm.{s}" for s in st) == stage_spans
    assert all(st[s] > first[s] > 0 for s in msm.STAGES)
    tot = profiling.totals()
    assert tot["msm.std"]["calls"] == 3
    assert all(tot[n]["calls"] == 3 for n in stage_spans)
    profiling.reset()
    assert profiling.records() == [] and profiling.totals() == {}


def test_spans_off_do_one_flag_check(ck, small_msm, monkeypatch):
    """Recording off and no profiler: an MSM and to_affine record nothing,
    open no record_function, make no CUDA event and no span object."""
    def refuse(*a, **k):
        raise AssertionError("a span site did more than check its flags")

    for owner, name in [(torch.autograd.profiler, "record_function"),
                        (torch.profiler, "record_function"),
                        (torch.cuda, "Event"), (profiling, "_Span"),
                        (profiling, "SpanRecord")]:
        monkeypatch.setattr(owner, name, refuse)
    m, k, A, want = small_msm
    profiling.reset()
    assert ck.decode_g1(ck.g1.to_affine(m.msm_std(k, A, 4, 16))) == want
    assert profiling.records() == [] and profiling.totals() == {}


def test_span_launch_deltas_add_up(monkeypatch):
    """The launch deltas of nested spans add up to the counters' change
    over the outer span (the counters moved by hand: on the CPU no
    kernel launches)."""
    kernels = dict(zip(profiling.LAUNCHES, (
        kernel_field.mont_mul, kernel_curve.bucket_scan,
        kernel_sort.sort_key_val, kernel_ntt.ntt_stages,
        kernel_curve.bucket_scan2, kernel_point.point_add,
        kernel_point.point_dbl)))
    assert list(kernels) == list(profiling.LAUNCHES)
    for fn in kernels.values():
        monkeypatch.setattr(fn, "launches", fn.launches)
    before = {n: fn.launches for n, fn in kernels.items()}

    def bump(**by):
        for n, d in by.items():
            kernels[n].launches += d

    profiling.reset()
    with profiling.recording():
        with profiling.span("outer"):
            with profiling.span("outer.a"):
                bump(mont_mul=3, bucket_scan=1)
            bump(sort_key_val=1)
            with profiling.span("outer.b"):
                bump(ntt_stages=2, bucket_scan2=1, mont_mul=1, point_add=3,
                     point_dbl=5)
    tot = profiling.totals()
    change = {n: fn.launches - before[n] for n, fn in kernels.items()}
    assert tot["outer"]["launches"] == change == dict(
        mont_mul=4, bucket_scan=1, sort_key_val=1, ntt_stages=2,
        bucket_scan2=1, point_add=3, point_dbl=5)
    a, b = tot["outer.a"]["launches"], tot["outer.b"]["launches"]
    assert {n: a[n] + b[n] for n in change} == dict(change, sort_key_val=0)
    assert tot["outer"]["calls"] == 1
    assert tot["outer"]["device_s"] == tot["outer"]["host_s"] > 0
    profiling.reset()
