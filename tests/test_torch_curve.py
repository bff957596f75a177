"""The port's G1 and G2 group laws and the plain version of kernels K2
and K4 against the JAX package (zikkurat_algebra_tpu.ops.curve) and the
oracle.

The formulas run in the same operation order in both packages, so X, Y
and Z agree as field values and are compared decoded, exactly.  The
bucket scan's plain version is held against the composed JAX `madd` /
`from_affine` / `select` dataflow of tests/test_pallas.py, at the tail
and trailer positions it writes out, over Fp (K2) and Fp2 (K4).
tests/test_torch_gpu.py holds the kernels themselves against the plain
version on the card.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu import params as JP
from zikkurat_algebra_tpu.ops.curve import get_curves
from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.ops import kernel_curve
from zikkurat_algebra_tpu_torch.ops.curve import CurveKernels
from test_torch_gpu import make_scan_inputs

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)

CURVES = [(P.BLS12_381, JP.BLS12_381), (P.BN128, JP.BN128)]


@pytest.fixture(params=CURVES, ids=lambda c: c[0].name)
def curves(request):
    port, jax_params = request.param
    return CurveKernels(port, device="cpu"), get_curves(jax_params)


def _rand_coords(p, n, seed):
    r = random.Random(seed)
    return [[r.randrange(p) for _ in range(n)] for _ in range(3)]


def _decode_point(f, P_):
    return [f.decode(c) for c in P_]


def _rand_coords2(p, n, seed):
    r = random.Random(seed)
    return [[(r.randrange(p), r.randrange(p)) for _ in range(n)]
            for _ in range(3)]


def test_add_dbl_madd_vs_jax(curves):
    """X, Y, Z of add, dbl and madd equal the JAX ProjCurveOps' values,
    for arbitrary coordinates and for the identity (0 : 1 : 0)."""
    ck, jck = curves
    f, jf = ck.fp, jck.g1.f
    n = 12
    P1, P2 = _rand_coords(f.p, n, 1), _rand_coords(f.p, n, 2)
    P1[0][0], P1[1][0], P1[2][0] = 0, 1, 0              # identity
    inf = np.arange(n) % 4 == 1
    port = (ck.g1, lambda v: f.encode(v), lambda m: torch.from_numpy(m))
    ref = (jck.g1, lambda v: jf.encode(v), jnp.asarray)
    outs = []
    for ops, enc, mask in (port, ref):
        A, B = tuple(map(enc, P1)), tuple(map(enc, P2))
        aff = (B[0], B[1], mask(inf))
        outs.append([ops.add(A, B), ops.dbl(A), ops.madd(A, aff)])
    for got, want in zip(*outs):
        assert _decode_point(f, got) == _decode_point(jf, want)


def test_affine_roundtrip_vs_oracle(curves):
    ck, _ = curves
    og = ck.oracle_g1
    r = random.Random(7)
    pts = [og.scalar_mul(r.randrange(1, og.r), og.gen) for _ in range(5)]
    pts[2] = None
    A = ck.encode_g1(pts)
    P_ = ck.g1.from_affine(A)
    assert ck.g1.is_on_curve(P_).all()
    Q = ck.g1.add(P_, ck.g1.dbl(P_))
    want = [og.add(p, og.dbl(p)) for p in pts]
    assert ck.decode_g1(ck.g1.to_affine(Q)) == want
    assert ck.decode_g1(ck.g1.to_affine(ck.g1.neg(P_))) == [
        og.neg(p) for p in pts]
    bad = ck.g1.from_affine(ck.encode_g1([(1, 1)]))
    assert not ck.g1.is_on_curve(bad).any()


def test_bucket_scan_plain_vs_jax(curves):
    """K2's plain version against the composed JAX madd / from_affine /
    select stream (m = 8, 64 lanes, sign, infinity and restart flags),
    compared at every segment tail (the buckets) and block end (the
    trailers)."""
    ck, jck = curves
    f, ops = ck.fp, ck.g1
    jops, jf = jck.g1, jck.g1.f
    nwin, nblk, m, nbuckets = 4, 16, 8, 40
    n = nblk * m
    xs, ys, inf, sd, idx = make_scan_inputs(f, nwin, nblk, m, 160, nbuckets,
                                            seed=5)
    buckets, S = kernel_curve.bucket_scan(
        ops, f.encode(xs), f.encode(ys), torch.from_numpy(inf),
        torch.from_numpy(sd), torch.from_numpy(idx), m, nbuckets)

    # JAX reference: lanes (w, blk) on the batch axis, m steps
    B = nwin * nblk
    lane_pos = (np.arange(nwin)[:, None] * n
                + np.arange(nblk)[None] * m).reshape(B)
    sd_f, idx_f = sd.reshape(-1), idx.reshape(-1)
    a_f = np.abs(sd_f)
    jx, jy = jf.encode(xs), jf.encode(ys)
    acc = jops.infinity((B,))
    want_b = {}
    for j in range(m):
        pos = lane_pos + j
        ii = idx_f[pos]
        x, y = jx[:, ii], jy[:, ii]
        y = jf.select(jnp.asarray(sd_f[pos] < 0), jf.neg(y), y)
        pt = (x, y, jnp.asarray(inf[ii]))
        new = (j == 0) | (a_f[pos] != a_f[np.maximum(pos - 1, 0)])
        acc = jops.select(jnp.asarray(new), jops.from_affine(pt),
                          jops.madd(acc, pt))
        col = pos % n
        tail = (col == n - 1) | (a_f[np.minimum(pos + 1, sd_f.size - 1)]
                                 != a_f[pos])
        dec = _decode_point(jf, acc)
        for lane in np.nonzero(tail)[0]:
            key = (int(pos[lane] // n), int(a_f[pos[lane]]))
            want_b[key] = tuple(c[lane] for c in dec)
    got_S = _decode_point(f, tuple(s.reshape(f.W, -1) for s in S))
    assert got_S == _decode_point(jf, acc)
    got_b = _decode_point(f, tuple(b.reshape(f.W, -1) for b in buckets))
    for w in range(nwin):
        for d in range(nbuckets + 1):
            k = w * (nbuckets + 1) + d
            got = tuple(c[k] for c in got_b)
            assert got == want_b.get((w, d), (0, 1, 0)), (w, d)


def test_g2_add_dbl_madd_vs_jax(curves):
    """G2 over Fp2 with b3 an Fp2 constant (a full Fp2 value for BN128):
    X, Y, Z of add, dbl and madd equal the JAX values, identity included."""
    ck, jck = curves
    tw, jt = ck.tower, jck.tower
    n = 12
    P1, P2 = _rand_coords2(ck.fp.p, n, 3), _rand_coords2(ck.fp.p, n, 4)
    P1[0][0], P1[1][0], P1[2][0] = (0, 0), (1, 0), (0, 0)    # identity
    inf = np.arange(n) % 4 == 1
    port = (ck.g2, tw.encode_fp2, torch.from_numpy, tw.decode_fp2)
    ref = (jck.g2, jt.encode_fp2, jnp.asarray, jt.decode_fp2)
    outs = []
    for ops, enc, mask, dec in (port, ref):
        A, B = tuple(map(enc, P1)), tuple(map(enc, P2))
        aff = (B[0], B[1], mask(inf))
        outs.append([[dec(c) for c in Q] for Q in
                     (ops.add(A, B), ops.dbl(A), ops.madd(A, aff))])
    assert outs[0] == outs[1]


def test_g2_affine_roundtrip_vs_oracle(curves):
    ck, _ = curves
    og = ck.oracle_g2
    r = random.Random(8)
    pts = [og.scalar_mul(r.randrange(1, og.r), og.gen) for _ in range(4)]
    pts[1] = None
    A = ck.encode_g2(pts)
    assert ck.decode_g2(A) == pts
    P_ = ck.g2.from_affine(A)
    assert ck.g2.is_on_curve(P_).all()
    Q = ck.g2.add(P_, ck.g2.dbl(P_))
    assert ck.decode_g2(ck.g2.to_affine(Q)) == [og.add(p, og.dbl(p))
                                                for p in pts]
    assert ck.decode_g2(ck.g2.to_affine(ck.g2.neg(P_))) == [
        og.neg(p) for p in pts]
    bad = ck.g2.from_affine(ck.encode_g2([((1, 0), (1, 0))]))
    assert not ck.g2.is_on_curve(bad).any()


def test_bucket_scan2_plain_vs_jax():
    """K4's plain version (bucket_scan on Fp2 coordinates) against the
    composed JAX G2 madd / from_affine / select stream (m = 4, 24 lanes,
    sign, infinity and restart flags) at every segment tail and block
    end, on the main path's curve.  BN128's G2 madd is held against JAX in
    test_g2_add_dbl_madd_vs_jax."""
    ck = CurveKernels(P.BLS12_381, device="cpu")
    jck = get_curves(JP.BLS12_381)
    tw, jt = ck.tower, jck.tower
    ops, jops, jf2 = ck.g2, jck.g2, jck.g2.f
    nwin, nblk, m, nbuckets = 3, 8, 4, 20
    n = nblk * m
    xs, ys, inf, sd, idx = make_scan_inputs(ck.fp, nwin, nblk, m, 60,
                                            nbuckets, seed=6, fp2=True)
    buckets, S = kernel_curve.bucket_scan(
        ops, tw.encode_fp2(xs), tw.encode_fp2(ys), torch.from_numpy(inf),
        torch.from_numpy(sd), torch.from_numpy(idx), m, nbuckets)

    B = nwin * nblk
    lane_pos = (np.arange(nwin)[:, None] * n
                + np.arange(nblk)[None] * m).reshape(B)
    sd_f, idx_f = sd.reshape(-1), idx.reshape(-1)
    a_f = np.abs(sd_f)
    jx, jy = jt.encode_fp2(xs), jt.encode_fp2(ys)
    acc = jops.infinity((B,))
    want_b = {}
    for j in range(m):
        pos = lane_pos + j
        ii = idx_f[pos]
        x, y = jx[..., ii], jy[..., ii]
        y = jf2.select(jnp.asarray(sd_f[pos] < 0), jf2.neg(y), y)
        pt = (x, y, jnp.asarray(inf[ii]))
        new = (j == 0) | (a_f[pos] != a_f[np.maximum(pos - 1, 0)])
        acc = jops.select(jnp.asarray(new), jops.from_affine(pt),
                          jops.madd(acc, pt))
        col = pos % n
        tail = (col == n - 1) | (a_f[np.minimum(pos + 1, sd_f.size - 1)]
                                 != a_f[pos])
        dec = [jt.decode_fp2(c) for c in acc]
        for lane in np.nonzero(tail)[0]:
            key = (int(pos[lane] // n), int(a_f[pos[lane]]))
            want_b[key] = tuple(c[lane] for c in dec)
    W = ck.fp.W
    got_S = [tw.decode_fp2(s.reshape(W, 2, -1)) for s in S]
    assert got_S == [jt.decode_fp2(c) for c in acc]
    got_b = [tw.decode_fp2(b.reshape(W, 2, -1)) for b in buckets]
    for w in range(nwin):
        for d in range(nbuckets + 1):
            k = w * (nbuckets + 1) + d
            got = tuple(c[k] for c in got_b)
            assert got == want_b.get((w, d), ((0, 0), (1, 0), (0, 0))), (w, d)
