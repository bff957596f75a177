"""The plain reference's BLS12-381 arithmetic on known constants, its KZG
scalars, the frozen setup against its tau, and the bounds of kernels K2
and K5 against the numbers PERF.md records."""

import json
import random

import pytest
import torch

from conftest import REPO
from zkbench import bls, counts, inputs
from zikkurat_algebra_tpu_torch import params


def test_constants_match_the_published_curve():
    c = params.BLS12_381
    assert bls.P == c.fp.p and bls.R == c.fr.p and bls.B == c.b
    assert bls.G1_GEN == c.g1_gen and bls.G2_GEN == c.g2_gen
    assert bls.on_curve(bls.G1_GEN) and bls.g2_on_curve(bls.G2_GEN)
    # the Fr domain of 2^32 the port uses: 7^((r - 1) / 2^32)
    assert bls.root_of_unity(1 << 32) == c.fr.fft_domain[1]


def test_generators_have_order_r():
    assert bls.g1_mul(bls.R, bls.G1_GEN) is None
    assert bls.g1_mul(bls.R - 1, bls.G1_GEN) == bls.g1_neg(bls.G1_GEN)
    minus = bls.g2_mul(bls.R - 1, bls.G2_GEN)
    assert minus[0] == bls.G2_GEN[0]
    assert bls.f2_add(minus[1], bls.G2_GEN[1]) == (0, 0)


def test_fixed_base_equals_double_and_add():
    fb = bls.FixedBase()
    rnd = random.Random(7)
    ks = [0, 1, 2, 15, 16, bls.R - 1] + [rnd.randrange(bls.R)
                                         for _ in range(6)]
    want = [bls.g1_mul(k, bls.G1_GEN) for k in ks]
    assert [fb.mul(k) for k in ks] == want == fb.mul_many(ks)
    a, b = rnd.randrange(bls.R), rnd.randrange(bls.R)
    assert bls.g1_add(fb.mul(a), fb.mul(b)) == fb.mul(a + b)


def test_kzg_scalars():
    rnd = random.Random(8)
    n, tau, x0 = 16, rnd.randrange(bls.R), rnd.randrange(bls.R)
    ws = bls.domain(n)
    assert pow(ws[1], n, bls.R) == 1 and pow(ws[1], n // 2, bls.R) != 1
    assert sum(bls.lagrange_at(tau, n)) % bls.R == 1
    coeffs = [rnd.randrange(bls.R) for _ in range(n)]
    values = [bls.eval_coeffs(coeffs, w) for w in ws]
    assert bls.eval_values(values, x0) == bls.eval_coeffs(coeffs, x0)
    c, y0, q = bls.kzg_prove(values, tau, x0)
    assert c == bls.eval_coeffs(coeffs, tau)
    assert bls.kzg_valid(c, q, x0, y0, tau)
    assert not bls.kzg_valid(c, q, x0, y0 + 1, tau)
    assert not bls.kzg_valid(c, q + 1, x0, y0, tau)


def test_frozen_setup_is_of_its_tau():
    cfg = json.loads((REPO / "zkbench/configs/bls12_381-prover-2p20.json")
                     .read_text())
    srs = inputs.load_srs(REPO, cfg)
    tau, n = srs["tau"], srs["n"]
    assert n == 4096 and tau == int(cfg["tau"], 16)
    lag = bls.lagrange_at(tau, n)
    fb = bls.FixedBase()
    for i in (0, 1, 2, 1234, n - 1):
        assert srs["tau_g1"][i] == fb.mul(pow(tau, i, bls.R))
        assert srs["lagrange_g1"][i] == fb.mul(lag[i])
    assert srs["tau_g2"] == bls.g2_mul(tau, bls.G2_GEN)


def test_k5_bound_matches_perf_md():
    """PERF.md section 6: 0.1489 ms per 2^20 transform at W = 8 (operations)."""
    b, by = counts.bound_s(*counts.ntt_work(8, 20))
    assert by == "operations" and round(b * 1e3, 4) == 0.1489
    b2, _ = counts.bound_s(*counts.ntt_work(2, 20))
    assert round(b2 * 1e3, 4) == 0.0102


def test_k2_bound_matches_perf_md():
    """PERF.md section 6: 7.177 ms for the 2^20 G1 MSM's bucket scan
    (c = 15, block 512, 18 rows with the carry row), here on uniform
    scalars sorted the way K3 sorts them."""
    from zikkurat_algebra_tpu_torch.ops.msm import (digits_from_limbs,
                                                    signed_digits)

    k = inputs.uniform_limbs(inputs.torch_gen(5, "cpu", 1), bls.R, 1 << 20,
                             "cpu")
    sd = signed_digits(digits_from_limbs(k, 15, 255), 15)
    order = torch.sort(sd.abs(), dim=1, stable=True).indices
    sd = torch.gather(sd, 1, order)
    nbytes, nops, madds = counts.scan_work(
        12, 1, 1 << 20, torch.zeros_like(sd, dtype=torch.bool), sd, 512,
        (1 << 14) + 1)
    b, by = counts.bound_s(nbytes, nops)
    assert by == "operations"
    assert b * 1e3 == pytest.approx(7.177, rel=0.01)
    assert madds < 18 << 20


def test_busy_union_and_idle_labels():
    ks = [("a", 0, 10), ("b", 5, 10), ("c", 30, 5)]
    assert counts.busy_ns(ks) == 20
    labels = [("outer", 0, 40), ("inner", 16, 10)]
    assert counts.idle_by_label(ks, labels, 0, 40) == {"inner": 15,
                                                       "outer": 5}
    assert counts.kernel_name("void zk::bucket_scan_kernel<12>(int*, int)") \
        == "zk::bucket_scan_kernel<12>"
