"""The port's per-curve API (zikkurat_algebra_tpu_torch.api), its
profiling helpers and its typed errors against the JAX package's, as in
tests/test_api.py::test_curve_api_shape and tests/test_aux.py.

Inputs are integers from a numpy seed, fed to both packages; results are
compared as decoded integers mod p, exactly.
"""

import json

import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu import api as japi
from zikkurat_algebra_tpu_torch import api, params as P
from zikkurat_algebra_tpu_torch.errors import (
    DimensionError, DomainSizeError, MeshError, UnsupportedError,
    ZikkuratError)
from zikkurat_algebra_tpu_torch.ops import kernel_field, msm
from zikkurat_algebra_tpu_torch.ops.tower import get_tower
from zikkurat_algebra_tpu_torch.parallel.mesh import make_mesh
from zikkurat_algebra_tpu_torch.utils import profiling

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)


def rand_ints(seed, p, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % p for _ in range(n)]


@pytest.mark.parametrize("name", ["bn128", "bls12_381"])
def test_curve_api_vs_jax(name):
    """The fields' moduli, fr.sqr, ntt_domain(3) and poly.eval_at of the
    port's API equal the JAX API's on the same integers."""
    port, jax = getattr(api, name)("cpu"), getattr(japi, name)()
    assert port.params.name == jax.params.name
    assert (port.fp.p, port.fr.p) == (jax.fp.p, jax.fr.p)
    f, jf = port.fr, jax.fr
    vals = rand_ints(1, f.p, 8)
    assert f.decode(f.sqr(f.encode(vals))) == \
        jf.decode(jf.sqr(jf.encode(vals))) == [v * v % f.p for v in vals]
    dom, jdom = port.ntt_domain(3), jax.ntt_domain(3)
    assert dom.n == jdom.n == 8 and dom.gen == jdom.gen
    assert f.decode(dom.ntt(f.encode(vals))) == \
        jf.decode(jdom.ntt(jf.encode(vals)))
    x = rand_ints(2, f.p, 1)[0]
    assert f.decode(port.poly.eval_at(f.encode(x), f.encode(vals))) == \
        jf.decode(jax.poly.eval_at(jf.encode(x), jf.encode(vals)))
    assert f.decode(port.poly.eval_at(f.encode(2), f.encode([1, 2, 3]))) \
        == 17
    # the API's objects are the cached ones of each layer
    assert port is getattr(api, name)(torch.device("cpu"))
    assert port.tower is get_tower(port.params, "cpu")
    assert port.msm_g1 is port.curves.msm("g1")
    assert port.group_fft(2).n == 4
    assert port.pairing.ck is port.curves


def test_curve_api_bls12_377_has_no_g2():
    """BLS12-377 (fields, tower and G1 only) raises on every G2 entry."""
    a = api.curve_api("BLS12-377", "cpu")
    assert a.g2 is None and a.g1 is not None and a.fp2 is not None
    for call in (lambda: a.msm_g2, lambda: a.pairing,
                 lambda: a.group_fft(2, grp="g2")):
        with pytest.raises(UnsupportedError):
            call()
    assert a.msm_g1.fr is a.fr


def test_bigint_and_fields_reexported():
    assert api.bigint(256, "cpu").W == 8
    assert api.get_field(P.BN128_FR, "cpu").p == P.BN128_FR.p
    f = api.get_field(P.BN128_FR, "cpu")
    assert api.get_domain(f, 2).n == 4


def test_mul_many_one_launch(monkeypatch):
    """Field.mul_many takes (W, K, *batch) stacks in one product call."""
    f = api.bn128("cpu").fr
    av, bv = rand_ints(3, f.p, 6), rand_ints(4, f.p, 6)
    a = f.encode(av).view(f.W, 2, 3)
    b = f.encode(bv).view(f.W, 2, 3)
    calls = []
    plain = kernel_field.mont_mul_plain

    def counting(x, y, fld):
        calls.append(tuple(x.shape))
        return plain(x, y, fld)

    monkeypatch.setattr(f, "_mont_mul", counting)
    out = f.mul_many(a, b)
    assert calls == [(f.W, 2, 3)]
    assert f.decode(out) == [x * y % f.p for x, y in zip(av, bv)]


def test_profiling_helpers(tmp_path):
    """Counters and timed as tests/test_aux.py::test_profiling_helpers;
    trace writes a Chrome trace that names an aten operation."""
    c = profiling.Counters()
    c.add("mul", 1000, 0.5)
    c.add("mul", 1000, 0.5)
    assert c.rate("mul") == 2000.0 and c.report() == {"mul": 2000.0}
    assert c.rate("none") == 0.0
    secs, r = profiling.timed(lambda x: x * 2, torch.arange(8), iters=2)
    assert secs >= 0 and int(r[3]) == 6
    profiling.force((r, [r], {"a": r}, None))
    with profiling.trace(str(tmp_path)) as prof:
        torch.arange(64).reshape(8, 8).sum(0)
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "aten::sum" in names
    assert any(e.key == "aten::sum" for e in prof.key_averages())


def test_trace_holds_the_port_spans(tmp_path):
    """Under profiling.trace the port's spans are `zk.` ranges in the
    Chrome trace, beside the aten operations on the profiler's clock;
    the registry records nothing there, even under recording()."""
    ck = api.bls12_381("cpu").curves
    og = ck.oracle_g1
    pts = [og.scalar_mul(s, og.gen) for s in (3, 5)] * 8
    ks = list(range(1, 17))
    m = msm.MSM(ck.g1, 8)
    profiling.reset()
    with profiling.trace(str(tmp_path)):
        with profiling.recording():
            res = m.msm_std(ck.fr.encode(ks, mont=False), ck.encode_g1(pts),
                            4, 8)
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    zk = {e["name"]: e for e in events["traceEvents"]
          if e.get("name", "").startswith("zk.")}
    assert {"zk.msm.std", "zk.msm.horner", "zk.msm.bucket_scan"} <= set(zk)
    std, horner = zk["zk.msm.std"], zk["zk.msm.horner"]
    assert std["ts"] <= horner["ts"]
    assert horner["ts"] + horner["dur"] <= std["ts"] + std["dur"]
    assert profiling.records() == [] and profiling.totals() == {}
    assert ck.decode_g1(ck.g1.to_affine(res)) == og.msm(ks, pts)


def test_typed_boundary_errors():
    """The typed errors of tests/test_aux.py::test_typed_boundary_errors,
    and MeshError: a mesh needs a process group."""
    a = api.bn128("cpu")
    f = a.fr
    with pytest.raises(DomainSizeError):
        a.ntt_domain(3).ntt(f.encode(list(range(4))))
    ks = f.encode([1, 2, 3], mont=False)
    pts = a.curves.encode_g1([a.curves.oracle_g1.gen] * 4)
    with pytest.raises(DimensionError):
        a.msm_g1.msm_std(ks, pts, 4)
    with pytest.raises(MeshError):
        make_mesh()
    for e in (DimensionError, DomainSizeError, MeshError, UnsupportedError):
        assert issubclass(e, ZikkuratError) and issubclass(e, ValueError)
