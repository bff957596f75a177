"""Data carried between the JAX package and the port, the kernel loader's
refusal to fall back, and the rule that the port imports no JAX."""

import ast
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from zikkurat_algebra_tpu import params as JP
from zikkurat_algebra_tpu.ops.curve import get_curves
from zikkurat_algebra_tpu.ops.field import get_field
from zikkurat_algebra_tpu.ops.tower import get_tower
from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.ops.curve import CurveKernels
from zikkurat_algebra_tpu_torch.ops.field import Field
from zikkurat_algebra_tpu_torch.utils import build, convert

pytest_plugins = ["memory_guard"]
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("pair", [(P.BLS12_381_FP, JP.BLS12_381_FP),
                                  (P.BLS12_381_FR, JP.BLS12_381_FR),
                                  (P.BN128_FP, JP.BN128_FP)],
                         ids=lambda pr: pr[0].name)
def test_limbs15_roundtrip_vs_jax(pair):
    f, jf = Field(pair[0], device="cpu"), get_field(pair[1])
    r = random.Random(8)
    vals = [0, 1, f.p - 1] + [r.randrange(f.p) for _ in range(20)]
    jm = np.asarray(jf.mul(jf.encode(vals), jf.one((len(vals),))))  # lazy
    port = convert.from_jax_limbs15(jm, f)
    assert f.decode(torch.from_numpy(port)) == vals
    back = convert.to_jax_limbs15(port, f)
    assert back.shape == (jf.L, len(vals))
    assert jf.decode(back) == vals
    std = convert.from_jax_limbs15(np.asarray(jf.encode(vals, mont=False)),
                                   f, mont=False)
    assert f.decode(torch.from_numpy(std), mont=False) == vals
    assert jf.decode(convert.to_jax_limbs15(std, f, mont=False),
                     mont=False) == vals


def test_load_jax_seed_points():
    """The committed bench seeds read by the port equal the JAX package's
    decoding of the same file, and lie on the curve."""
    path = ROOT / "bench_data" / "seeds_BLS12_381_g1.npz"
    ck = CurveKernels(P.BLS12_381, device="cpu")
    x, y, inf = convert.load_jax_seed_points(path, ck.fp)
    assert x.shape == (12, 1024) and inf.shape == (1024,)
    jck = get_curves(JP.BLS12_381)
    with np.load(path) as z:
        want = jck.decode_g1((z["x"][:, :32], z["y"][:, :32], z["inf"][:32]))
    assert ck.decode_g1((x[:, :32], y[:, :32], inf[:32])) == want
    assert ck.g1.is_on_curve(ck.g1.from_affine((x, y, inf))).all()
    assert all(ck.oracle_g1.is_on_curve(pt) for pt in want)


def test_fp2_planes_and_g2_seeds_vs_jax():
    """JAX (L, 2, N) Fp2 planes <-> port (W, 2, N) limbs against the JAX
    encode_fp2, and the committed G2 bench seeds read by the port as
    oracle points on the curve, equal to the JAX decoding."""
    ck = CurveKernels(P.BLS12_381, device="cpu")
    jt = get_tower(JP.BLS12_381)
    r = random.Random(9)
    vals = [(0, 1), (ck.fp.p - 1, 0)] + [(r.randrange(ck.fp.p),
                                          r.randrange(ck.fp.p))
                                         for _ in range(6)]
    jm = np.asarray(jt.encode_fp2(vals))
    port = convert.from_jax_limbs15(jm, ck.fp)
    assert port.shape == (ck.fp.W, 2, len(vals))
    assert ck.tower.decode_fp2(torch.from_numpy(port)) == vals
    back = convert.to_jax_limbs15(port, ck.fp)
    assert back.shape == jm.shape and jt.decode_fp2(back) == vals

    path = ROOT / "bench_data" / "seeds_BLS12_381_g2.npz"
    x, y, inf = convert.load_jax_seed_points(path, ck.fp)
    assert x.shape == (12, 2, 1024) and inf.shape == (1024,)
    jck = get_curves(JP.BLS12_381)
    with np.load(path) as z:
        want = jck.decode_g2((z["x"][..., :16], z["y"][..., :16],
                              z["inf"][:16]))
    assert ck.decode_g2((x[..., :16], y[..., :16], inf[:16])) == want
    assert all(ck.oracle_g2.is_on_curve(pt) for pt in want)
    assert ck.g2.is_on_curve(ck.g2.from_affine((x, y, inf))).all()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No toolchain means an error, never a quiet plain-torch path."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["mont_mul"])


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = sorted((ROOT / "zikkurat_algebra_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "zikkurat_algebra_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_port_and_chip_smoke_load_no_jax():
    """Importing the port's modules and chip_smoke.py in a fresh process
    leaves jax and the JAX package out of sys.modules."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import zikkurat_algebra_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'zikkurat_algebra_tpu')]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
