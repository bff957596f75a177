"""What the benchmark may import: nothing of JAX or the JAX package in a
run (compared by whole top-level name), nothing of the port in the plain
reference, and nothing of the old TPU-era scripts anywhere."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import REPO
from zkbench import harness

BENCH = REPO / "zkbench"
REFERENCE = ["bls.py", "counts.py", "inputs.py", "readers.py"]


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("mods, bad", [
    (["zikkurat_algebra_tpu_torch", "zikkurat_algebra_tpu_torch.ops"], []),
    (["zikkurat_algebra_tpu.ops.msm"], ["zikkurat_algebra_tpu"]),
    (["jax", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["jaxtyping", "flax_like", "flax.linen"], ["flax"]),
])
def test_forbidden_by_whole_top_level_name(monkeypatch, mods, bad):
    for m in [m for m in sys.modules if m.split(".")[0] in
              harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    for m in mods:
        monkeypatch.setitem(sys.modules, m, object())
    assert harness.forbidden_modules() == bad


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_imports_nothing_of_the_port(name):
    for mod in imported(BENCH / name):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "zikkurat_algebra_tpu",
                           "zikkurat_algebra_tpu_torch"), (name, mod)


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import zkbench.bls, zkbench.counts, zkbench.inputs, "
            "zkbench.readers\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    for top in ("zikkurat_algebra_tpu_torch", "zikkurat_algebra_tpu", "jax",
                "torch"):
        assert f"'{top}'" not in out


def test_no_file_reads_the_old_scripts():
    py = [p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts
          and "tests" not in p.parts]
    assert py
    for p in py:
        for mod in imported(p):
            top = mod.split(".")[0]
            assert top not in ("bench", "chip_smoke", "scripts", "jax",
                               "zikkurat_algebra_tpu"), (p, mod)
        text = p.read_text()
        for word in ("bench_data", "chip_smoke", "BENCH_r0", "MULTICHIP_r0"):
            assert word not in text, (p, word)


def test_run_without_a_card_fails_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "prover2p20-g1msm", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=REPO,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
