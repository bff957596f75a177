"""On the card only: one short run of each cell through the command the
benchmark's check runs, and the control at the cell's own size on three
seeds (the program's reading 0, the control's above its limit).

    python -m pytest zkbench/tests/test_zkbench_gpu.py -m gpu -o addopts="" -p no:cacheprovider
"""

import json
import subprocess
import sys

import pytest

from conftest import REPO

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "zkbench/run.py", "--workload", cell, "--seed",
         str(2**32 + 77), "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    out = subprocess.run(
        [sys.executable, "zkbench/control.py", "--workload", cell,
         "--seconds", "3", "--seeds", "101", "102", "103"],
        cwd=REPO, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert len(rows) == 3
    for row in rows:
        assert row["correct"], row
        assert any(c["value"] > c["limit"] for c in row["control"].values())
