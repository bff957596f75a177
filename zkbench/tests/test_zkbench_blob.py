"""The blob cell (`blob4096-prove`): a whole traced run on the CPU at a
small size (blobs of 16 elements, two a batch) is correct, reads its
span metrics, and fails its control; `correct` is false when a byte of
the answer is altered and when half of the batch is left out; the new
readers read None where the registry holds no blob operation, and where
the port has no registry.  On the card, one traced run at the cell's
own size."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import REPO, make_small_root
from zkbench import harness
from zikkurat_algebra_tpu_torch.protocols import eip4844
from zikkurat_algebra_tpu_torch.utils import profiling

CELL = "blob4096-prove"
SEED = 2**33 + 41
READERS = ["kzg_commit_ms.blob", "kzg_open_ms.blob", "kzg_host_ms.blob"]
SPAN_METRICS = READERS + ["msm_horner_ms.blob"]


@pytest.fixture(scope="module")
def blob_root(tmp_path_factory):
    """A small root whose blob configuration has 16 elements a blob (its
    setup worked out on the host) and whose mix has 2 blobs an op."""
    root = make_small_root(tmp_path_factory.mktemp("blob"))
    path = root / "zkbench/configs/bls12_381-kzg-blob4096.json"
    cfg = json.loads(path.read_text())
    cfg.update(field_elements_per_blob=16, srs_points=16, window_bits=4)
    path.write_text(json.dumps(cfg))
    path = root / "zkbench/traffic/blob_prove.json"
    mix = json.loads(path.read_text())
    mix.update(blobs=2, warmup_ops=0, profile_ops=1, judge_ops=2)
    path.write_text(json.dumps(mix))
    return root


def run(root, trace=False, **kw):
    torch.manual_seed(0)
    profiling.reset()
    try:
        return harness.run_cell(root, CELL, SEED, 0.1, trace, "cpu",
                                log=lambda s: None, **kw)
    finally:
        profiling.reset()


def test_traced_run_is_correct_and_control_is_not(blob_root):
    res = run(blob_root, trace=True, with_control=True)
    assert res["correct"], res
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["checks"]["wrong_blob_results"]["value"] == 0
    assert res["control_checks"]["wrong_blob_results"]["value"] > 0, res
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert all(isinstance(m[r], float) and m[r] > 0 for r in SPAN_METRICS), m
    assert m["kzg_commit_ms.blob"] + m["kzg_open_ms.blob"] \
        <= m["kzg_host_ms.blob"]


def _altered(monkeypatch):
    orig = eip4844.prove_blobs

    def altered(setup, blobs):
        cms, proofs = orig(setup, blobs)
        proofs = proofs.clone()
        proofs[0, 47] ^= 1
        return cms, proofs
    monkeypatch.setattr(eip4844, "prove_blobs", altered)


def _half(monkeypatch):
    orig = eip4844.prove_blobs

    def half(setup, blobs):
        return orig(setup, blobs[:blobs.shape[0] // 2])
    monkeypatch.setattr(eip4844, "prove_blobs", half)


@pytest.mark.parametrize("fault", [_altered, _half],
                         ids=lambda f: f.__name__.strip("_"))
def test_broken_path_is_not_correct(blob_root, monkeypatch, fault):
    fault(monkeypatch)
    res = run(blob_root)
    assert not res["correct"], res


@pytest.mark.parametrize("name", READERS)
def test_reader_none_without_a_blob_operation(blob_root, monkeypatch, name):
    read = harness.load_reader(blob_root, name)
    profiling.reset()
    with profiling.recording(), profiling.span("kzg.blob_commit"):
        pass
    assert read(harness.Record()) is None
    monkeypatch.delattr(profiling, "totals")
    assert read(harness.Record()) is None
    profiling.reset()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


@pytest.mark.gpu
def test_traced_run_on_the_card(card):
    """One traced run at 4096 elements and 6 blobs: correct, and every
    per-layer metric of the cell read."""
    out = subprocess.run(
        [sys.executable, "zkbench/run.py", "--workload", CELL, "--seed",
         str(2**32 + 91), "--seconds", "5", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res
    cell = harness.load_cell(REPO, CELL)
    assert {m["name"] for m in cell.per_layer} <= set(res["metrics"]), res
