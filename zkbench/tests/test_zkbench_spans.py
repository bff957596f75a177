"""The MSM's span readers (`metrics/msm_horner_ms.py`, `msm_host_ms.py`):
a traced run of the prover's MSM cell on the CPU at a small size reads
both from the port's span registry, Horner within the tail; each reads
None where the registry holds no MSM, and where the port has no
registry (a port older than its spans)."""

import pytest

from zkbench import harness
from zikkurat_algebra_tpu_torch.utils import profiling

SEED = 2**34 + 5
READERS = ["msm_horner_ms.prover", "msm_host_ms.prover"]


def test_traced_msm_run_reads_both(small_root):
    profiling.reset()
    res = harness.run_cell(small_root, "prover2p20-g1msm", SEED, 0.2, True,
                           "cpu", log=lambda s: None)
    assert res["correct"], res
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert all(isinstance(m[r], float) and m[r] > 0 for r in READERS), m
    assert m["msm_horner_ms.prover"] <= m["msm_tail_ms.prover"]
    assert m["msm_host_ms.prover"] >= m["msm_tail_ms.prover"]
    assert "msm_level1_ms.prover" in m


@pytest.mark.parametrize("name", READERS)
def test_reader_none_without_an_msm(small_root, monkeypatch, name):
    read = harness.load_reader(small_root, name)
    profiling.reset()
    with profiling.recording(), profiling.span("poly.mul_ntt"):
        pass
    assert read(harness.Record()) is None
    monkeypatch.delattr(profiling, "totals")
    assert read(harness.Record()) is None
    profiling.reset()
