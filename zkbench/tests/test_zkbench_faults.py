"""A whole run of each cell, the card's look skipped (the port's plain
versions on the CPU, at small sizes): correct on a sound program, and
`correct` false when the timed path is broken underneath (an answer
altered where it is produced, half of the batch left out), and when the
control's answers stand in the program's place."""

import pytest
import torch

from zkbench import harness
from zikkurat_algebra_tpu_torch.ops import msm as msm_mod, poly as poly_mod

SEED = 2**33 + 19


def msm_half(monkeypatch):
    orig = msm_mod.MSM.msm_std

    def half(self, k, pts, c=None, block=512, stage_seconds=None):
        h = k.shape[-1] // 2
        return orig(self, k[:, :h].contiguous(),
                    tuple(t[..., :h].contiguous() for t in pts), c,
                    min(block, h), stage_seconds)
    monkeypatch.setattr(msm_mod.MSM, "msm_std", half)


def msm_altered(monkeypatch):
    orig = msm_mod.MSM.msm_std

    def altered(self, *a, **k):
        return self.ops.dbl(orig(self, *a, **k))
    monkeypatch.setattr(msm_mod.MSM, "msm_std", altered)


def polymul_altered(monkeypatch):
    orig = poly_mod.PolyOps.mul_ntt

    def altered(self, a, b):
        out = orig(self, a, b).clone()
        out[:, 1] = self.f.add(out[:, 1], self.f.one(()))
        return out
    monkeypatch.setattr(poly_mod.PolyOps, "mul_ntt", altered)


def polymul_half(monkeypatch):
    orig = poly_mod.PolyOps.mul_ntt

    def half(self, a, b):
        b = b.clone()
        b[:, b.shape[-1] // 2:] = 0
        return orig(self, a, b)
    monkeypatch.setattr(poly_mod.PolyOps, "mul_ntt", half)


FAULTS = {
    "prover2p20-g1msm": [msm_half, msm_altered],
    "prover2p20-polymul": [polymul_altered, polymul_half],
}


def run(root, cell, **kw):
    torch.manual_seed(0)
    return harness.run_cell(root, cell, SEED, 0.2, False, "cpu",
                            log=lambda s: None, **kw)


@pytest.mark.parametrize("cell", list(FAULTS))
def test_sound_run_is_correct_and_control_is_not(small_root, cell):
    res = run(small_root, cell, with_control=True)
    assert res["correct"], res
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    assert any(c["value"] > c["limit"]
               for c in res["control_checks"].values()), res


@pytest.mark.parametrize("cell, fault", [
    (cell, f) for cell, fs in FAULTS.items() for f in fs],
    ids=lambda x: getattr(x, "__name__", x))
def test_broken_path_is_not_correct(small_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = run(small_root, cell)
    assert not res["correct"], res
