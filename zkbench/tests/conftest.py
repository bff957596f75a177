"""Shared pieces of the benchmark's CPU tests: the repo root on sys.path,
and a benchmark root with the cells' configurations cut to sizes the
port's plain versions run in seconds on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

SMALL = {
    "msm_points": dict(msm_points=64, srs_points=16, log2_domain=6, block=16),
}


def make_small_root(tmp: Path) -> Path:
    """A copy of BENCHMARK.json and of the benchmark's files, with every
    configuration file replaced by a copy cut to a small size (the SRS
    worked out on the host, not loaded)."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    copy_tree(tmp)
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.pop("srs_file", None)
        for key, small in SMALL.items():
            if key in cfg:
                cfg.update(small)
        c["file"] = f"zkbench/configs/{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def copy_tree(tmp: Path) -> None:
    """The benchmark's files under tmp/zkbench, as in a checkout."""
    shutil.copytree(REPO / "zkbench", tmp / "zkbench", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "tests",
                                                  "data"))


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    return make_small_root(tmp_path_factory.mktemp("small"))


@pytest.fixture
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())
