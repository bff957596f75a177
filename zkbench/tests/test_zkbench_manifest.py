"""BENCHMARK.json against the benchmark's contract, and the rule that a new
configuration, traffic mix or metric is added as files alone."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from conftest import REPO, copy_tree
from zkbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


def line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(bench["command"]) <= 32
    assert all(line_ok(w) for w in bench["command"])
    for w in bench["command"]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in bench["paths"])
    assert 1 <= bench["run_seconds"] <= 51


def test_run_seconds_fits_the_check_at_24_cells(bench):
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_unique_and_well_formed(bench, kind):
    names = [e["name"] for e in bench[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_names_unique_across_kinds(bench):
    names = [m["name"] for k in ("end_to_end", "per_layer")
             for m in bench[k]]
    assert len(names) == len(set(names))


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"] and cfg["assumed"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg
            assert not re.search(r"(_dim|_rank|hidden|width|limbs)$", k)


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and line_ok(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = json.loads(harness.find(REPO, "traffic", w["traffic"],
                                      ".json").read_text())
        assert harness.find(REPO, "ops", mix["op"], ".py").exists()
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in E2E_SOURCES
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and line_ok(m["layer"])
        assert m["moves"] in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert harness.find(REPO, "metrics", harness.reader_name(m["name"]),
                            ".py").exists()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        cell = harness.load_cell(REPO, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:          # what it moves is reported here
            assert m["moves"] in names


def test_layers_named_alike(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    perf = (REPO / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf, layer


def _digest(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_are_files_only(tmp_path):
    """A later change adds a cell by files and entries alone: here a
    configuration, a traffic mix and a metric reader in a copy of the
    benchmark, found by name, with no file of the benchmark edited.  A
    quantity already split by cell gets the new cell's entry and no file."""
    before = _digest(REPO / "zkbench")
    root = tmp_path
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    copy_tree(root)
    before_copy = _digest(root / "zkbench")
    cfg = json.loads((REPO / "zkbench/configs/bls12_381-prover-2p20.json")
                     .read_text())
    cfg.update(name="bls12_381-prover-2p24", msm_points=1 << 24,
               log2_domain=24)
    (root / "zkbench/configs/bls12_381-prover-2p24.json").write_text(
        json.dumps(cfg))
    (root / "zkbench/traffic/g1msm_twice.json").write_text(json.dumps(
        {"op": "g1msm", "loop": "closed", "clients": 1, "warmup_ops": 2,
         "profile_ops": 1}))
    (root / "zkbench/metrics/msm_calls.py").write_text(
        "def read(rec):\n    return float(len(rec.op_s))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(
        name="bls12_381-prover-2p24", source="x", reduced=["msm_points"],
        file="zkbench/configs/bls12_381-prover-2p24.json", why="y"))
    bench["workloads"].append(dict(
        name="prover2p24-g1msm", config="bls12_381-prover-2p24",
        traffic="g1msm_twice", chips=1, why="z"))
    bench["per_layer"].append(dict(
        name="msm_calls.prover24", unit="calls", better="higher",
        source="host_clock", layer="MSM stages (ops/msm.py)",
        moves="msm_points_per_s", workloads=["prover2p24-g1msm"]))
    bench["per_layer"].append(dict(
        name="device_idle_pct.prover24", unit="%", better="lower",
        source="device_trace", layer="device (H100)",
        moves="msm_points_per_s", workloads=["prover2p24-g1msm"]))
    bench["end_to_end"][1]["workloads"].append("prover2p24-g1msm")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell(root, "prover2p24-g1msm")
    assert cell.config["msm_points"] == 1 << 24
    assert cell.mix["warmup_ops"] == 2
    assert [m["name"] for m in cell.per_layer] == [
        "msm_calls.prover24", "device_idle_pct.prover24"]
    rec = harness.Record(op_s=[1.0, 2.0], units=[4.0, 4.0],
                         prof=dict(busy_s=0.5, wall_untraced_s=2.0))
    assert harness.load_reader(root, "msm_calls.prover24")(rec) == 2.0
    assert harness.load_reader(root, "msm_points_per_s")(rec) == 8.0 / 3
    assert harness.load_reader(root, "device_idle_pct.prover24")(rec) == 75.0
    assert harness.load_operation(root, cell.mix["op"]).Operation
    after_copy = _digest(root / "zkbench")
    assert {k: v for k, v in after_copy.items() if k in before_copy} \
        == before_copy
    assert set(after_copy) - set(before_copy) == {
        "configs/bls12_381-prover-2p24.json", "traffic/g1msm_twice.json",
        "metrics/msm_calls.py"}
    assert _digest(REPO / "zkbench") == before
