"""One run of one cell: set-up, warm-up, the closed loop of the window,
the traced phase, the judgement and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name under `zkbench/` of the checkout: `configs/<config>.json`,
`traffic/<mix>.json` (which names its operation module,
`ops/<op>.py`), `metrics/<metric>.py` (the metric's name up to its first
dot, so `device_idle_pct.prover` and `device_idle_pct.polymul` share
`metrics/device_idle_pct.py`).  `BENCHMARK.json` pairs them into cells.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import counts

FORBIDDEN = ("jax", "jaxlib", "flax", "zikkurat_algebra_tpu")
PROFILE_INDEX = 1 << 40          # operation indices of the traced phase
WARMUP_INDEX = 1 << 41           # and of the warm-up


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is, as a
    whole, JAX, jaxlib, flax or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# -- finding the pieces of a cell by name --------------------------------------------

def find(root: Path, kind: str, name: str, ext: str) -> Path:
    """root/zkbench/<kind>/<name><ext>."""
    p = Path(root) / "zkbench" / kind / f"{name}{ext}"
    if not p.exists():
        raise FileNotFoundError(f"no {p}")
    return p


def load_module(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    ws = [w for w in bench["workloads"] if w["name"] == name]
    if not ws:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = ws[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads(find(root, "traffic", w["traffic"], ".json").read_text())
    return Cell(name=name, chips=w["chips"], config=config, mix=mix,
                end_to_end=[m for m in bench["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def load_operation(root: Path, op: str):
    return load_module(find(root, "ops", op, ".py"), f"zkbench_op_{op}")


def reader_name(metric: str) -> str:
    """A quantity split by cell (`name.cell`) has one reader."""
    return metric.split(".")[0]


def load_reader(root: Path, metric: str) -> Callable:
    name = reader_name(metric)
    return load_module(find(root, "metrics", name, ".py"),
                       f"zkbench_metric_{name}").read


# -- the record a run leaves for the metric readers ------------------------------------

@dataclass
class Record:
    card: str = ""
    setup_s: float = 0.0
    op_s: List[float] = field(default_factory=list)       # each whole op
    units: List[float] = field(default_factory=list)      # work per op
    spans: Dict[str, List[float]] = field(default_factory=dict)  # per op
    stages: Dict[str, float] = field(default_factory=dict)  # summed
    launches: Dict[str, int] = field(default_factory=dict)  # over the ops
    prof: Optional[dict] = None                              # traced phase

    def span_ms(self, *names: str) -> Optional[float]:
        """Mean per op of the named spans' summed time, in ms."""
        if not self.op_s or not all(n in self.spans for n in names):
            return None
        tot = sum(sum(self.spans[n]) for n in names)
        return 1e3 * tot / len(self.op_s)


# -- spans: the port's methods wrapped from here, in the traced run only --------------

def _resolve(target: str):
    """'pkg.module:Class.attr' or 'pkg.module:func' -> (owner, attr)."""
    modname, _, qual = target.partition(":")
    owner = importlib.import_module(modname)
    parts = qual.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


@contextlib.contextmanager
def wrapped(targets: Dict[str, str], make: Callable):
    """Replace each target ('module:qualname' -> span name) by
    make(span name, original) for the body, and put them back."""
    saved = []
    try:
        for target, span in targets.items():
            owner, attr = _resolve(target)
            orig = getattr(owner, attr)
            saved.append((owner, attr, orig))
            setattr(owner, attr, make(span, orig))
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


def timed_span(sink: Dict[str, float], sync: Callable):
    def make(span, fn):
        def inner(*a, **k):
            sync()
            t = time.perf_counter()
            out = fn(*a, **k)
            sync()
            sink[span] = sink.get(span, 0.0) + time.perf_counter() - t
            return out
        return inner
    return make


def label_span(make_label):
    def make(span, fn):
        def inner(*a, **k):
            with make_label("zkbench/" + span):
                return fn(*a, **k)
        return inner
    return make


# -- the device -------------------------------------------------------------------------

def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


# -- the run ------------------------------------------------------------------------------

def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             log=lambda s: print(s, file=sys.stderr, flush=True),
             with_control: bool = False) -> dict:
    """Run one cell once and return the result object (its `checks` key
    last).  device="cpu" runs the port's plain versions (tests only).
    with_control also judges the control's answers in the program's place
    (`control_checks`; zkbench/control.py, never the benchmark's runs)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    cell = load_cell(root, name)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: torch.cuda.is_available() is "
                               "False")
        if torch.cuda.device_count() < cell.chips:
            raise RuntimeError(f"{name} needs {cell.chips} cards, "
                               f"{torch.cuda.device_count()} present")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    rec = Record(card=torch.cuda.get_device_name(dev)
                 if dev.type == "cuda" else "cpu")

    drv = load_operation(root, cell.mix["op"]).Operation(
        root=Path(root), config=cell.config, mix=cell.mix, seed=seed,
        device=dev)
    drv.setup()
    for j in range(cell.mix.get("warmup_ops", 1)):
        drv.run(drv.inputs(WARMUP_INDEX + j), None)
        sync()
    rec.setup_s = time.perf_counter() - t_start
    log(f"# {name} seed {seed}: set-up {rec.setup_s:.3f} s on {rec.card}")

    counters = drv.counters()
    before = {k: c() for k, c in counters.items()}
    span_sink: Dict[str, float] = {}
    tracer = dict(stages=rec.stages) if trace else None
    failed = 0
    ctx = wrapped(drv.SPANS, timed_span(span_sink, sync)) if trace \
        else contextlib.nullcontext()
    with ctx:
        t_end = time.perf_counter() + seconds
        i = 0
        while time.perf_counter() < t_end:
            args = drv.inputs(i)
            sync()
            t = time.perf_counter()
            try:
                out = drv.run(args, tracer)
                sync()
            except Exception:                 # counted, judged below
                failed += 1
                log(f"# op {i} failed:\n{traceback.format_exc()}")
                out = None
            dt = time.perf_counter() - t
            if out is not None:
                rec.op_s.append(dt)
                rec.units.append(drv.units(args))
                drv.keep(i, args, out)
            for k in drv.SPANS.values():
                rec.spans.setdefault(k, []).append(span_sink.pop(k, 0.0))
            i += 1
    attempted = i
    if rec.op_s:
        xs = sorted(rec.op_s)
        q = [xs[int(f * (len(xs) - 1))] for f in (0, .25, .5, .75, 1)]
        log(f"# window: {len(xs)} ops, op seconds min/q1/median/q3/max "
            + " ".join(f"{v:.6f}" for v in q))
    rec.launches = {k: c() - before[k] for k, c in counters.items()}

    device_block = dict(platform="gpu" if dev.type == "cuda" else "cpu",
                        kind=rec.card, count=cell.chips)
    if dev.type == "cuda":
        device_block["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(dev))
        device_block["power_limit"] = power_limit()
    breakdown = None
    if trace:
        rec.prof = profile_phase(drv, cell, sync, dev, log)
        if dev.type == "cuda":
            device_block["busy_s"] = rec.prof["busy_s"]
            device_block["window_s"] = rec.prof["window_s"]
            breakdown = rec.prof["breakdown"]

    t = time.perf_counter()
    drv.release()
    checks = drv.judge()
    log(f"# judged in {time.perf_counter() - t:.3f} s")
    control = drv.control() if with_control else None
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{bad}")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_reader(root, m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    correct = (failed == 0 and bool(rec.op_s)
               and all(c["value"] <= c["limit"] for c in checks))
    result = dict(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics, device=device_block)
    if breakdown is not None:
        result["breakdown"] = breakdown
    if trace:
        result["trace_records"] = rec.prof["records"]
    if control is not None:
        result["control_checks"] = {
            c["name"]: dict(value=c["value"], limit=c["limit"])
            for c in control}
    result["checks"] = {c["name"]: dict(value=c["value"], limit=c["limit"])
                        for c in checks}
    return result


def profile_phase(drv, cell: Cell, sync, dev, log) -> Optional[dict]:
    """The same few ops (fixed inputs) untraced, then under torch.profiler
    with the operation's labels: kernel sums, busy time, idle gaps by label,
    kernel records against the launch counters.  A window that lost
    records of a kernel a metric needs is tried again (three times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    k = cell.mix.get("profile_ops", 1)
    args = [drv.inputs(PROFILE_INDEX + j) for j in range(k)]
    work = drv.kernel_work(args[0])
    sync()
    t = time.perf_counter()
    for a in args:
        drv.run(a, None)
        sync()
    wall_untraced = time.perf_counter() - t
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    counters = drv.counters()
    for attempt in range(3):
        before = {n: c() for n, c in counters.items()}
        with wrapped(drv.LABELS, label_span(record_function)):
            with profile(activities=acts) as prof:
                sync()
                t = time.perf_counter()
                for a in args:
                    drv.run(a, None)
                    sync()
                wall_traced = time.perf_counter() - t
        launched = {n: c() - before[n] for n, c in counters.items()}
        kernels, labels = [], []
        for e in prof.profiler.kineto_results.events():
            nm = e.name()
            if nm.startswith("zkbench/"):   # a label, on either timeline
                if e.device_type() != torch.autograd.DeviceType.CUDA:
                    labels.append((nm[len("zkbench/"):], e.start_ns(),
                                   e.duration_ns()))
            elif e.device_type() == torch.autograd.DeviceType.CUDA \
                    and not e.is_user_annotation() and e.duration_ns() > 0:
                kernels.append((nm, e.start_ns(), e.duration_ns()))
        del prof
        sums = counts.by_name(kernels)
        records = {}
        for counter, kname in drv.KERNELS.items():
            seen = sum(c for n, (_, c) in sums.items() if kname in n)
            records[counter] = dict(launched=launched.get(counter, 0),
                                    recorded=seen)
        lost = {c: r for c, r in records.items()
                if r["recorded"] < r["launched"]}
        if lost:
            log(f"# profiler lost kernel records (attempt {attempt + 1}): "
                f"{json.dumps(lost)}")
        if not any(c in drv.NEED_RECORDS for c in lost):
            break
    busy = counts.busy_ns(kernels) / 1e9
    t0 = min(s for _, s, _ in kernels) if kernels else 0
    t1 = max(s + d for _, s, d in kernels) if kernels else 0
    idle = counts.idle_by_label(kernels, labels, t0, t1) if kernels else {}
    top = sorted(sums.items(), key=lambda kv: -kv[1][0])
    log(f"# traced {k} op(s): {wall_traced:.3f} s traced, "
        f"{wall_untraced:.3f} s untraced; kernels busy {busy:.6f} s "
        f"({len(kernels)} records); records {json.dumps(records)}")
    return dict(
        ops=k, busy_s=busy, window_s=wall_traced,
        wall_untraced_s=wall_untraced, work=work, records=records,
        kernel_ns={n: v[0] for n, v in sums.items()},
        kernel_count={n: v[1] for n, v in sums.items()},
        breakdown=dict(
            device_ops=[[n, v[0] / 1e9] for n, v in top[:10]],
            idle_gaps=[[n, s / 1e9] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:10]]))


def check_lines(checks: Dict[str, dict]) -> List[str]:
    return [f"check {n}: {c['value']} (limit {c['limit']})"
            for n, c in checks.items()]
