"""Where the port's time goes by its own spans, on one NVIDIA card.

    python3 scripts/torch_spans.py trace [--seed N] [--msms 3] [--products 20]
    python3 scripts/torch_spans.py cost --workload CELL --seed N --seconds S --recording 0|1

`trace` sets up the benchmark's three cells (`prover2p20-g1msm`: a
2^20 G1 MSM; `prover2p20-polymul`: a product of two 2^19-coefficient
polynomials; `blob4096-prove`: commitments and proofs of 6 blobs),
warms them up, and then
- runs `--msms` MSMs, `--products` products and `BLOB_OPS` blob
  operations under `profiling.recording()`: per span name, the calls,
  the host time and the device interval (CUDA events) per call, and the
  launches; the counters of `profiling.counts()`;
- runs one MSM, `--products` products and one blob operation under
  `profiling.trace`: the device's busy time, the kernels by summed
  device time, and every idle gap of the device charged to the
  innermost `zk.` span the host had open at the gap's middle ("other"
  where none was).
`cost` runs one cell's window as the benchmark does (`zkbench/run.py
--trace 0`), with `profiling.recording()` around the whole run or not,
and prints the result object: the cost of recording when it is on.

Each prints one JSON object on its last line, after the card's name and
power limit.  It needs a CUDA card and the checkout's `zkbench/`.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


BLOB_OPS = 4            # blob operations of 6 blobs under recording()


def log(s: str) -> None:
    print(s, file=sys.stderr, flush=True)


def setup(cell: str, seed: int, dev):
    from zkbench import harness

    c = harness.load_cell(ROOT, cell)
    drv = harness.load_operation(ROOT, c.mix["op"]).Operation(
        root=ROOT, config=c.config, mix=c.mix, seed=seed, device=dev)
    drv.setup()
    return drv


def span_table(totals: dict) -> dict:
    return {n: dict(calls=t["calls"],
                    host_ms=1e3 * t["host_s"] / t["calls"],
                    device_ms=1e3 * t["device_s"] / t["calls"],
                    launches={k: v for k, v in t["launches"].items() if v})
            for n, t in sorted(totals.items())}


def trace(a) -> dict:
    import torch

    from zikkurat_algebra_tpu_torch.utils import profiling
    from zkbench import counts

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    msm = setup("prover2p20-g1msm", a.seed, dev)
    poly = setup("prover2p20-polymul", a.seed, dev)
    blob = setup("blob4096-prove", a.seed, dev)
    k = [msm.inputs(j) for j in range(a.msms)]
    jk = [poly.inputs(j) for j in range(a.products)]
    bk = [blob.inputs(j) for j in range(BLOB_OPS)]
    msm.run(k[0], None)
    for x in jk[:3]:
        poly.run(x, None)
    blob.run(bk[0], None)
    torch.cuda.synchronize()
    out = {}

    for name, drv, args in (("msm", msm, k), ("polymul", poly, jk),
                            ("blob", blob, bk)):
        profiling.reset()
        wall = []
        for x in args:
            torch.cuda.synchronize()
            t = time.perf_counter()
            with profiling.recording():
                drv.run(x, None)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t)
        out[f"{name}_spans"] = dict(
            wall_ms=[1e3 * w for w in wall],
            spans=span_table(profiling.totals()),
            counts=profiling.counts())
        profiling.reset()

    for name, drv, args in (("msm", msm, k[:1]), ("polymul", poly, jk),
                            ("blob", blob, bk[:1])):
        torch.cuda.synchronize()
        with profiling.trace(a.trace_dir) as prof:
            t = time.perf_counter()
            for x in args:
                drv.run(x, None)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
        kernels, spans = [], []
        for e in prof.profiler.kineto_results.events():
            nm = e.name()
            on_card = e.device_type() == torch.autograd.DeviceType.CUDA
            if nm.startswith("zk.") and not on_card:
                spans.append((nm, e.start_ns(), e.duration_ns()))
            elif on_card and not e.is_user_annotation() \
                    and e.duration_ns() > 0:
                kernels.append((nm, e.start_ns(), e.duration_ns()))
        del prof
        t0 = min(s for _, s, _ in spans + kernels)
        t1 = max(s + d for _, s, d in spans + kernels)
        busy = counts.busy_ns(kernels)
        idle = counts.idle_by_label(kernels, spans, t0, t1)
        top = sorted(counts.by_name(kernels).items(), key=lambda kv: -kv[1][0])
        out[f"{name}_trace"] = dict(
            ops=len(args), wall_traced_s=wall, window_s=(t1 - t0) / 1e9,
            busy_s=busy / 1e9, records=len(kernels), spans=len(spans),
            idle_s={n: v / 1e9 for n, v in sorted(
                idle.items(), key=lambda kv: -kv[1])},
            kernels_s=[[n, v[0] / 1e9, v[1]] for n, v in top[:12]])
    return out


def cost(a) -> dict:
    from zikkurat_algebra_tpu_torch.utils import profiling
    from zkbench import harness

    ctx = profiling.recording() if a.recording else contextlib.nullcontext()
    with ctx:
        res = harness.run_cell(ROOT, a.workload, a.seed, a.seconds, False,
                               "cuda", T_START, log=log)
    spans = span_table(profiling.totals()) if a.recording else {}
    return dict(workload=a.workload, seed=a.seed, recording=a.recording,
                correct=res["correct"], attempted=res["attempted"],
                metrics={n: m["value"] for n, m in res["metrics"].items()},
                spans=spans)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    t = sub.add_parser("trace")
    t.add_argument("--seed", type=int, default=2**33 + 7)
    t.add_argument("--msms", type=int, default=3)
    t.add_argument("--products", type=int, default=20)
    t.add_argument("--trace-dir", default=None)
    c = sub.add_parser("cost")
    c.add_argument("--workload", required=True)
    c.add_argument("--seed", type=int, required=True)
    c.add_argument("--seconds", type=float, required=True)
    c.add_argument("--recording", type=int, choices=(0, 1), required=True)
    a = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: torch.cuda.is_available() is False")
        return 2
    torch.set_num_threads(1)
    from zkbench import harness

    log(f"# card: {harness.power_limit()}")
    out = trace(a) if a.mode == "trace" else cost(a)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
