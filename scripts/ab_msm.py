"""A/B of the 2^20 BLS12-381 MSM between two checkouts on one NVIDIA card.

    python3 scripts/ab_msm.py A_DIR B_DIR [--pairs 10] [--grp g1]

Each side runs in a process of its own that imports
zikkurat_algebra_tpu_torch from its checkout, tiles the committed seeds
to 2^20 points, draws the same scalars (numpy seed 20), makes one
warm-up `msm_std` call (block 512) and times three more on the host
clock, the device synchronised after each.  The pairs alternate which
side runs first.  The script prints each run's mean ms per call, then
the medians, the quartiles of each side and the pairs each side won
(host-clock times spread widely, so a gain needs most pairs, not one);
the last line is a JSON object with every number, the line before it
the card's name and power limit.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

CHILD = r"""
import sys, time
import numpy as np, torch
sys.path.insert(0, {root!r})
from zikkurat_algebra_tpu_torch import params as P
from zikkurat_algebra_tpu_torch.ops.curve import CurveKernels
from zikkurat_algebra_tpu_torch.utils.convert import load_jax_seed_points
grp, n = {grp!r}, 1 << 20
ck = CurveKernels(P.BLS12_381, "cuda")
seeds = load_jax_seed_points({seeds!r}, ck.fp)
pts = tuple(s.repeat(*([1] * (s.ndim - 1)), -(-n // s.shape[-1]))[..., :n]
            .contiguous() for s in seeds)
rng = np.random.default_rng(20)
k = rng.integers(0, 1 << 32, (ck.fr.W, n), dtype=np.uint64)
k[-1] = rng.integers(0, ck.fr.p >> (32 * (ck.fr.W - 1)), n, dtype=np.uint64)
k = torch.from_numpy(k.astype(np.uint32).view(np.int32)).cuda()
msm = ck.msm(grp)
msm.msm_std(k, pts, None, 512)
torch.cuda.synchronize()
ts = []
for _ in range(3):
    t = time.perf_counter()
    msm.msm_std(k, pts, None, 512)
    torch.cuda.synchronize()
    ts.append((time.perf_counter() - t) * 1e3)
print(sum(ts) / len(ts))
"""


def run_side(root: str, grp: str) -> float:
    root = os.path.abspath(root)
    seeds = os.path.join(root, "bench_data", f"seeds_BLS12_381_{grp}.npz")
    code = CHILD.format(root=root, grp=grp, seeds=seeds)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: exit {out.returncode}\n{out.stderr}")
    return float(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--grp", default="g1", choices=("g1", "g2"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_msm: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    runs = {"a": [], "b": []}
    for i in range(args.pairs):
        order = ("a", "b") if i % 2 == 0 else ("b", "a")
        for side in order:
            ms = run_side(getattr(args, side), args.grp)
            runs[side].append(ms)
            print(f"# pair {i} {side}: {ms:.1f} ms per msm_std", flush=True)
    a, b = np.array(runs["a"]), np.array(runs["b"])
    summary = dict(
        grp=args.grp, a=args.a, b=args.b, runs=runs,
        median_a=float(np.median(a)), median_b=float(np.median(b)),
        quartiles_a=[float(q) for q in np.percentile(a, [25, 75])],
        quartiles_b=[float(q) for q in np.percentile(b, [25, 75])],
        b_faster_pairs=int((b < a).sum()), a_faster_pairs=int((a < b).sum()))
    print(f"# medians: a {summary['median_a']:.1f} ms, b "
          f"{summary['median_b']:.1f} ms; b faster in "
          f"{summary['b_faster_pairs']} of {args.pairs} pairs")
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
