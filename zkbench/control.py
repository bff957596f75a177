"""The control of a cell: its window at the cell's own size, judged twice,
once with the program's answers and once with the control's answers in
their place (the reference with one stated guarantee broken: see each
operation's docstring).  A sound comparison passes the first and fails the
second on every seed.

    python3 zkbench/control.py --workload <cell> --seconds <s> --seeds 1 2 3

Prints one JSON line per seed: the program's and the control's numbers.
Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    from zkbench import harness

    for seed in a.seeds:
        res = harness.run_cell(ROOT, a.workload, seed, a.seconds, False,
                               "cuda", time.perf_counter(),
                               with_control=True)
        print(json.dumps(dict(workload=a.workload, seed=seed,
                              attempted=res["attempted"],
                              correct=res["correct"],
                              program=res["checks"],
                              control=res["control_checks"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
