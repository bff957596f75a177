"""What every operation module (`ops/<op>.py`, class `Operation`) offers the
harness.

- `setup()`: the inputs that live for the whole run (on the device);
- `inputs(i)`: the inputs of operation i, a function of (seed, i);
- `run(args, tracer)`: the timed operation; `tracer` is None, or in the
  traced run a dict whose "stages" the operation may hand to the port;
- `units(args)`: the work of one operation (points, proofs, ...);
- `keep(i, args, out)`: hold what the judgement needs of operation i;
- `release()`: free the program's state before the reference runs;
- `judge()`: the checks, each {"name", "value", "limit"};
- `control()`: the same checks with the control's answers in the
  program's place (zkbench/control.py);
- `kernel_work(args)`: {kernel: (bytes, multiply-adds)} for the bounds.

SPANS are timed in the traced window ('module:qualname' -> span),
LABELS name the host's activity in the profiler's window, KERNELS map a
launch counter of the port to its kernel's name, NEED_RECORDS the
counters whose records a metric reads.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

PORT = "zikkurat_algebra_tpu_torch"
KERNELS = {"mont_mul": "mont_mul_kernel",
           "bucket_scan": "bucket_scan_kernel",
           "ntt_stages": "ntt_pass_kernel"}


def port_counters() -> Dict[str, callable]:
    """The port's exact launch counters of kernels K1, K2, K3, K5."""
    from zikkurat_algebra_tpu_torch.ops import (
        kernel_curve, kernel_field, kernel_ntt, kernel_sort)

    return {"mont_mul": lambda: kernel_field.mont_mul.launches,
            "bucket_scan": lambda: kernel_curve.bucket_scan.launches,
            "sort_key_val": lambda: kernel_sort.sort_key_val.launches,
            "ntt_stages": lambda: kernel_ntt.ntt_stages.launches}


class OperationBase:
    SPANS: Dict[str, str] = {}
    LABELS: Dict[str, str] = {}
    KERNELS = KERNELS
    NEED_RECORDS: tuple = ()

    def __init__(self, root: Path, config: dict, mix: dict, seed: int,
                 device):
        self.root = Path(root)
        self.config = config
        self.mix = mix
        self.seed = seed
        self.device = device
        self.kept: List[tuple] = []

    def counters(self):
        return port_counters()

    def units(self, args) -> float:
        return 1.0

    def keep(self, i: int, args, out) -> None:
        self.kept.append((i, out))

    def kernel_work(self, args) -> dict:
        return {}

    STATE: tuple = ()       # attributes that hold the program's state

    def release(self) -> None:
        import torch

        for k in self.STATE:
            setattr(self, k, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self) -> List[dict]:
        return self.compare(self.answers())

    def control(self) -> List[dict]:
        return self.compare(self.control_answers())
