"""Tracing and timing helpers (the torch counterpart of
zikkurat_algebra_tpu/utils/profiling.py).

* `trace(path)`  - a `torch.profiler` window over the host and, where a
  card is present, its kernels; writes a Chrome trace (Perfetto,
  chrome://tracing) to `path`/trace.json.
* `timed(fn)`    - wall time of a call with an honest completion barrier
  (`force`: torch returns before the card has finished).
* `Counters`     - named operation counts and seconds, rates per second.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(path: Optional[str] = None):
    """Profile the body; yields the `torch.profiler.profile` object (its
    `key_averages()` sums time by operation and kernel) and, after the
    body, writes its Chrome trace to `path`/trace.json (default: a
    directory under the system's temporary directory)."""
    from torch.profiler import ProfilerActivity, profile

    if path is None:
        path = os.path.join(tempfile.gettempdir(), "zikkurat_torch_trace")
    os.makedirs(path, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(path, TRACE_FILE))


def force(result) -> None:
    """Completion barrier: synchronise the card of every tensor in a
    (nested) tuple, list or dict."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, (tuple, list)):
        for x in result:
            force(x)
    elif isinstance(result, dict):
        for x in result.values():
            force(x)


def timed(fn: Callable, *args, iters: int = 3, warmup: int = 1):
    """Returns (seconds_per_call, last_result)."""
    r = None
    for _ in range(warmup):
        r = fn(*args)
        force(r)
    t0 = time.perf_counter()
    for _ in range(iters):
        r = fn(*args)
        force(r)
    return (time.perf_counter() - t0) / iters, r


@dataclass
class Counters:
    """ops/s accounting: record named op counts and elapsed time."""

    counts: Dict[str, int] = field(default_factory=dict)
    seconds: Dict[str, float] = field(default_factory=dict)

    def add(self, name: str, n_ops: int, secs: float) -> None:
        self.counts[name] = self.counts.get(name, 0) + n_ops
        self.seconds[name] = self.seconds.get(name, 0.0) + secs

    def rate(self, name: str) -> float:
        s = self.seconds.get(name, 0.0)
        return self.counts.get(name, 0) / s if s else 0.0

    def report(self) -> Dict[str, float]:
        return {k: self.rate(k) for k in self.counts}
