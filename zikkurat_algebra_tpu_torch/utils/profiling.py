"""Tracing and timing helpers (the torch counterpart of
zikkurat_algebra_tpu/utils/profiling.py).

* `span(name, like)` - a stage span of the port, a context manager.  Off
  (the default) a span site costs one check of two module-level flags
  and nothing else.  While a `torch.profiler` records, it opens the
  range `zk.<name>` on the profiler's clock.  While `recording()` is on
  (or a `stage_seconds` dict was handed to the MSM), it keeps a
  `SpanRecord`: name, parent, operation id (the outermost span), host
  interval by `time.perf_counter_ns`, device interval by a pair of CUDA
  events on the current stream of `like`'s device (never waited on
  inside the call; on the CPU the host interval), and the change in the
  kernels' launch counters (`LAUNCHES`).  A record taken under a
  profiler goes to no registry (the profiler slows the host).
* `recording()`  - the operator's switch for the registry.
* `totals()`     - calls, host seconds, device seconds and launches per
  span name, after resolving the pending events (one wait);
  `records()` the last `MAX_RECORDS` records; `reset()`.
* `stages(out, names)` - records the body and adds each named span's
  device seconds to `out` (the MSM's `stage_seconds`), with one wait at
  the end.
* `trace(path)`  - a `torch.profiler` window over the host and, where a
  card is present, its kernels; writes a Chrome trace (Perfetto,
  chrome://tracing) to `path`/trace.json.
* `timed(fn)`    - wall time of a call with an honest completion barrier
  (`force`: torch returns before the card has finished).
* `Counters`     - named counts and seconds, rates per second; the
  registry's totals live in the module's one instance.

Spans assume one host thread issues the port's work.
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional

import torch
import torch.autograd.profiler as _ap

TRACE_FILE = "trace.json"
# the port's exact launch counters (`<kernel wrapper>.launches`)
LAUNCHES = ("mont_mul", "bucket_scan", "sort_key_val", "ntt_stages",
            "bucket_scan2", "point_add", "point_dbl")
MAX_RECORDS = 1 << 16       # records kept for `records()`
MAX_PENDING = 1 << 12       # unresolved CUDA spans before a sweep


@contextlib.contextmanager
def trace(path: Optional[str] = None):
    """Profile the body; yields the `torch.profiler.profile` object (its
    `key_averages()` sums time by operation and kernel) and, after the
    body, writes its Chrome trace to `path`/trace.json (default: a
    directory under the system's temporary directory).  The port's spans
    appear in it as `zk.<name>` ranges."""
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
    """ops/s accounting: record named op counts and elapsed time, and for
    spans their device seconds and kernel launches."""

    counts: Dict[str, int] = field(default_factory=dict)
    seconds: Dict[str, float] = field(default_factory=dict)
    device_seconds: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, Dict[str, int]] = field(default_factory=dict)

    def add(self, name: str, n_ops: int, secs: float,
            device_secs: Optional[float] = None,
            launches: Optional[Mapping[str, int]] = None) -> None:
        self.counts[name] = self.counts.get(name, 0) + n_ops
        self.seconds[name] = self.seconds.get(name, 0.0) + secs
        if device_secs is not None:
            self.device_seconds[name] = (self.device_seconds.get(name, 0.0)
                                         + device_secs)
        if launches is not None:
            acc = self.launches.setdefault(name, {})
            for k, v in launches.items():
                acc[k] = acc.get(k, 0) + v

    def rate(self, name: str) -> float:
        s = self.seconds.get(name, 0.0)
        return self.counts.get(name, 0) / s if s else 0.0

    def report(self) -> Dict[str, float]:
        return {k: self.rate(k) for k in self.counts}

    def clear(self) -> None:
        for d in (self.counts, self.seconds, self.device_seconds,
                  self.launches):
            d.clear()


# -- spans ---------------------------------------------------------------

class SpanRecord:
    """One span as recorded: `parent` is the enclosing span's name (None
    for an operation's outermost span), `op` the operation's id, `t0` and
    `t1` host nanoseconds, `device_s` the device interval once resolved,
    `launches` the kernel launches inside, by `LAUNCHES` name."""

    __slots__ = ("name", "parent", "op", "t0", "t1", "stream", "ev0", "ev1",
                 "counts0", "launches", "device_s", "kept")

    @property
    def host_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def resolve(self) -> float:
        """The device interval in seconds; the end event must be done."""
        if self.device_s is None:
            self.device_s = self.ev0.elapsed_time(self.ev1) * 1e-3
            self.ev0 = self.ev1 = None
        return self.device_s

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, parent={self.parent!r}, "
                f"op={self.op}, host_s={self.host_s:.6f}, "
                f"device_s={self.device_s})")


_recording = 0              # depth of recording() and stages() contexts
_open: List[SpanRecord] = []
_sink: Optional[List[SpanRecord]] = None     # the innermost stages()
_last_op = 0
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_pending: List[SpanRecord] = []
_totals = Counters()
_counters: Optional[tuple] = None
_NULL = contextlib.nullcontext()


def _launch_counts() -> tuple:
    global _counters
    if _counters is None:
        from ..ops import (kernel_curve, kernel_field, kernel_ntt,
                           kernel_point, kernel_sort)

        _counters = (kernel_field.mont_mul, kernel_curve.bucket_scan,
                     kernel_sort.sort_key_val, kernel_ntt.ntt_stages,
                     kernel_curve.bucket_scan2, kernel_point.point_add,
                     kernel_point.point_dbl)
    return tuple(k.launches for k in _counters)


def _add_total(r: SpanRecord) -> None:
    _totals.add(r.name, 1, r.host_s, r.device_s,
                dict(zip(LAUNCHES, r.launches)))


def _wait_last(recs: List[SpanRecord]) -> None:
    """Wait for the newest unresolved end event of `recs`: the earlier
    events of its stream are then done too."""
    live = [r for r in recs if r.ev1 is not None]
    if live:
        live[-1].ev1.synchronize()


def _sweep(wait: bool) -> None:
    """Resolve the pending CUDA spans whose end event is done, after one
    wait if `wait`."""
    global _pending
    if wait:
        _wait_last(_pending)
    left = []
    for r in _pending:
        if r.ev1 is None or r.ev1.query():
            r.resolve()
            _add_total(r)
        else:
            left.append(r)
    _pending = left


def _begin(name: str, like, profiled: bool) -> SpanRecord:
    global _last_op
    r = SpanRecord()
    r.name, r.kept, r.device_s = name, not profiled, None
    if _open:
        up = _open[-1]
        r.parent, r.op, r.stream = up.name, up.op, up.stream
    else:
        _last_op += 1
        r.parent, r.op, r.stream = None, _last_op, None
    dev = getattr(like, "device", like)
    if dev is not None:
        dev = torch.device(dev)
        r.stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                    else None)
    r.ev0 = r.ev1 = None
    if r.stream is not None:
        r.ev0 = torch.cuda.Event(enable_timing=True)
        r.ev1 = torch.cuda.Event(enable_timing=True)
        r.ev0.record(r.stream)
    r.counts0 = _launch_counts()
    _open.append(r)
    r.t0 = time.perf_counter_ns()
    return r


def _end(r: SpanRecord) -> None:
    r.t1 = time.perf_counter_ns()
    _open.pop()
    if r.ev1 is not None:
        r.ev1.record(r.stream)
    r.launches = tuple(b - a for a, b in zip(r.counts0, _launch_counts()))
    if _sink is not None:
        _sink.append(r)
    if r.ev1 is None:
        r.device_s = r.host_s
    if not r.kept:
        return
    _records.append(r)
    if r.ev1 is None:
        _add_total(r)
    else:
        _pending.append(r)
        if len(_pending) > MAX_PENDING:
            _sweep(wait=False)


class _Span:
    __slots__ = ("name", "like", "rf", "rec")

    def __init__(self, name: str, like):
        self.name, self.like = name, like
        self.rf = self.rec = None

    def __enter__(self) -> Optional[SpanRecord]:
        profiled = _ap._is_profiler_enabled
        if profiled:
            self.rf = _ap.record_function("zk." + self.name)
            self.rf.__enter__()
        if _recording:
            self.rec = _begin(self.name, self.like, profiled)
        return self.rec

    def __exit__(self, *exc) -> bool:
        if self.rec is not None:
            _end(self.rec)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, like=None):
    """A stage span around the body.  `like` is a tensor or a device
    whose current stream times the span (None: the enclosing span's
    stream, or the host clock)."""
    if _recording or _ap._is_profiler_enabled:
        return _Span(name, like)
    return _NULL


@contextlib.contextmanager
def recording():
    """Record every span of the body in the registry."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def stages(out: Optional[Dict[str, float]], names: Mapping[str, str]):
    """With `out` None, nothing.  Else the body runs under recording, and
    after it each span named in `names` adds its device seconds to
    out[names[span]]: one wait, at the end, for the last event."""
    if out is None:
        return _NULL
    return _stages(out, names)


@contextlib.contextmanager
def _stages(out: Dict[str, float], names: Mapping[str, str]):
    global _recording, _sink
    outer, mine = _sink, []
    _sink = mine
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1
        _sink = outer
        if outer is not None:
            outer.extend(mine)
    _wait_last(mine)
    for r in mine:
        if r.name in names:
            key = names[r.name]
            out[key] = out.get(key, 0.0) + r.resolve()


def totals() -> Dict[str, dict]:
    """{span name: {calls, host_s, device_s, launches}} over every span
    recorded since `reset()`; waits once for pending device events."""
    _sweep(wait=True)
    t = _totals
    return {n: dict(calls=t.counts[n], host_s=t.seconds[n],
                    device_s=t.device_seconds.get(n, 0.0),
                    launches=dict(t.launches.get(n, {})))
            for n in t.counts}


def records() -> List[SpanRecord]:
    """The last `MAX_RECORDS` records, oldest first (device intervals of
    CUDA spans filled in by `totals()`)."""
    return list(_records)


def reset() -> None:
    """Forget every record and total."""
    global _last_op, _pending
    _records.clear()
    _pending = []
    _totals.clear()
    _last_op = 0
