"""Shared arithmetic of the metric readers (`metrics/<name>.py`).  A reader
takes the run's `harness.Record` and returns a number, or None where the
run has nothing for it to read."""

from __future__ import annotations

from typing import Optional

from . import counts


def rate(rec) -> Optional[float]:
    """Work units completed per second: all units of the window's whole
    operations over the summed time of those operations."""
    t = sum(rec.op_s)
    return sum(rec.units) / t if t > 0 else None


def percentile_ms(rec, q: float) -> Optional[float]:
    """The q-th percentile of the window's operation times, in ms (linear
    between the two nearest ranks)."""
    xs = sorted(rec.op_s)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return 1e3 * (xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


def stage_ms(rec, *stages: str) -> Optional[float]:
    """Mean per operation of the port's MSM stage times (stage_seconds)."""
    if not rec.op_s or not all(s in rec.stages for s in stages):
        return None
    return 1e3 * sum(rec.stages[s] for s in stages) / len(rec.op_s)


def idle_pct(rec) -> Optional[float]:
    """100 (1 - kernel busy time in the traced ops / the untraced wall
    time of the same ops)."""
    p = rec.prof
    if not p or p["busy_s"] <= 0 or p["wall_untraced_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_untraced_s"])


def kernel_ns_per_op(rec, kernel: str) -> Optional[float]:
    p = rec.prof
    if not p:
        return None
    ns = sum(v for n, v in p["kernel_ns"].items() if kernel in n)
    return ns / p["ops"] if ns > 0 else None


def roofline_pct(rec, work_key: str, kernel: str) -> Optional[float]:
    """100 (the bound of the work the operation counted for one op / the
    kernel's device time per op in the trace)."""
    p = rec.prof
    dev_ns = kernel_ns_per_op(rec, kernel)
    if dev_ns is None or work_key not in p["work"]:
        return None
    nbytes, nops = p["work"][work_key]
    b_s, _ = counts.bound_s(nbytes, nops, rec.card)
    return 100.0 * b_s * 1e9 / dev_ns
