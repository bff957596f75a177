"""The port's span registry (`utils/profiling.py`) as the metric readers
read it."""

from __future__ import annotations

from typing import Optional


def span_per_op(span: str, field: str, per: str) -> Optional[float]:
    """1e3 times the registry's `field` ("host_s" or "device_s") of `span`
    over the calls of the span `per`: ms per call of `per`.  None where
    the port has no registry, or it holds no call of either span."""
    try:
        from zikkurat_algebra_tpu_torch.utils import profiling
    except ImportError:
        return None
    totals = getattr(profiling, "totals", None)
    if totals is None:
        return None
    t = totals()
    calls = t.get(per, {}).get("calls", 0)
    if not calls or span not in t:
        return None
    return 1e3 * t[span][field] / calls
