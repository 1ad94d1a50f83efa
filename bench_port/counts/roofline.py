"""A kernel's share of its roofline in a traced window: the calls the
profiler saw times the least time a call could take (``bounds.py``),
over the kernel's summed self device time, in percent."""

from __future__ import annotations

import re
from typing import Optional

__all__ = ["share"]


def share(rec: dict, pattern: str, bound_ms: float) -> Optional[float]:
    """``pattern`` matches the profiler's names of the kernel; None where
    the trace holds no such kernel."""
    trace = rec.get("trace")
    if trace is None:
        return None
    rx = re.compile(pattern)
    hits = [v for k, v in trace["kernels"].items() if rx.search(k)]
    calls = sum(c for c, _ in hits)
    seconds = sum(s for _, s in hits)
    if not calls or seconds <= 0:
        return None
    return 100.0 * calls * bound_ms / 1e3 / seconds
