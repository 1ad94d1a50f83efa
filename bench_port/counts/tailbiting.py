"""The least time of the blind-decoding cell's kernel calls, from
``bounds.py``'s frozen arithmetic at each call shape of a circular
decode: the ACS over the frame's three copies (T = 3L) and the walk from
row 3L down to row L + K - 1, the oldest it reads (2L - K + 1 rows, one
rotation and one bit out a row)."""

from __future__ import annotations

from bench_port.counts import bounds

__all__ = ["mean_bound_ms"]


def _calls(n: int, k: int, i: int) -> int:
    """Calls of size i among the first n, the k sizes taken in turn."""
    return n // k + (i < n % k)


def mean_bound_ms(rec: dict, kernel: str):
    """The mean least time of one ``kernel`` ("acs" or "walk") call over
    the traced window's calls, or None without a trace."""
    trace, shapes = rec.get("trace"), rec.get("shapes")
    if trace is None or not shapes or not trace.get("calls"):
        return None
    n, total = trace["calls"], 0.0
    for i, s in enumerate(shapes):
        if kernel == "acs":
            ms, _ = bounds.acs_bound(s["S"], s["B"], s["T"], s["R"], s["W"])
        else:
            rows = s["T"] - s["data_bits"] - s["K"] + 1
            ms, _ = bounds.walk_bound(rows, s["B"], rows, 1)
        total += _calls(n, len(shapes), i) * ms
    return total / n
