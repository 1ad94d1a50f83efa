"""ops.launch_ms (ms): the median, over the span window's
``ViterbiDecoder.decode`` calls, of the summed host time of a call's
``ops.*`` spans: the kernel wrappers' checks, allocations, ctypes
marshalling and launches (``spans.span_window``)."""

from bench_port import spans


def read(rec):
    windows = spans.of(rec)
    calls = windows and windows[0]["per_call"].get("decoder.decode")
    if not calls:
        return None
    ops = [v for k, v in calls["self"].items() if k.startswith("ops.")]
    return spans.median_ms([sum(c) for c in zip(*ops)]) if ops else None
