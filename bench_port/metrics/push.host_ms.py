"""push.host_ms (ms): the median host time of ``StreamingDecoder.push``
(its ``streaming.push`` span) in the span window, from the call to its
return, no synchronise (``spans.span_window``)."""

from bench_port import spans


def read(rec):
    windows = spans.of(rec)
    calls = windows and windows[0]["per_call"].get("streaming.push")
    return spans.median_ms(calls["total"]) if calls else None
