"""decoder.chainback.self_ms (ms): the median, over the span window's
``ViterbiDecoder.decode`` calls, of the host time inside
``decoder.chainback`` outside its ``ops.*`` span (the start states), no
synchronise (``spans.span_window``)."""

from bench_port import spans


def read(rec):
    windows = spans.of(rec)
    calls = windows and windows[0]["per_call"].get("decoder.decode")
    return spans.median_ms(calls["self"].get("decoder.chainback")) if calls \
        else None
