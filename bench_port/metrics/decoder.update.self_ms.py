"""decoder.update.self_ms (ms): the median, over the span window's
``ViterbiDecoder.decode`` calls, of the host time inside
``decoder.update`` outside its ``ops.*`` span (the input clamp and cast,
the row rotations), no synchronise (``spans.span_window``)."""

from bench_port import spans


def read(rec):
    windows = spans.of(rec)
    calls = windows and windows[0]["per_call"].get("decoder.decode")
    return spans.median_ms(calls["self"].get("decoder.update")) if calls \
        else None
