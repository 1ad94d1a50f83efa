"""decoder.tailbiting.self_ms (ms): the median, over the span window's
``ViterbiDecoder.decode_tailbiting`` calls, of the host time inside its
``decoder.tailbiting`` span outside its ``decoder.update`` and
``decoder.chainback`` children (the equal-metric seed, the buffers, the
three copies of the symbols, the best states), no synchronise."""

from bench_port import spans


def read(rec):
    w = rec.get("span_window")
    calls = w and w["per_call"].get("decoder.tailbiting")
    return spans.median_ms(calls["self"].get("decoder.tailbiting")) \
        if calls else None
