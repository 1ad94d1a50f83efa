"""decoder.update.self_ms.pdcch (ms): the median, over the blind-decoding
cell's span window's ``ViterbiDecoder.decode_tailbiting`` calls, of the
host time inside ``decoder.update`` outside its ``ops.*`` span (the
input clamp and cast of the (B, 9L) copies, the row rotations), no
synchronise."""

from bench_port import spans


def read(rec):
    w = rec.get("span_window")
    calls = w and w["per_call"].get("decoder.tailbiting")
    return spans.median_ms(calls["self"].get("decoder.update")) if calls \
        else None
