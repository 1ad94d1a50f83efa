"""ratematch.dematch_ms (ms): the median host time of a
``ratematch.dematch`` call (one aggregation level's candidates; four a
decode call) in the blind-decoding cell's span window, from the call to
its return, no synchronise."""

from bench_port import spans


def read(rec):
    w = rec.get("span_window")
    calls = w and w["per_call"].get("ratematch.dematch")
    return spans.median_ms(calls["total"]) if calls else None
