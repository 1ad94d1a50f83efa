"""sp.host_read_ms (ms): the host time a ``decode_stream_sp`` call spends
in its read of the tile-shape all-reduce (``host_read.sp.tile_shape``),
median over the span window's back-to-back calls, the largest over the
ranks (``spans.span_window``)."""

from bench_port import spans

SITE = "host_read.sp.tile_shape"


def read(rec):
    windows = spans.of(rec)
    if not windows:
        return None
    worst = []
    for w in windows:
        calls = w["per_call"].get("sp.decode_stream_sp")
        if not calls or SITE not in calls["self"]:
            return None
        worst.append(spans.median_ms(calls["self"][SITE]))
    return max(worst)
