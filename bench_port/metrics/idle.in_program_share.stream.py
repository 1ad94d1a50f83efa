"""idle.in_program_share.stream (share): the span window's device idle
seconds (between consecutive counted operations) during which the host
was inside a span of the program, over all of its idle seconds (the rest
is ``caller``: the benchmark's loop) (``spans.span_window``)."""

from bench_port import spans


def read(rec):
    windows = spans.of(rec)
    if not windows or not all(w["idle_s"] > 0 for w in windows):
        return None
    return max(w["idle_in_program_s"] / w["idle_s"] for w in windows)
