"""push.graph_share (share): the span window's pushes that replayed a
captured CUDA graph over all its pushes, from the program's counters
``streaming.graph_replays`` and ``streaming.eager_pushes`` (each
counter's increase over the window, ``spans.span_window``).  A program
without those counters gives nothing to read."""

from bench_port import spans


def read(rec):
    windows = spans.of(rec)
    if not windows:
        return None
    counts = windows[0]["counters"]
    replays = counts.get("streaming.graph_replays", 0)
    pushes = replays + counts.get("streaming.eager_pushes", 0)
    return replays / pushes if pushes else None
