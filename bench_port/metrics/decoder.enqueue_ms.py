"""decoder.enqueue_ms (ms): the median host time from a
``ViterbiDecoder.decode`` call to its return, with no synchronise: the
benchmark's own span around each call of the window."""

import statistics


def read(rec):
    spans = rec.get("enqueue_s")
    if not spans:
        return None
    return statistics.median(spans) * 1e3
