"""sp.exchange_ms (ms): ``decode_stream_sp``'s own ``timings["exchange"]``
a call (CUDA events, the device synchronised at each span's ends), the
largest over the ranks, median over the calls timed."""

import statistics


def read(rec):
    per_rank = rec.get("sp_timings")
    if not per_rank or not per_rank[0]:
        return None
    worst = (max(t["exchange"] for t in call) for call in zip(*per_rank))
    return statistics.median(worst) * 1e3
