"""push_p95_ms (ms): the 95th percentile (linear interpolation) of every
``StreamingDecoder.push`` latency in the window, each from the call until
its bits are on the host."""

import numpy as np


def read(rec):
    lat = rec.get("push_latency_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
