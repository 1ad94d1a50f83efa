"""ops.launch_ms.pdcch (ms): the median, over the blind-decoding cell's
span window's ``ViterbiDecoder.decode_tailbiting`` calls, of the summed
host time of a call's ``ops.*`` spans: the kernel wrappers' checks,
allocations, ctypes marshalling and launches."""

from bench_port import spans


def read(rec):
    w = rec.get("span_window")
    calls = w and w["per_call"].get("decoder.tailbiting")
    if not calls:
        return None
    ops = [v for k, v in calls["self"].items() if k.startswith("ops.")]
    return spans.median_ms([sum(c) for c in zip(*ops)]) if ops else None
