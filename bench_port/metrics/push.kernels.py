"""push.kernels (count): device kernels and copies a push, the traced
window's device operations over its pushes (a pass's reset included)."""


def read(rec):
    trace = rec.get("trace")
    if trace is None or not trace.get("calls"):
        return None
    return trace["device_events"] / trace["calls"]
