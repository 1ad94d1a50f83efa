"""device_idle_share.pdcch (share): 1 - the summed self device time of the
traced window's kernels and copies / the window's wall time
(``profiling.trace_window``), in the blind-decoding cell."""


def read(rec):
    trace = rec.get("trace")
    return None if trace is None else trace["idle_share"]
