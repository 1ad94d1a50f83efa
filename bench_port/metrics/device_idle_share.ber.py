"""device_idle_share.ber (share): 1 - the summed self device time of the
traced window's kernels and copies / the window's wall time
(``profiling.trace_window``), in the BER-point cell."""


def read(rec):
    trace = rec.get("trace")
    return None if trace is None else trace["idle_share"]
