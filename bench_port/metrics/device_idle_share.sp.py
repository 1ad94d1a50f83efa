"""device_idle_share.sp (share): 1 - the summed self device time of the
traced window's kernels and copies / the window's wall time
(``profiling.trace_window``; on several ranks the largest)."""


def read(rec):
    trace = rec.get("trace")
    return None if trace is None else trace["idle_share"]
