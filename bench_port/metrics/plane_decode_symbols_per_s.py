"""plane_decode_symbols_per_s (symbols/s): decode_symbols_per_s in the
cells whose decode the device bounds (the plane route), so that host
noise elsewhere does not widen their bound: channel symbols of every
``ViterbiDecoder.decode`` call completed in the window, B x (data bits +
K - 1) x R a call, over the window's seconds (closed by a device
synchronise)."""


def read(rec):
    if "symbols" not in rec:
        return None
    return rec["symbols"] / rec["window_s"]
