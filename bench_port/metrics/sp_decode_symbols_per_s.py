"""sp_decode_symbols_per_s (symbols/s): channel symbols of every
``block_sp.decode_stream_sp`` call completed in the window, the whole
stream's B x (data bits + K - 1) x R a call, counted on rank 0, over its
window's seconds."""


def read(rec):
    if "symbols" not in rec:
        return None
    return rec["symbols"] / rec["window_s"]
