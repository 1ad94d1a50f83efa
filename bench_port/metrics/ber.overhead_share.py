"""ber.overhead_share (share): 1 - the self device time of the decode's
kernels (the rotated ACS and the slot-order walk, either design) / the
traced window's wall time: the share of a BER point's time that is not
the decode itself (the channel's draws, encode, noise and quantisation,
the error count and its host read, host dispatch, idle time)."""

import re

KERNELS = re.compile(r"\brotated_acs_(warp|kernel)\b|\bchainback_(tiled|kernel)\b")


def read(rec):
    trace = rec.get("trace")
    if trace is None:
        return None
    decode = sum(s for k, (_, s) in trace["kernels"].items()
                 if KERNELS.search(k))
    if decode <= 0:
        return None
    return 1 - decode / trace["window_s"]
