"""chainback_roofline (%): ``csrc/chainback.cu`` (either design), the
slot-order walk over a decode's T rows with one rotation a row, in the
traced window against its bound."""

from bench_port.counts import bounds, roofline

KERNEL = r"\bchainback_(tiled|kernel)\b"


def read(rec):
    s = rec["shape"]
    ms, _ = bounds.walk_bound(s["T"], s["B"], s["T"], 1)
    return roofline.share(rec, KERNEL, ms)
