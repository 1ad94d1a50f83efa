"""rotated_acs_roofline (%): ``csrc/rotated_acs.cu`` (either design) in
the traced window against its bound at the cell's call shape."""

from bench_port.counts import bounds, roofline

KERNEL = r"\brotated_acs_(warp|kernel)\b"


def read(rec):
    s = rec["shape"]
    ms, _ = bounds.acs_bound(s["S"], s["B"], s["T"], s["R"], s["W"])
    return roofline.share(rec, KERNEL, ms)
