"""plane_walk_roofline (%): ``csrc/plane_walk.cu``, the exact frame-major
walk over a decode's T rows, in the traced window against its bound."""

from bench_port.counts import bounds, roofline

KERNEL = r"\bplane_walk_kernel\b"


def read(rec):
    s = rec["shape"]
    ms, _ = bounds.walk_bound(s["T"], s["B"], s["T"], 0)
    return roofline.share(rec, KERNEL, ms)
