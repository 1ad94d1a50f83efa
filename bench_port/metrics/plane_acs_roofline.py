"""plane_acs_roofline (%): ``csrc/plane_acs.cu`` in the traced window
against its bound at the cell's call shape."""

from bench_port.counts import bounds, roofline

KERNEL = r"\bplane_acs_kernel\b"


def read(rec):
    s = rec["shape"]
    ms, _ = bounds.acs_bound(s["S"], s["B"], s["T"], s["R"], s["W"])
    return roofline.share(rec, KERNEL, ms)
