"""rotated_acs_roofline.pdcch (%): ``csrc/rotated_acs.cu`` (either design)
in the blind-decoding cell's traced window against its bound, the
bound's mean over the window's calls of the four frame sizes (T = 3L,
R = 3, B = 157 x subframes)."""

from bench_port.counts import roofline, tailbiting

KERNEL = r"\brotated_acs_(warp|kernel)\b"


def read(rec):
    ms = tailbiting.mean_bound_ms(rec, "acs")
    return None if ms is None else roofline.share(rec, KERNEL, ms)
