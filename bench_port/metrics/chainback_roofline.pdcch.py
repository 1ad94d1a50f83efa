"""chainback_roofline.pdcch (%): ``csrc/chainback.cu`` (either design), the
circular decode's walk from row 3L to row L + K - 1, in the
blind-decoding cell's traced window against its bound, the bound's mean
over the window's calls of the four frame sizes."""

from bench_port.counts import roofline, tailbiting

KERNEL = r"\bchainback_(tiled|kernel)\b"


def read(rec):
    ms = tailbiting.mean_bound_ms(rec, "walk")
    return None if ms is None else roofline.share(rec, KERNEL, ms)
