"""ber.channel_ms (ms): the BER batch's channel kernel
(``csrc/awgn_channel.cu``: encode, BPSK, noise and quantise after the
draws), its summed self device time in the traced window over its calls;
None where the trace holds no such kernel (a program whose channel runs
as torch ops)."""

import re

KERNEL = re.compile(r"\bawgn_channel\b")


def read(rec):
    trace = rec.get("trace")
    if trace is None:
        return None
    hits = [v for k, v in trace["kernels"].items() if KERNEL.search(k)]
    calls = sum(c for c, _ in hits)
    seconds = sum(s for _, s in hits)
    if not calls or seconds <= 0:
        return None
    return 1e3 * seconds / calls
