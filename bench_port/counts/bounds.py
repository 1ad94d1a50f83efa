"""The least time an H100 could take for one kernel call: the benchmark's
frozen roofline arithmetic.

Copied from ``chip_smoke.py`` lines 314-348 (``HBM_BYTES_PER_S``,
``INT32_OPS_PER_S``, ``ACS_OPS``, ``WALK_OPS``, ``acs_bound``,
``walk_bound`` and ``bound``).  The operations and bytes come from the
algorithm and the call's shapes, never from a kernel's implementation, so
a rewrite of a kernel cannot move the yardstick.  Do not edit: later
changes to the benchmark add files beside this one.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "INT32_OPS_PER_S", "ACS_OPS", "WALK_OPS",
           "acs_bound", "walk_bound", "bound"]

# Peak rates of one H100 SXM (NVIDIA's data sheet; the Hopper white paper
# for the SM layout): HBM3 at 3.35 TB/s, and int32 ALU work at 132 SMs x
# 64 INT32 lanes x 1.98 GHz boost clock.  The kernels do int32 work only.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations a trellis state costs per step: two adds, two clamps, a
# compare, a select and a share of the decision word.  A step has only 2^R
# distinct branch metrics, each a sum of R distances, so the branch metric
# costs R 2^R a step a frame, not R a state.  A walk row costs ~8 per frame.
ACS_OPS = 8
WALK_OPS = 8


def acs_bound(S: int, B: int, T: int, R: int, W: int) -> tuple:
    """(ms, resource) of an ACS call: metrics in and out, symbols in,
    decision words and acc out; the step's 2^R branch metrics once a
    frame and ACS_OPS a state."""
    nbytes = 4 * (2 * S * B + B * T * R + T * W * B + B)
    return bound(B * T * (S * ACS_OPS + R * 2 ** R), nbytes)


def walk_bound(rows: int, B: int, out_bits: int, meta: int) -> tuple:
    """(ms, resource) of a walk: one word per row per frame (the word the
    path needs), ``meta`` int32 per row (rotation, valid), the start
    states, and ``out_bits`` bytes out per frame."""
    nbytes = 4 * rows * B + 4 * meta * rows + 4 * B + out_bits * B
    return bound(rows * B * WALK_OPS, nbytes)


def bound(ops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
