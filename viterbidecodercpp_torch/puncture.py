"""Puncture schedules: segment-wise periodic puncturing of a symbol stream.

A copy of the JAX package's ``puncture.py`` (NumPy only), so the PyTorch
port never imports the JAX package.

Generalises the reference's DAB FIC usage (run_punctured_decoder.cpp:
193-286): a schedule is a list of (pattern, pre-puncture symbol count)
segments; within each segment the pattern repeats from phase 0, exactly
like consecutive ``encode_punctured_data`` calls (each call resets its
pattern cursor, helpers/puncture_code_helpers.h:72-88).

Decode-side, puncturing is undone by re-inflating the kept symbols to the
full lattice with a neutral value (0 = the soft midpoint) at punctured
positions (helpers/puncture_code_helpers.h:31-50; ``ops/encoder.depuncture``)
- after which the standard decoder applies unchanged, because a chunked
update is equivalent to one big update (the incremental-decode contract).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .codes import CodeSpec, DAB_PI_TABLE, DAB_PI_X, PunctureSpec

__all__ = ["schedule_mask", "dab_fic_schedule", "puncture_np"]


def schedule_mask(segments: Sequence[Tuple[PunctureSpec, int]]) -> np.ndarray:
    """Boolean keep-mask for a segmented schedule.

    ``segments``: (pattern, pre-puncture symbol count) pairs; each segment
    restarts its pattern at phase 0.
    """
    parts = [spec.mask(n) for spec, n in segments]
    return np.concatenate(parts) if parts else np.zeros(0, bool)


def dab_fic_schedule(code: CodeSpec,
                     pi_16_count: int = 21,
                     pi_15_count: int = 3,
                     segment_bits: int = 32
                     ) -> List[Tuple[PunctureSpec, int]]:
    """The DAB fast-information-channel schedule (ETSI EN 300 401 clause
    11.2, run_punctured_decoder.cpp:68-76): 21 segments under PI_16,
    3 under PI_15, and the 24-symbol tail under PI_X."""
    if code.R != 4 or code.K != 7:
        raise ValueError("DAB FIC uses the K=7 R=1/4 mother code")
    seg_syms = segment_bits * code.R
    sched: List[Tuple[PunctureSpec, int]] = []
    sched += [(DAB_PI_TABLE[15], seg_syms)] * pi_16_count   # PI_16
    sched += [(DAB_PI_TABLE[14], seg_syms)] * pi_15_count   # PI_15
    sched += [(DAB_PI_X, (code.K - 1) * code.R)]            # tail
    return sched


def puncture_np(symbols: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Keep only unpunctured symbols: (..., N) -> (..., sum(mask))."""
    return np.asarray(symbols)[..., np.asarray(mask, bool)]
