"""Rate matching of the tail-biting convolutional code (3GPP TS 36.212
5.1.4.2): LTE sends the K=7 R=1/3 code's three output streams through a
32-column sub-block interleaver each, collects them into one circular
buffer and reads it to E bits, dummy bits skipped (repeating the buffer
where E is longer, puncturing it where E is shorter).

:func:`index_map` gives, for each of the E sent bits, the position in
the mother code's (L, R) output (``t * R + r``: the decoder's symbol
order) that it carries.  :func:`match` selects the sent bits from the
mother code's; :func:`dematch` undoes it on soft values, summing the
copies of a repeated bit in int32, clamping the sums to the soft range,
and leaving 0 (no information) at positions never sent.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import trace

__all__ = ["COLUMNS", "COLUMN_PERMUTATION", "index_map", "match",
           "dematch"]

COLUMNS = 32
# 36.212 Table 5.1.4-2: P(j), the original column of permuted column j
COLUMN_PERMUTATION = (1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23,
                      15, 31, 0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6,
                      22, 14, 30)


@functools.lru_cache(maxsize=None)
def _stream_order(L: int) -> np.ndarray:
    """(K_pi,) index into one stream's L bits of each bit the interleaver
    reads out, -1 for a dummy bit."""
    rows = -(-L // COLUMNS)
    dummies = rows * COLUMNS - L
    col = np.asarray(COLUMN_PERMUTATION)[np.arange(rows * COLUMNS) // rows]
    y = (np.arange(rows * COLUMNS) % rows) * COLUMNS + col
    return np.where(y < dummies, -1, y - dummies)


@functools.lru_cache(maxsize=None)
def index_map(L: int, E: int, R: int = 3) -> np.ndarray:
    """(E,) int64: the mother-code position ``t * R + r`` carried by each
    of the E sent bits of an L-bit frame (read-only)."""
    if L < 1 or E < 1:
        raise ValueError(f"need L >= 1 and E >= 1, got L={L}, E={E}")
    order = _stream_order(L)
    # the circular buffer w: stream 0's read-out, then stream 1's, ...
    w = np.concatenate([np.where(order < 0, -1, order * R + r)
                        for r in range(R)])
    w = w[w >= 0]
    out = w[np.arange(E) % w.size]
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=64)
def _device_map(L: int, E: int, R: int, device: torch.device
                ) -> torch.Tensor:
    return torch.tensor(index_map(L, E, R), device=device)


def match(coded: torch.Tensor, E: int) -> torch.Tensor:
    """(B, L, R) mother-code values (the encoder's output bits) -> (B, E)
    sent values, ``coded``'s dtype."""
    if coded.dim() != 3:
        raise ValueError(f"coded must be (B, L, R), got "
                         f"{tuple(coded.shape)}")
    B, L, R = coded.shape
    return coded.reshape(B, L * R)[:, _device_map(L, E, R, coded.device)]


def dematch(soft: torch.Tensor, L: int, *, low: int, high: int, R: int = 3,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., E) received soft values of L-bit frames -> (..., L * R) int32
    mother-code soft symbols: each position's copies summed in int32 and
    clamped to [low, high]; 0 where the position was not sent.  ``out``,
    a contiguous int32 tensor of that shape (e.g. rows of a larger
    batch), receives them in place of a new tensor."""
    with trace.span("ratematch.dematch"):
        if soft.dim() < 2:
            raise ValueError(f"soft must be (..., E), got "
                             f"{tuple(soft.shape)}")
        shape = (*soft.shape[:-1], L * R)
        if out is None:
            out = torch.zeros(shape, dtype=torch.int32, device=soft.device)
        else:
            if (tuple(out.shape) != shape or out.dtype != torch.int32
                    or out.device != soft.device or not out.is_contiguous()):
                raise ValueError(f"out must be a contiguous int32 {shape} "
                                 f"tensor on {soft.device}, got {out.dtype} "
                                 f"{tuple(out.shape)} on {out.device}")
            out.zero_()
        out.index_add_(-1, _device_map(L, soft.shape[-1], R, soft.device),
                       soft.to(torch.int32))
        return out.clamp_(low, high)
