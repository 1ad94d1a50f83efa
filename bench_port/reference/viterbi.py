"""The benchmark's plain reference: Viterbi decoding in NumPy, batched over
frames, written from the trellis semantics alone.

It imports NumPy only: no jax, no JAX package, and nothing of
``viterbidecodercpp_torch``.  Everything the program derives from a code
and a decode type (branch patterns, soft levels, initial metrics, the
renormalisation threshold) is worked out again here from the numbers in
the configuration file.

Semantics (frozen from ``viterbidecodercpp_torch/ops/numpy_ref.py``
lines 96-199, ``acs_run`` and ``traceback``, and from the decode-type
table of ``viterbidecodercpp_torch/config.py`` lines 83-105,
``get_decode_config``; the frame batching and the streaming walk are
this file's own):

  * a state is the last K-1 input bits, newest at bit 0; the transition
    from predecessor ``p = (s >> 1) | (b << (K-2))`` into state ``s``
    puts the register ``s | (b << (K-1))`` through the polynomials, and
    output bit r is ``parity(G[r] & register)``;
  * a branch metric is the sum over the R symbols of ``|level - symbol|``,
    the level ``high`` for an output bit 1 and ``low`` for 0, after the
    symbols are clamped to [low, high];
  * saturating arithmetic clamps each candidate to the metric maximum and
    a tie keeps the predecessor with leading bit 1; wrapping arithmetic
    masks it and a tie keeps leading bit 0;
  * after each step, where the state-0 metric has reached the threshold,
    the frame's minimum is subtracted from every state and added to its
    accumulated error;
  * the decision bit of a state is its surviving predecessor's leading
    bit, and a walk from state s reading decision d at row t goes on at
    ``(s >> 1) | (d << (K-2))``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["DECODE_TYPES", "Trellis", "trellis", "branch_metrics", "acs",
           "traceback", "decode", "stream_pushes"]

# decode type -> (soft high, soft low, error-margin scale, metric bits)
DECODE_TYPES = {"SOFT16": (127, -127, 5, 16),
                "SOFT8": (3, -3, 2, 8),
                "HARD8": (1, -1, 3, 8)}


@dataclasses.dataclass(frozen=True)
class Trellis:
    K: int
    G: Tuple[int, ...]
    high: int
    low: int
    metric_max: int
    init_start: int
    init_other: int
    threshold: int
    saturating: bool

    @property
    def R(self) -> int:
        return len(self.G)

    @property
    def S(self) -> int:
        return 1 << (self.K - 1)


def trellis(K: int, G: Sequence[int], decode_type: str,
            arith: str = "saturating",
            metric_bits: Optional[int] = None) -> Trellis:
    """The trellis constants of a code under a decode type.
    ``metric_bits`` overrides the type's metric width (the control runs
    the reference one width down)."""
    if arith not in ("saturating", "wrapping"):
        raise ValueError(f"unknown arithmetic {arith!r}")
    high, low, scale, bits = DECODE_TYPES[decode_type]
    bits = metric_bits or bits
    metric_max = (1 << bits) - 1
    max_error = (high - low) * len(G)
    # the margin is computed in the narrow unsigned metric type
    margin = (max_error * scale) & metric_max
    return Trellis(K=int(K), G=tuple(int(g) & ((1 << K) - 1) for g in G),
                   high=high, low=low, metric_max=metric_max, init_start=0,
                   init_other=margin, threshold=metric_max - margin,
                   saturating=arith == "saturating")


def _parity(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.int64)
    p = np.zeros_like(x)
    while x.any():
        p ^= x & 1
        x >>= 1
    return p


def _transitions(tr: Trellis) -> Tuple[np.ndarray, np.ndarray]:
    """(pred, pattern), each (2, S): the predecessor with leading bit b of
    each state, and the R-bit output pattern of that transition."""
    s = np.arange(tr.S, dtype=np.int64)
    b = np.arange(2, dtype=np.int64)[:, None]
    pred = (s >> 1) | (b << (tr.K - 2))
    reg = s | (b << (tr.K - 1))
    pattern = np.zeros((2, tr.S), np.int64)
    for r, g in enumerate(tr.G):
        pattern |= _parity(reg & g) << r
    return pred, pattern


def branch_metrics(tr: Trellis, symbols: np.ndarray) -> np.ndarray:
    """(T, 2^R, F) int32 branch metric of every output pattern, from (F,
    T, R) symbols."""
    sym = np.clip(np.asarray(symbols, np.int64), tr.low, tr.high)
    pats = np.arange(1 << tr.R)
    bits = (pats[:, None] >> np.arange(tr.R)) & 1           # (P, R)
    levels = np.where(bits == 1, tr.high, tr.low)            # (P, R)
    # (F, T, 1, R) - (P, R) -> sum over R -> (F, T, P)
    bm = np.abs(sym[:, :, None, :] - levels).sum(axis=-1)
    return np.ascontiguousarray(bm.transpose(1, 2, 0)).astype(np.int32)


def acs(tr: Trellis, symbols: np.ndarray, *, ends: Sequence[int] = ()
        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list]:
    """Run the trellis over (F, T, R) symbols from the reset metrics.

    Returns (metrics (S, F), decisions (T, S, F) bool, accumulated error
    (F,), [metrics after step e for each e in ``ends``])."""
    F, T = symbols.shape[0], symbols.shape[1]
    pred, pattern = _transitions(tr)
    m = np.full((tr.S, F), tr.init_other, np.int32)
    m[0] = tr.init_start
    acc = np.zeros(F, np.int64)
    dec = np.empty((T, tr.S, F), bool)
    cand = np.empty((2, tr.S, F), np.int32)
    want = set(ends)
    snaps = {}
    step = max(1, 4096 // tr.S)     # steps whose branch metrics are taken
    for t0 in range(0, T, step):    # at once
        # (steps, 2, S, F): each transition's branch metric
        bmc = np.take(branch_metrics(tr, symbols[:, t0:t0 + step]),
                      pattern, axis=1)
        for i in range(bmc.shape[0]):
            t = t0 + i
            np.take(m, pred, axis=0, out=cand)
            cand += bmc[i]
            if tr.saturating:
                np.minimum(cand, tr.metric_max, out=cand)
                np.less_equal(cand[1], cand[0], out=dec[t])
            else:
                cand &= tr.metric_max
                np.greater(cand[0], cand[1], out=dec[t])
            # the survivor's metric is the smaller candidate either way
            np.minimum(cand[0], cand[1], out=m)
            if m[0].max() >= tr.threshold:
                gate = m[0] >= tr.threshold
                sub = np.where(gate, m.min(axis=0), 0).astype(np.int32)
                m -= sub
                acc += sub
            if t + 1 in want:
                snaps[t + 1] = m.copy()
    return m, dec, acc, [snaps[e] for e in ends]


def traceback(tr: Trellis, dec: np.ndarray, total_bits: int,
              end_state: int = 0) -> np.ndarray:
    """(F, total_bits) uint8 data bits: the walk from ``end_state`` over
    rows total_bits + K - 2 down to K - 1 (row j + K - 1 carries data bit
    j)."""
    F = dec.shape[2]
    frames = np.arange(F)
    state = np.full(F, end_state & (tr.S - 1), np.int64)
    out = np.empty((F, total_bits), np.uint8)
    for j in range(total_bits - 1, -1, -1):
        d = dec[j + tr.K - 1, state, frames].astype(np.int64)
        out[:, j] = d
        state = (state >> 1) | (d << (tr.K - 2))
    return out


def decode(tr: Trellis, symbols: np.ndarray, total_bits: int,
           end_state: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One-shot decode of (F, T, R) symbols: (bits (F, total_bits), the
    end state's metric (F,), accumulated error (F,))."""
    m, dec, acc, _ = acs(tr, symbols)
    bits = traceback(tr, dec, total_bits, end_state)
    return bits, m[end_state & (tr.S - 1)].astype(np.int64), acc


def stream_pushes(tr: Trellis, symbols: np.ndarray, window: int,
                  chunk: int) -> Tuple[np.ndarray, np.ndarray]:
    """A fixed-delay stream from reset over (F, P * chunk, R) symbols,
    ``chunk`` steps a push: (bits (P, F, chunk), valid (P,)).

    After push p the walk starts from each frame's first minimum state
    and reads the last ``window`` rows back (rows before the stream's
    start decide 0); the push emits the path bits of the oldest ``chunk``
    of those rows, and is valid once ``window`` rows have been seen."""
    F, T = symbols.shape[0], symbols.shape[1]
    if T % chunk or window % chunk:
        raise ValueError("the stream and the window must be whole chunks")
    P = T // chunk
    ends = [(p + 1) * chunk for p in range(P)]
    _, dec, _, snaps = acs(tr, symbols, ends=ends)
    # rows before the stream's start: decisions 0
    dec = np.concatenate([np.zeros((window, tr.S, F), bool), dec])
    frames = np.arange(F)[None, :]
    state = np.stack([np.argmin(m, axis=0) for m in snaps]).astype(np.int64)
    last = np.asarray(ends)[:, None] + window - 1          # padded rows
    bits = np.empty((P, F, chunk), np.uint8)
    for i in range(window):
        d = dec[last - i, state, frames].astype(np.int64)   # (P, F)
        j = window - 1 - i
        if j < chunk:
            bits[:, :, j] = d
        state = (state >> 1) | (d << (tr.K - 2))
    valid = np.asarray(ends) >= window
    return bits, valid
