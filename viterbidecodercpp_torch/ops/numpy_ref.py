"""Pure-NumPy executable specification of the decode pipeline (a copy of
the JAX package's ``ops/numpy_ref.py``).

This module is the *oracle* the port's harness holds every route against
(``tools/torch_fuzz_differential.py``, ``tools/torch_run_tests.py``); it
imports numpy and the port's own ``codes`` and ``config``, never jax.  It
implements the same trellis semantics as the reference library
(viterbi_decoder_scalar.h:42-153, viterbi_decoder_core.h:202-236) in plain
array code, for a single frame, with both arithmetic modes:

  * ``saturating`` - SIMD-kernel semantics (saturated unsigned adds,
    ties pick the leading-bit-1 predecessor; x86/viterbi_decoder_sse_u16.h
    lines 106-115).
  * ``wrapping`` - scalar-kernel semantics (modular adds, ties pick the
    leading-bit-0 predecessor; viterbi_decoder_scalar.h:113-128).

It is deliberately slow and simple - do not use it on the hot path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..codes import CodeSpec, branch_table, parity
from ..config import DecoderConfig

__all__ = [
    "encode_bits",
    "encode_bytes",
    "bytes_to_bits",
    "bits_to_bytes",
    "viterbi_decode",
    "acs_run",
    "traceback",
]


def bytes_to_bits(data: np.ndarray) -> np.ndarray:
    """Unpack bytes to bits, MSB first within each byte.

    Matches the encoder's input-bit order
    (convolutional_encoder_shift_register.h:52: ``(x >> (7-i)) & 1``).
    """
    data = np.asarray(data, dtype=np.uint8)
    return np.unpackbits(data, bitorder="big")


def bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    """Pack bits to bytes, MSB first (inverse of :func:`bytes_to_bits`).

    Matches chainback's output-byte convention
    (viterbi_decoder_core.h:105-112 + 223-235).
    """
    bits = np.asarray(bits, dtype=np.uint8)
    if bits.size % 8:
        raise ValueError("bit count must be a multiple of 8")
    return np.packbits(bits, bitorder="big")


def encode_bits(code: CodeSpec, bits: np.ndarray, *, terminate: bool = True,
                initial_state: int = 0) -> np.ndarray:
    """Convolutionally encode a bit sequence; returns output bits.

    Semantics of ``ConvolutionalEncoder_ShiftRegister::consume_byte``
    (convolutional_encoder_shift_register.h:42-62): for each input bit,
    ``reg = (reg << 1) | bit`` then output bit j = parity(G[j] & reg).
    With ``terminate`` the K-1 zero tail bits that drive the register to
    state 0 are appended (helpers/test_helpers.h:54-60).

    Output order: for input bit t, the R output bits occupy positions
    ``t*R .. t*R + R - 1``.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    if terminate:
        bits = np.concatenate([bits, np.zeros(code.K - 1, dtype=np.uint8)])
    T = bits.size
    # Register value at step t holds bits t-K+1..t (newest at LSB); closed
    # form via shifted copies of the bit stream.
    out = np.zeros((T, code.R), dtype=np.uint8)
    regs = np.zeros(T, dtype=np.uint64)
    acc = np.uint64(initial_state)
    for t in range(T):
        acc = ((acc << np.uint64(1)) | np.uint64(bits[t])) & np.uint64((1 << code.K) - 1)
        regs[t] = acc
    for j, g in enumerate(code.G):
        out[:, j] = parity(regs & np.uint64(g))
    return out.reshape(-1)


def encode_bytes(code: CodeSpec, data: np.ndarray, high: int, low: int,
                 *, terminate: bool = True) -> np.ndarray:
    """Encode bytes to soft symbols in {low, high} (test_helpers.h:17-64)."""
    bits = encode_bits(code, bytes_to_bits(data), terminate=terminate)
    return np.where(bits.astype(bool), high, low).astype(np.int32)


def acs_run(
    code: CodeSpec,
    config: DecoderConfig,
    symbols: np.ndarray,
    *,
    starting_state: int = 0,
    initial_metrics: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Run the add-compare-select trellis recursion over ``symbols``.

    Returns ``(metrics, decisions, accumulated_error)`` where ``metrics``
    is the final (S,) state-metric vector, ``decisions`` is a (T, S) uint8
    array of surviving-predecessor leading bits (T = len(symbols)/R trellis
    steps), and ``accumulated_error`` is the total subtracted by
    renormalisation (viterbi_decoder_scalar.h:42-54).
    """
    symbols = np.asarray(symbols, dtype=np.int64)
    R, S, H = code.R, code.num_states, code.num_half_states
    if symbols.size % R:
        raise ValueError("symbol count must be a multiple of R")
    T = symbols.size // R
    bt = branch_table(code, config.soft_decision_high, config.soft_decision_low)
    bt = bt.astype(np.int64)  # (R, H)
    mmax = config.metric_max
    sat = config.arith == "saturating"

    if initial_metrics is not None:
        metrics = np.asarray(initial_metrics, dtype=np.int64).copy()
        if metrics.shape != (S,):
            raise ValueError("initial_metrics must have shape (num_states,)")
    else:
        # reset() seeding: start state gets initial_start_error, the rest
        # initial_non_start_error (viterbi_decoder_core.h:202-211).
        metrics = np.full(S, config.initial_non_start_error, dtype=np.int64)
        metrics[starting_state & (S - 1)] = config.initial_start_error

    decisions = np.zeros((T, S), dtype=np.uint8)
    acc = 0
    for t in range(T):
        sym = symbols[t * R:(t + 1) * R]  # (R,)
        bm = np.abs(bt - sym[:, None]).sum(axis=0)  # (H,)
        ibm = config.soft_decision_max_error - bm
        lo, hi = metrics[:H], metrics[H:]
        e00 = lo + bm    # pred leading bit 0 -> next state 2h
        e10 = hi + ibm   # pred leading bit 1 -> next state 2h
        e01 = lo + ibm   # pred leading bit 0 -> next state 2h+1
        e11 = hi + bm    # pred leading bit 1 -> next state 2h+1
        if sat:
            e00 = np.minimum(e00, mmax)
            e10 = np.minimum(e10, mmax)
            e01 = np.minimum(e01, mmax)
            e11 = np.minimum(e11, mmax)
            dec0 = (e10 <= e00).astype(np.uint8)  # _mm_cmpeq(min, e1): tie -> 1
            dec1 = (e11 <= e01).astype(np.uint8)
        else:
            e00 &= mmax
            e10 &= mmax
            e01 &= mmax
            e11 &= mmax
            dec0 = (e00 > e10).astype(np.uint8)   # scalar `>`: tie -> 0
            dec1 = (e01 > e11).astype(np.uint8)
        new_even = np.where(dec0.astype(bool), e10, e00)
        new_odd = np.where(dec1.astype(bool), e11, e01)
        metrics = np.stack([new_even, new_odd], axis=1).reshape(S)
        decisions[t] = np.stack([dec0, dec1], axis=1).reshape(S)
        # Renormalise when the state-0 metric crosses the threshold - the
        # gate reads new_metric[0], not the minimum
        # (viterbi_decoder_scalar.h:48).
        if metrics[0] >= config.renormalisation_threshold:
            m = int(metrics.min())
            metrics -= m
            acc += m
    return metrics, decisions, acc


def traceback(code: CodeSpec, decisions: np.ndarray, total_bits: int,
              end_state: int = 0) -> np.ndarray:
    """Chain back through the decision history; returns decoded data bits.

    Matches ``ViterbiDecoder_Core::chainback`` (viterbi_decoder_core.h:
    214-236): walking back from ``end_state``, the decision bit read at
    trellis row ``j + K - 1`` *is* data bit j, and the state recurrence is
    ``s_prev = (s >> 1) | (d << (K-2))``.
    """
    decisions = np.asarray(decisions)
    Kb = code.state_bits
    if decisions.shape[0] < total_bits + Kb:
        raise ValueError("decision history shorter than total_bits + K - 1")
    state = int(end_state)
    out = np.zeros(total_bits, dtype=np.uint8)
    for j in range(total_bits - 1, -1, -1):
        d = int(decisions[j + Kb, state])
        out[j] = d
        state = (state >> 1) | (d << (Kb - 1))
    return out


def viterbi_decode(
    code: CodeSpec,
    config: DecoderConfig,
    symbols: np.ndarray,
    total_bits: int,
    *,
    end_state: int = 0,
) -> Tuple[np.ndarray, int, int]:
    """Full single-frame decode: ACS + chainback.

    Returns ``(data_bits, final_error, accumulated_error)`` where
    ``final_error`` is the end-state metric (viterbi_decoder_core.h:195-199).
    """
    metrics, decisions, acc = acs_run(code, config, symbols)
    bits = traceback(code, decisions, total_bits, end_state)
    return bits, int(metrics[end_state]), acc
