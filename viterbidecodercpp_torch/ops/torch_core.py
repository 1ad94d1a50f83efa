"""Batched PyTorch implementation of the Viterbi trellis (plain path).

The port's twin of the JAX package's ``ops/jax_core.py``: plain
torch ops over a Python loop on T, batched over frames, on any device.
It is the port's executable specification in *state order* - the
``ViterbiDecisionBits`` layout - and so an independent second reference
beside the rotated and plane kernels, whose layouts and schedules
differ.  The decoder uses it as ``backend="torch"``;
``backend="auto"`` never picks it.

Conventions shared with the JAX package (so tests compare like with
like):
  * Metrics are state-major (S, B) int32.  u8/u16 metric *semantics* are
    emulated on int32 by clamping (saturating) or masking (wrapping).
  * Decisions are packed 32 states per int32 word: state s is bit
    ``s % 32`` of word ``s // 32``.  Bit 31 is the int32 sign bit; the
    packing sums in int64 and folds back with a two's-complement wrap.
  * Symbols are (B, T, R) int32, frame-major (the user layout).

Reference semantics matched exactly (see the JAX package's ops/
numpy_ref.py for the oracle): ACS recursion viterbi_decoder_scalar.h:
58-135, renormalisation gated on the state-0 metric
viterbi_decoder_scalar.h:48, chainback viterbi_decoder_core.h:214-236.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..codes import CodeSpec, branch_table
from ..config import DecoderConfig

__all__ = [
    "StaticSpec",
    "make_static_spec",
    "initial_metrics",
    "equal_metrics",
    "symmetric_amplitude",
    "spec_cache",
    "needs_big_state",
    "acs_select",
    "acs_scan",
    "chainback_scan",
    "pack_decisions",
    "MAX_LANE_STATES",
    "KERNEL_MAX_RATE",
    "DECISION_WORD_BITS",
]

DECISION_WORD_BITS = 32

# Upper end of the rotated kernel's class; above it the plane kernels
# (ops/plane.py) take over, as in the JAX package.
MAX_LANE_STATES = 4096

# Largest rate R the three CUDA ACS kernels take (VDT_MAX_R in their
# sources: per-rate tap masks and symbol buffers of fixed size).
KERNEL_MAX_RATE = 16


class StaticSpec(NamedTuple):
    """Constants derived from (code, config); the same fields, in the
    same order, as ``jax_core.StaticSpec``."""

    K: int
    R: int
    S: int              # 2**(K-1) states
    H: int              # 2**(K-2) half states
    W: int              # ceil(S / 32) packed decision words
    bt: tuple           # (R, H) branch table as nested tuples (hashable)
    max_error: int
    metric_max: int
    renorm_threshold: int
    init_start: int
    init_other: int
    saturating: bool
    soft_low: int       # documented soft-symbol range [low, high]; the
    soft_high: int      # decoder clamps inputs to it (test_helpers.h:88-93)


def make_static_spec(code: CodeSpec, config: DecoderConfig) -> StaticSpec:
    bt = branch_table(code, config.soft_decision_high, config.soft_decision_low)
    S = code.num_states
    return StaticSpec(
        K=code.K,
        R=code.R,
        S=S,
        H=code.num_half_states,
        W=max(S // DECISION_WORD_BITS, 1),
        bt=tuple(tuple(int(v) for v in row) for row in bt),
        max_error=config.soft_decision_max_error,
        metric_max=config.metric_max,
        renorm_threshold=config.renormalisation_threshold,
        init_start=config.initial_start_error,
        init_other=config.initial_non_start_error,
        saturating=config.arith == "saturating",
        soft_low=int(config.soft_decision_low),
        soft_high=int(config.soft_decision_high),
    )


def spec_cache(fn):
    """Cache ``fn(spec, *args)`` by the spec's identity and ``args``.

    ``functools.lru_cache`` hashes a spec and compares it with an equal
    cached one field by field, its R x 2^(K-2) branch table too:
    milliseconds a lookup past K=19, on every kernel call.  Each entry
    keeps its spec alive, so no other spec takes its id while it lives."""
    memo = {}

    @functools.wraps(fn)
    def cached(spec, *args):
        key = (id(spec), *args)
        hit = memo.get(key)
        if hit is None:
            if len(memo) >= 64:
                memo.clear()
            hit = memo[key] = (spec, fn(spec, *args))
        return hit[1]

    return cached


@spec_cache
def symmetric_amplitude(spec: StaticSpec) -> Optional[int]:
    """A when the branch table is {-A, +A}-valued, else None (cached: at
    Cassini the table has 49,152 entries and every plane ACS call asks)."""
    bt = np.asarray(spec.bt)
    amp = int(bt.max())
    if amp > 0 and int(bt.min()) == -amp and np.isin(bt, (-amp, amp)).all():
        return amp
    return None


def needs_big_state(spec: StaticSpec) -> bool:
    """True when S exceeds the rotated kernel's class (K >= 14)."""
    return spec.S > MAX_LANE_STATES


def initial_metrics(spec: StaticSpec, batch: int, starting_state: int = 0,
                    device="cpu") -> torch.Tensor:
    """(S, B) int32 metric seed - reset() semantics
    (viterbi_decoder_core.h:202-211)."""
    m = torch.full((spec.S, batch), spec.init_other, dtype=torch.int32,
                   device=device)
    m[starting_state & (spec.S - 1), :] = spec.init_start
    return m


def equal_metrics(spec: StaticSpec, batch: int, device="cpu") -> torch.Tensor:
    """(S, B) int32 metric seed of a tail-biting frame, whose start state
    is unknown: every state at ``init_start``."""
    return torch.full((spec.S, batch), spec.init_start, dtype=torch.int32,
                      device=device)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Fold an int64 tensor holding 32-bit words back to int32 with an
    explicit two's-complement wrap (bit 31 becomes the sign bit)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(S, B) {0, 1} bits -> (W, B) int32 words, bit s%32 of word s//32."""
    S, B = bits.shape
    W = max(-(-S // DECISION_WORD_BITS), 1)
    b64 = bits.to(torch.int64)
    if S < W * DECISION_WORD_BITS:
        pad = b64.new_zeros(W * DECISION_WORD_BITS - S, B)
        b64 = torch.cat([b64, pad], 0)
    shifts = torch.arange(DECISION_WORD_BITS, dtype=torch.int64,
                          device=bits.device)
    words = (b64.reshape(W, DECISION_WORD_BITS, B) << shifts[None, :, None])
    return wrap_int32(words.sum(dim=1))


def rows_out(spec: StaticSpec, metrics: torch.Tensor, T: int,
             out: Optional[torch.Tensor]) -> torch.Tensor:
    """The (T, W, B) tensor that receives an ACS call's decision rows:
    ``out`` when given (checked), else a new one."""
    shape = (T, spec.W, metrics.shape[1])
    if out is None:
        return torch.empty(shape, dtype=torch.int32, device=metrics.device)
    if (tuple(out.shape) != shape or out.dtype != torch.int32
            or out.device != metrics.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int32 {shape} tensor on "
                         f"{metrics.device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    return out


def acs_select(spec: StaticSpec, lo: torch.Tensor, hi: torch.Tensor,
               bm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor, torch.Tensor]:
    """The add-compare-select core (jax_core.acs_select).

    ``lo``/``hi``: predecessor metrics, ``bm``: branch metric - all
    (H, B) int32.  Returns (new_even, new_odd, dec0, dec1) with the
    reference's saturation/wrap and tie-break semantics
    (x86/viterbi_decoder_sse_u16.h:106-115 saturating/tie->1;
    viterbi_decoder_scalar.h:113-128 wrapping/tie->0).
    """
    ibm = spec.max_error - bm
    e00 = lo + bm
    e10 = hi + ibm
    e01 = lo + ibm
    e11 = hi + bm
    if spec.saturating:
        cap = spec.metric_max
        e00 = torch.clamp(e00, max=cap)
        e10 = torch.clamp(e10, max=cap)
        e01 = torch.clamp(e01, max=cap)
        e11 = torch.clamp(e11, max=cap)
        dec0 = e10 <= e00           # SIMD tie -> predecessor 1
        dec1 = e11 <= e01
    else:
        mask = spec.metric_max
        e00 = e00 & mask
        e10 = e10 & mask
        e01 = e01 & mask
        e11 = e11 & mask
        dec0 = e00 > e10            # scalar tie -> predecessor 0
        dec1 = e01 > e11
    new_even = torch.where(dec0, e10, e00)
    new_odd = torch.where(dec1, e11, e01)
    return new_even, new_odd, dec0.to(torch.int32), dec1.to(torch.int32)


def _butterfly_step(spec: StaticSpec, metrics: torch.Tensor,
                    sym: torch.Tensor, bt: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One trellis step over a batch, state-major.

    ``metrics``: (S, B) int32; ``sym``: (R, B) int32; ``bt``: (R, H).
    Returns (new_metrics (S, B), dec0 (H, B), dec1 (H, B)).
    """
    bm = (bt[:, :, None] - sym[:, None, :]).abs().sum(dim=0,
                                                      dtype=torch.int32)
    lo = metrics[: spec.H]
    hi = metrics[spec.H:]
    new_even, new_odd, dec0, dec1 = acs_select(spec, lo, hi, bm)
    new_metrics = torch.stack([new_even, new_odd], dim=1).reshape(
        spec.S, -1)
    return new_metrics, dec0, dec1


def _renormalise(spec: StaticSpec, metrics: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame renorm, gated on the state-0 metric
    (viterbi_decoder_scalar.h:48, renormalise 139-153).

    metrics: (S, B); returns (renormalised metrics, subtracted (B,))."""
    gate = metrics[0, :] >= spec.renorm_threshold
    mins = metrics.amin(dim=0)
    sub = torch.where(gate, mins, torch.zeros_like(mins))
    return metrics - sub[None, :], sub


def pack_decisions(spec: StaticSpec, dec0: torch.Tensor,
                   dec1: torch.Tensor) -> torch.Tensor:
    """Pack butterfly decisions (H, B) x2 into (W, B) int32 words.

    State 2h carries dec0[h] at bit (2h % 32); state 2h+1 carries dec1[h]
    at bit (2h+1 % 32) - the ``ViterbiDecisionBits`` layout
    (viterbi_decoder_core.h:49-83) with a fixed 32-bit block size.
    """
    bits = torch.stack([dec0, dec1], dim=1).reshape(spec.S, -1)
    return pack_bits(bits)


def _unpack_bit(spec: StaticSpec, words: torch.Tensor,
                state: torch.Tensor) -> torch.Tensor:
    """Read the decision bit for ``state`` (B,) from packed words (W, B).

    A word index outside [0, W) reads as 0, as the JAX package's masked
    select does."""
    widx = state >> 5
    inside = (widx >= 0) & (widx < spec.W)
    idx = torch.where(inside, widx, torch.zeros_like(widx)).to(torch.int64)
    word = words.gather(0, idx[None, :])[0]
    word = torch.where(inside, word, torch.zeros_like(word))
    return (word >> (state & (DECISION_WORD_BITS - 1))) & 1


def acs_scan(spec: StaticSpec, metrics: torch.Tensor, symbols: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run T trellis steps over a batch of frames (plain state-order path).

    Args:
      metrics: (S, B) int32 carry from ``initial_metrics`` or a previous
        call (the update API is incremental).
      symbols: (B, T, R) int32 soft symbols (frame-major, user layout).

    Returns:
      (metrics (S, B), packed decisions (T, W, B) int32,
       accumulated renorm error (B,) int32).
    """
    B, T, R = symbols.shape
    device = metrics.device
    bt = torch.tensor(spec.bt, dtype=torch.int32, device=device)   # (R, H)
    sym_t = symbols.to(torch.int32).permute(1, 2, 0)          # (T, R, B)
    m = metrics.to(torch.int32)
    acc = torch.zeros(B, dtype=torch.int32, device=device)
    packed = torch.empty((T, spec.W, B), dtype=torch.int32, device=device)
    for t in range(T):
        m, dec0, dec1 = _butterfly_step(spec, m, sym_t[t], bt)
        m, sub = _renormalise(spec, m)
        acc = acc + sub
        packed[t] = pack_decisions(spec, dec0, dec1)
    return m, packed, acc


def chainback_scan(spec: StaticSpec, packed: torch.Tensor,
                   end_state: torch.Tensor, total_bits: int) -> torch.Tensor:
    """Batched traceback over state-order packed decisions.

    Args:
      packed: (T, W, B) int32 decision words with T >= total_bits + K - 1;
        rows beyond ``total_bits + K - 1`` are ignored.
      end_state: (B,) int32 states to start the walk from (0 after tail
        termination).
      total_bits: number of data bits to recover.

    Returns (B, total_bits) uint8 data bits.  The bit read at row
    ``j + K - 1`` is data bit j, and
    ``state <- (state >> 1) | (bit << (K-2))``
    (viterbi_decoder_core.h:214-236).
    """
    Kb = spec.K - 1
    if packed.shape[0] < total_bits + Kb:
        raise ValueError("decision history shorter than total_bits + K - 1")
    B = packed.shape[2]
    state = end_state.to(torch.int32)
    bits = torch.empty((total_bits, B), dtype=torch.uint8,
                       device=packed.device)
    for j in range(total_bits - 1, -1, -1):
        d = _unpack_bit(spec, packed[j + Kb], state)
        state = (state >> 1) | (d << (Kb - 1))
        bits[j] = d.to(torch.uint8)
    return bits.t().contiguous()
