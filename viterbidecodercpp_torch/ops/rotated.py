"""Rotated in-place ACS for 64 <= S <= 4096 (the port of
the JAX package's ``ops/rotated_pallas.py``).

Logical state s lives at slot ``rotr_n(s, t)`` after t steps of one call
(n = K-1), so the butterfly writes in place and each slot needs only two
candidates; at phase phi = t mod n slot p pairs with ``p ^ 2^j``,
j = (n-1-phi) mod n.  The contract is ``rotated_pallas.acs_rotated``'s:

    metrics (S, B) int32 *state order*, symbols (B, T, R) int32 ->
    (metrics (S, B) int32 state order, packed (T, W, B) int32
     slot-order rows, acc (B,) int32).

The rotation schedule restarts at age 0 on every call and the final
metrics are un-rotated, so chunked updates chain without phase
bookkeeping; decision row i of a call is slot-rotated by (i + 1) mod n,
which the decoder records in ``DecoderState.row_rots`` for the walk.

:func:`acs_rotated` launches the CUDA kernel (``csrc/rotated_acs.cu``)
for CUDA tensors and runs the plain version :func:`acs_rotated_ref` -
same layout, same schedule, plain torch ops over a loop on T - only for
CPU tensors.  The kernel has two designs, picked by :func:`kernel_design`:
one warp per frame with the metrics in registers for S <= 1024 and
R <= 5 (fed the branch-pattern tables of :func:`_warp_patterns`), one
block per frame otherwise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import trace
from . import _build
from .torch_core import (KERNEL_MAX_RATE, MAX_LANE_STATES, StaticSpec,
                         pack_bits, rows_out, spec_cache)

__all__ = ["acs_rotated", "acs_rotated_ref", "slot_scan", "kernel_design",
           "ROTATED_MIN_STATES", "WARP_MAX_STATES", "WARP_MAX_RATE"]

ROTATED_MIN_STATES = 64
# Bounds of the warp-per-frame design (VDT_WARP_MAX_N, VDT_WARP_MAX_R in
# csrc/rotated_acs.cu): a lane holds S/32 metrics in registers, and a step
# has at most 2^R <= 32 branch patterns, one per lane.
WARP_MAX_STATES = 1024
WARP_MAX_RATE = 5


def _rotr(x: np.ndarray, k: int, n: int) -> np.ndarray:
    """Rotate the low n bits of x right by k (any sign of k)."""
    k %= n
    mask = (1 << n) - 1
    return ((x >> k) | (x << (n - k))) & mask


def _slot_bt(spec: StaticSpec) -> np.ndarray:
    """(n, R, S) per-phase, per-slot branch-table values.

    At phase phi the pairing bit is j = (n-1-phi) % n; slot p belongs to
    the butterfly whose lo slot is p with bit j cleared, logical
    half-state h = rotl_n(p_lo, phi) (rotated_pallas._slot_bt)."""
    n = spec.K - 1
    bt = np.asarray(spec.bt, dtype=np.int32)          # (R, H)
    pos = np.arange(spec.S)
    out = np.zeros((n, spec.R, spec.S), np.int32)
    for phi in range(n):
        j = (n - 1 - phi) % n
        h = _rotr(pos & ~(1 << j), -phi, n)            # rotl(p_lo, phi)
        out[phi] = bt[:, h]
    return out


def kernel_design(S: int, R: int) -> str:
    """The CUDA kernel's design for S states at rate 1/R: ``"warp"`` (one
    warp per frame, S/32 metrics per lane in registers, a step's 2^R
    branch metrics one per lane) for S <= :data:`WARP_MAX_STATES` and
    R <= :data:`WARP_MAX_RATE`; ``"block"`` (one block per frame, metrics
    in shared memory, branch values from the taps) otherwise, where a lane
    would need 64 or more metric registers or a step has more branch
    patterns than a warp has lanes."""
    if not ROTATED_MIN_STATES <= S <= MAX_LANE_STATES:
        raise ValueError(f"the rotated ACS covers {ROTATED_MIN_STATES} <= S "
                         f"<= {MAX_LANE_STATES}, got S={S}")
    if R < 1:
        raise ValueError(f"rate 1/R needs R >= 1, got R={R}")
    return "warp" if S <= WARP_MAX_STATES and R <= WARP_MAX_RATE \
        else "block"


def _check(spec: StaticSpec, metrics: torch.Tensor,
           symbols: torch.Tensor) -> Tuple[int, int]:
    if not ROTATED_MIN_STATES <= spec.S <= MAX_LANE_STATES:
        raise ValueError(f"the rotated ACS covers {ROTATED_MIN_STATES} <= S "
                         f"<= {MAX_LANE_STATES}, got S={spec.S}")
    if metrics.dim() != 2 or metrics.shape[0] != spec.S:
        raise ValueError(f"metrics must be (S={spec.S}, B), got "
                         f"{tuple(metrics.shape)}")
    B = metrics.shape[1]
    if symbols.dim() != 3 or symbols.shape[0] != B \
            or symbols.shape[2] != spec.R:
        raise ValueError(f"symbols must be (B={B}, T, R={spec.R}), got "
                         f"{tuple(symbols.shape)}")
    if symbols.device != metrics.device:
        raise ValueError("metrics and symbols are on different devices")
    return B, symbols.shape[1]


def slot_scan(spec: StaticSpec, metrics: torch.Tensor,
              symbols: torch.Tensor, emit, phase0: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rotated schedule as plain torch ops over a loop on T (any S).

    metrics (S, B) int32 state order, symbols (B, T, R) int32.  The
    entry layout is age ``phase0``: slot p holds state rotl_n(p, phase0).
    ``emit(t, dbit)`` receives each step's (S, B) bool decisions in slot
    order.  Returns (metrics (S, B) int32 state order, acc (B,) int32).
    """
    B, T = symbols.shape[0], symbols.shape[1]
    n = spec.K - 1
    S = spec.S
    device = metrics.device
    bt = torch.as_tensor(np.asarray(spec.bt, dtype=np.int32),
                         device=device)                         # (R, S/2)
    pos = torch.arange(S, device=device)
    sym = symbols.to(torch.int32)
    perm_in = torch.as_tensor(_rotr(np.arange(S), -phase0, n), device=device)
    m = metrics.to(torch.int32)[perm_in]
    acc = torch.zeros(B, dtype=torch.int32, device=device)
    cap = spec.metric_max
    for t in range(T):
        phi = (phase0 + t) % n
        dist = 1 << ((n - 1 - phi) % n)
        odd = ((pos & dist) != 0)[:, None]                     # (S, 1)
        partner = m[pos ^ dist]
        # the step's (R, S) rows of _slot_bt, made on the device (the
        # whole (n, R, S) table is 0.5 GB at K=21 R=6)
        slot_bt = bt[:, _rotr(pos & ~dist, -phi, n)]
        bm = (slot_bt[:, :, None] - sym[:, t, :].t()[:, None, :]).abs()
        bm = bm.sum(dim=0, dtype=torch.int32)                 # (S, B)
        e_self = m + bm
        e_part = partner + (spec.max_error - bm)
        if spec.saturating:
            e_self = torch.clamp(e_self, max=cap)
            e_part = torch.clamp(e_part, max=cap)
            diff = e_part - e_self
            c_lo = diff <= 0      # SIMD tie -> predecessor 1
            c_hi = diff >= 0
        else:
            e_self = e_self & cap
            e_part = e_part & cap
            diff = e_self - e_part
            c_lo = diff > 0       # scalar tie -> predecessor 0
            c_hi = diff < 0
        nm = torch.where(odd, torch.where(c_hi, e_self, e_part),
                         torch.where(c_lo, e_part, e_self))
        dbit = torch.where(odd, c_hi, c_lo)
        # renorm: state 0 is slot 0 at every phase
        gate = nm[0] >= spec.renorm_threshold
        mins = nm.amin(dim=0)
        sub = torch.where(gate, mins, torch.zeros_like(mins))
        m = nm - sub[None, :]
        acc = acc + sub
        emit(t, dbit)
    perm = torch.as_tensor(_rotr(np.arange(S), phase0 + T, n), device=device)
    return m[perm], acc


def acs_rotated_ref(spec: StaticSpec, metrics: torch.Tensor,
                    symbols: torch.Tensor, out: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`acs_rotated`, on any device."""
    B, T = _check(spec, metrics, symbols)
    packed = rows_out(spec, metrics, T, out)

    def emit(t, dbit):
        packed[t] = pack_bits(dbit)      # slot p -> bit p%32 of word p>>5

    m, acc = slot_scan(spec, metrics, symbols, emit)
    return m, packed, acc


@spec_cache
def _gmask(spec: StaticSpec) -> tuple:
    """Per-rate tap masks whose parity rebuilds ``spec.bt``:
    bt[r][h] = parity((h << 1) & g[r]) ? high : low.  Only taps 1..K-2
    reach the table; they are read off its single-bit half-states and
    the whole table is checked against them."""
    bt = np.asarray(spec.bt, dtype=np.int64)             # (R, H)
    H = spec.H
    g = [sum(1 << i for i in range(1, spec.K - 1)
             if bt[r, 1 << (i - 1)] == spec.soft_high)
         for r in range(spec.R)]
    h = np.arange(H, dtype=np.int64) << 1
    for r in range(spec.R):
        par = np.zeros(H, np.int64)
        for i in range(1, spec.K - 1):
            if (g[r] >> i) & 1:
                par ^= (h >> i) & 1
        want = np.where(par == 1, spec.soft_high, spec.soft_low)
        if not np.array_equal(want, bt[r]):
            raise ValueError("branch table is not the parity table of a "
                             "code with these soft levels; the kernel "
                             "computes branch values from the taps")
    return tuple(g)


def _parity(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.int64)
    p = np.zeros_like(x)
    while x.any():
        p ^= x & 1
        x = x >> 1
    return p


def _branch_pattern(spec: StaticSpec, h: np.ndarray) -> np.ndarray:
    """R-bit branch patterns of half-states ``h``: bit r is
    parity((h << 1) & g[r]), set where rate r expects the high level (see
    :func:`_gmask`)."""
    out = np.zeros(np.shape(h), np.int64)
    for r, gr in enumerate(_gmask(spec)):
        out |= _parity((np.asarray(h, np.int64) << 1) & gr) << r
    return out


@functools.lru_cache(maxsize=64)
def _warp_patterns(spec: StaticSpec) -> Tuple[np.ndarray, np.ndarray]:
    """Branch-pattern tables of the warp design: (apat (n, 32), cpat
    (n, S/32)) int32.

    Slot p = l + 32k at phase phi has half-state h = rotl_n(p & ~dist, phi)
    and expects the high level on rate r where parity((h << 1) & g[r]) is
    1 (see :func:`_gmask`); bit r of its pattern is that parity.  Since the
    rotation permutes bits and the parity is linear, the pattern is
    ``apat[phi][l] ^ cpat[phi][k]``: a per-lane and a per-register part."""
    n = spec.K - 1
    lanes = np.arange(32, dtype=np.int64)
    regs = 32 * np.arange(spec.S // 32, dtype=np.int64)
    apat = np.zeros((n, 32), np.int32)
    cpat = np.zeros((n, spec.S // 32), np.int32)
    for phi in range(n):
        dist = 1 << (n - 1 - phi)
        apat[phi] = _branch_pattern(spec, _rotr(lanes & ~dist, -phi, n))
        cpat[phi] = _branch_pattern(spec, _rotr(regs & ~dist, -phi, n))
    return apat, cpat


@functools.lru_cache(maxsize=64)
def _launch_tables(spec: StaticSpec) -> tuple:
    """What the launcher takes from the host for a spec, made once: the tap
    masks (a ctypes array), the pointers to the warp design's pattern
    tables (None for the block design) and the tables themselves."""
    g = (ctypes.c_int * spec.R)(*_gmask(spec))
    if kernel_design(spec.S, spec.R) != "warp":
        return g, None, None, None
    tables = _warp_patterns(spec)
    return g, tables[0].ctypes.data, tables[1].ctypes.data, tables


# vdt_rotated_acs's parameters, the stream last
_PARAMS = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4
             + (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 6
             + (ctypes.c_void_p,))


def acs_rotated(spec: StaticSpec, metrics: torch.Tensor,
                symbols: torch.Tensor, out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run T rotated ACS steps; see the module docstring for the contract.

    ``out``: an optional contiguous (T, W, B) int32 tensor that receives
    the decision rows (and is returned as ``packed``), e.g. a slice of a
    decoder's row buffer.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (``csrc/rotated_acs.cu``) or raise."""
    with trace.span("ops.rotated_acs"):
        B, T = _check(spec, metrics, symbols)
        if metrics.device.type == "cpu":
            return acs_rotated_ref(spec, metrics, symbols, out)
        if metrics.device.type != "cuda":
            raise ValueError(f"unsupported device {metrics.device}")
        _build.check_cuda(metrics=metrics, symbols=symbols)
        if spec.R > KERNEL_MAX_RATE:
            raise ValueError(f"the CUDA rotated ACS takes R <= "
                             f"{KERNEL_MAX_RATE}, got R={spec.R}")
        if B == 0:
            raise ValueError("empty batch")
        fn = _build.kernel("rotated_acs", "vdt_rotated_acs", _PARAMS)
        g, apat, cpat, _ = _launch_tables(spec)
        m_out = torch.empty_like(metrics)
        packed = rows_out(spec, metrics, T, out)
        acc = torch.empty(B, dtype=torch.int32, device=metrics.device)
        _build.launch(fn, "rotated_acs", metrics.device, metrics.data_ptr(),
                      symbols.data_ptr(), m_out.data_ptr(), packed.data_ptr(),
                      acc.data_ptr(), B, T, spec.K, spec.R,
                      ctypes.cast(g, ctypes.c_void_p), apat, cpat,
                      spec.soft_high, spec.soft_low, spec.max_error,
                      spec.metric_max, spec.renorm_threshold,
                      int(spec.saturating))
        return m_out, packed, acc
