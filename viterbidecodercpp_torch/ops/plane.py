"""Plane ACS and plane walks for big state counts, S >= 8192 (the port of
the JAX package's ``ops/bigstate_pallas.py``).

Each frame's S = 2**(K-1) metrics form a plane of S/128 rows x 128
lanes.  The ACS is the rotated in-place schedule of ops/rotated.py
(logical state s at slot rotr_n(s, t) after t steps, partner p ^ 2^j
at phase phi, j = (n-1-phi) mod n, renorm gated on slot 0); what
differs is the layout of the decision bits, which is the JAX plane
layout so that checkpoints interchange byte for byte:

    slot q is plane row q >> 7, lane q & 127; its decision bit is bit
    (q >> 7) & 31 of word [b, t, (q >> 7) >> 5, q & 127]

of a frame-major (B, T, WRr, 128) int32 tensor, WRr = S / 4096.  Row i
of a call is written at age phase0 + i and walks with rotation
(phase0 + i + 1) mod n; the decoder always calls with phase0 = 0 and
records each chunk's rotations in ``DecoderState.row_rots``.

Public functions, each with the contract of its JAX namesake:

  * :func:`acs_plane` (kernel ``csrc/plane_acs.cu`` up to K=19 and
    ``csrc/plane_acs_global.cu`` above, both fed the branch-pattern table
    of ``_plane_patterns``; the latter's grid from :func:`global_grid`),
    plain version :func:`acs_plane_ref`;
  * :func:`walk_plane_frames` (kernel ``csrc/plane_walk.cu``), plain
    version :func:`walk_plane_frames_ref`, and :func:`chainback_plane`
    on top of it;
  * :func:`chainback_plane_truncated` (kernel
    ``csrc/plane_walk_trunc.cu``), plain version
    :func:`chainback_plane_truncated_ref`;
  * :func:`walk_plane`, the time-major walk (plain only: an XLA scan in
    the JAX package), and :func:`decode_big_plane`.

A public function runs the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.  The TPU geometry knobs of the
JAX functions (frame groups, chunks per block, fast_bm, interpret,
metric_dtype) have no counterpart; ``keep_padding``'s job - no
decision-buffer-sized temporary - is done by ``out``/``row0``, which
let the ACS write its rows straight into a caller's buffer.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from .. import trace
from . import _build, rotated
from .torch_core import (KERNEL_MAX_RATE, MAX_LANE_STATES, StaticSpec,
                         spec_cache, symmetric_amplitude, wrap_int32)

__all__ = ["supports", "acs_kernel", "time_block_rows", "global_grid",
           "acs_plane", "acs_plane_ref", "walk_plane", "walk_plane_frames",
           "walk_plane_frames_ref", "chainback_plane",
           "chainback_plane_truncated", "chainback_plane_truncated_ref",
           "decode_big_plane", "MAX_CLUSTER_STATES", "GLOBAL_TILE",
           "KERNELS", "ACTIVE_CLUSTERS", "RESIDENT_BLOCKS"]

COLS = 128          # lanes per plane row
LANE_BITS = 7
WALK_SLAB = 8       # the truncated walk's block and overlap are multiples

# The ACS kernels by state count.  csrc/plane_acs.cu keeps one frame's
# int32 metrics in shared memory: one block up to S = 32768 (K=16,
# 128 KB), a cluster of S / 32768 blocks (2, 4 or 8) up to S = 262144
# (K=19, 1 MB).  csrc/plane_acs_global.cu keeps them in global memory,
# one persistent kernel a call, above that (its C entry refuses K > 31).
MAX_CLUSTER_STATES = 1 << 18
# slots of one frame a block of the global-metric kernel steps at once
GLOBAL_TILE = 1 << 13

# The kernels the public wrappers launch, each launch counted as the
# counter ``launches.<kernel>`` of ``viterbidecodercpp_torch.trace``
KERNELS = ("plane_acs", "plane_acs_global", "plane_walk", "plane_walk_trunc")
# each launcher's parameters, the stream last
_PARAMS = {
    "plane_acs": ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4
                  + (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 9
                  + (ctypes.c_void_p,)),
    "plane_acs_global": ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 4
                         + (ctypes.c_void_p,) + (ctypes.c_int,) * 11
                         + (ctypes.c_void_p,)),
    "plane_walk": (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (
        ctypes.c_void_p,),
    "plane_walk_trunc": (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6 + (
        ctypes.c_void_p,),
}
# cudaOccupancyMaxActiveClusters of each cluster configuration the ACS has
# launched, keyed (device index, K, R, saturating); queried before its
# first launch
ACTIVE_CLUSTERS: dict = {}
# blocks of the global-metric kernel a card holds at once
# (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), keyed (device
# index, K, R, saturating); queried before its first launch
RESIDENT_BLOCKS: dict = {}


def supports(spec: StaticSpec) -> bool:
    """True for the plane class: S > 4096 with whole 32-row word rows
    (the JAX gate, with no upper bound)."""
    if spec.S <= MAX_LANE_STATES or spec.S % COLS:
        return False
    return (spec.S // COLS) // 32 >= 1


def acs_kernel(spec: StaticSpec) -> str:
    """The CUDA ACS kernel that serves ``spec`` (by K alone):
    ``"plane_acs"`` (a block or a cluster, K <= 19) or
    ``"plane_acs_global"`` (K >= 20)."""
    _check_spec(spec)
    return "plane_acs" if spec.S <= MAX_CLUSTER_STATES else \
        "plane_acs_global"


def time_block_rows(spec: StaticSpec) -> int:
    """2 (K-1): a plane decision buffer's row count rounds up to it (the
    JAX kernel's time block), which fixes a checkpoint's buffer shape."""
    return 2 * (spec.K - 1)


def _word_rows(spec: StaticSpec) -> int:
    return (spec.S // COLS) // 32


def _check_spec(spec: StaticSpec) -> None:
    if not supports(spec):
        raise ValueError(f"the plane class covers S > {MAX_LANE_STATES}, "
                         f"got S={spec.S}")


def _kernel(name: str):
    """The launcher of kernel ``name``, ``vdt_<name>``, bound once."""
    return _build.kernel(name, "vdt_" + name, _PARAMS[name])


def _check_clusters(spec: StaticSpec, dev: torch.device) -> None:
    """Before the first launch of a cluster configuration (K >= 17) on a
    card: query cudaOccupancyMaxActiveClusters, print it and raise if the
    card can place none."""
    key = (dev.index, spec.K, spec.R, bool(spec.saturating))
    if spec.S <= 1 << 15 or key in ACTIVE_CLUSTERS:
        return
    fn = _build.kernel("plane_acs", "vdt_plane_acs_clusters",
                       (ctypes.c_int,) * 3 + (ctypes.c_void_p,))
    out = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = fn(spec.K, spec.R, int(spec.saturating), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"plane_acs cluster query failed: CUDA error {err}")
    blocks = spec.S >> 15
    print(f"plane_acs: K={spec.K} R={spec.R} on cuda:{dev.index}: clusters "
          f"of {blocks} blocks, cudaOccupancyMaxActiveClusters = "
          f"{out.value}", file=sys.stderr, flush=True)
    if out.value == 0:
        raise RuntimeError(f"the card places no cluster of {blocks} "
                           f"1024-thread blocks with 128 KB of shared "
                           f"memory each (K={spec.K})")
    ACTIVE_CLUSTERS[key] = out.value


def global_grid(S: int, B: int, resident: int,
                tile: int = GLOBAL_TILE) -> Tuple[int, int]:
    """(grid, tiles_per_block) of the global-metric kernel for B frames
    of S slots, cut into (S / tile) B tiles, on a card that holds
    ``resident`` of its blocks at once.

    Block g steps the tiles_per_block consecutive tiles from g *
    tiles_per_block; tiles_per_block is the least power of two that
    brings the grid within ``resident`` (a cooperative launch places
    every block at once), so while it is at most S / tile a block's
    tiles belong to one frame."""
    if resident < 1:
        raise RuntimeError("the card holds no block of the global-metric "
                           "plane ACS")
    tiles = (S // tile) * B
    per = 1
    while -(-tiles // per) > resident:
        per *= 2
    return -(-tiles // per), per


def _check_global(spec: StaticSpec, dev: torch.device,
                  B: int) -> Tuple[int, int]:
    """The global-metric kernel's (grid, tiles_per_block) for B frames.
    Before the first launch of (device, K, R, regime): query the blocks
    the card holds at once, print them with the grid and raise if there
    are none."""
    key = (dev.index, spec.K, spec.R, bool(spec.saturating))
    if key in RESIDENT_BLOCKS:
        return global_grid(spec.S, B, RESIDENT_BLOCKS[key])
    fn = _build.kernel("plane_acs_global", "vdt_plane_acs_global_resident",
                       (ctypes.c_int,) * 2 + (ctypes.c_void_p,) * 2)
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = fn(spec.R, int(spec.saturating), ctypes.byref(per_sm),
                 ctypes.byref(sms))
    if err != 0:
        raise RuntimeError(f"plane_acs_global occupancy query failed: CUDA "
                           f"error {err}")
    resident = per_sm.value * sms.value
    grid = global_grid(spec.S, B, resident)
    print(f"plane_acs_global: K={spec.K} R={spec.R} on cuda:{dev.index}: "
          f"{per_sm.value} blocks an SM x {sms.value} SMs = {resident} "
          f"resident; B={B}: {(spec.S // GLOBAL_TILE) * B} tiles, grid "
          f"{grid[0]}, {grid[1]} tiles a block", file=sys.stderr, flush=True)
    RESIDENT_BLOCKS[key] = resident
    return grid


def _device_of(*tensors) -> torch.device:
    dev = tensors[0].device
    for x in tensors[1:]:
        if x is not None and x.device != dev:
            raise ValueError("inputs are on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# -- plane ACS -------------------------------------------------------------

def _acs_args(spec: StaticSpec, metrics, symbols, out, row0: int):
    """Validate the ACS inputs; returns (B, T, symbols, out)."""
    _check_spec(spec)
    if metrics.dim() != 2 or metrics.shape[0] != spec.S:
        raise ValueError(f"metrics must be (S={spec.S}, B), got "
                         f"{tuple(metrics.shape)}")
    B = metrics.shape[1]
    if symbols.dim() != 3 or symbols.shape[0] != B \
            or symbols.shape[2] != spec.R:
        raise ValueError(f"symbols must be (B={B}, T, R={spec.R}), got "
                         f"{tuple(symbols.shape)}")
    T = symbols.shape[1]
    dev = _device_of(metrics, symbols, out)
    # the JAX wrapper's default: symmetric {-A, +A} tables clamp symbols
    # to [-A, A] (its fast branch metric is exact only there)
    symbols = symbols.to(torch.int32)
    amp = symmetric_amplitude(spec)
    if amp is not None:
        symbols = torch.clamp(symbols, -amp, amp)
    WRr = _word_rows(spec)
    if out is None:
        if row0:
            raise ValueError("row0 needs an out buffer")
        out = torch.empty((B, T, WRr, COLS), dtype=torch.int32, device=dev)
    elif (out.dim() != 4 or out.shape[0] != B
          or tuple(out.shape[2:]) != (WRr, COLS)):
        raise ValueError(f"out must be (B={B}, rows, {WRr}, {COLS}), got "
                         f"{tuple(out.shape)}")
    if not 0 <= row0 <= out.shape[1] - T:
        raise ValueError(f"rows [{row0}, {row0 + T}) do not fit out's "
                         f"{out.shape[1]} rows")
    return B, T, symbols, out


def _acs_plain(spec, metrics, symbols, phase0, out, row0):
    WRr = _word_rows(spec)
    B = metrics.shape[1]
    shifts = torch.arange(32, dtype=torch.int64, device=metrics.device)

    def emit(t, dbit):
        # slot q = (wr*32 + k)*128 + lane -> bit k of word [wr, lane]
        d = dbit.to(torch.int64).reshape(WRr, 32, COLS, B)
        words = wrap_int32((d << shifts[None, :, None, None]).sum(dim=1))
        out[:, row0 + t] = words.permute(2, 0, 1)

    m, acc = rotated.slot_scan(spec, metrics, symbols, emit, phase0)
    return m, out[:, row0:row0 + symbols.shape[1]], acc


@spec_cache
def _plane_patterns(spec: StaticSpec) -> np.ndarray:
    """(n, 32) int32 register parts of the kernel's branch patterns.

    Slot q = (wr << 12) | (k << 7) | lane at phase phi has half-state
    h = rotl_n(q & ~2^j, phi).  Its thread part (wr << 12) | lane and its
    register part k << 7 are disjoint bits, the rotation permutes bits
    and the parity is linear, so its pattern is the xor of
    ``rotated._branch_pattern`` of rotl_n(thread part & ~2^j, phi), which
    the kernel computes once a step per thread, and kpat[phi][k]."""
    n = spec.K - 1
    regs = np.arange(32, dtype=np.int64) << LANE_BITS
    kpat = np.zeros((n, 32), np.int32)
    for phi in range(n):
        dist = 1 << (n - 1 - phi)
        kpat[phi] = rotated._branch_pattern(
            spec, rotated._rotr(regs & ~dist, -phi, n))
    return kpat


@spec_cache
def _device_patterns(spec: StaticSpec, dev: torch.device) -> torch.Tensor:
    """:func:`_plane_patterns` on the card, for the global-metric kernel
    (its (n, 32) table outgrows a kernel's parameters at large n)."""
    return torch.as_tensor(_plane_patterns(spec), device=dev)


def acs_plane_ref(spec: StaticSpec, metrics: torch.Tensor,
                  symbols: torch.Tensor, *, phase0: int = 0,
                  out: Optional[torch.Tensor] = None, row0: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`acs_plane`, on any device."""
    _, _, symbols, out = _acs_args(spec, metrics, symbols, out, row0)
    return _acs_plain(spec, metrics, symbols, int(phase0) % (spec.K - 1),
                      out, row0)


def acs_plane(spec: StaticSpec, metrics: torch.Tensor, symbols: torch.Tensor,
              *, phase0: int = 0, out: Optional[torch.Tensor] = None,
              row0: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Big-state ACS (the contract of ``acs_plane_pallas``).

    metrics (S, B) int32 state order, symbols (B, T, R) int32 ->
    (metrics (S, B) int32 state order, packed (B, T, WRr, 128) int32
    slot-order words, acc (B,) int32).  ``phase0`` is the layout age at
    entry (row i walks with rotation (phase0 + i + 1) mod n).  With
    ``out`` (B, rows, WRr, 128) int32 the rows go to out[:, row0:row0+T]
    and ``packed`` is that view; rows outside it are not touched.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    of :func:`acs_kernel` - ``csrc/plane_acs.cu`` up to K=19 (a cluster
    of S/32768 blocks from K=17), ``csrc/plane_acs_global.cu`` above (one
    cooperative launch of :func:`global_grid`'s blocks) - or raise.
    """
    with trace.span("ops.plane_acs" if spec.S <= MAX_CLUSTER_STATES
                    else "ops.plane_acs_global"):
        return _acs_plane(spec, metrics, symbols, phase0, out, row0)


def _acs_plane(spec, metrics, symbols, phase0, out, row0):
    B, T, symbols, out = _acs_args(spec, metrics, symbols, out, row0)
    phase0 = int(phase0) % (spec.K - 1)
    if metrics.device.type == "cpu":
        return _acs_plain(spec, metrics, symbols, phase0, out, row0)
    _build.check_cuda(metrics=metrics, out=out)
    if spec.R > KERNEL_MAX_RATE:
        raise ValueError(f"the CUDA plane ACS takes R <= {KERNEL_MAX_RATE}, "
                         f"got R={spec.R}")
    if B == 0:
        raise ValueError("empty batch")
    dev = metrics.device
    symbols = symbols.contiguous()
    g = (ctypes.c_int * spec.R)(*rotated._gmask(spec))
    m_out = torch.empty_like(metrics)
    acc = torch.empty(B, dtype=torch.int32, device=dev)
    tail = (spec.soft_high, spec.soft_low, spec.max_error, spec.metric_max,
            spec.renorm_threshold, int(spec.saturating), phase0,
            out.shape[1], row0)
    if acs_kernel(spec) == "plane_acs":
        _check_clusters(spec, dev)
        _build.launch(_kernel("plane_acs"), "plane_acs", dev,
                      metrics.data_ptr(), symbols.data_ptr(),
                      m_out.data_ptr(), out.data_ptr(), acc.data_ptr(), B, T,
                      spec.K, spec.R, ctypes.cast(g, ctypes.c_void_p),
                      _plane_patterns(spec).ctypes.data, *tail)
    else:
        grid, per_block = _check_global(spec, dev, B)
        # the two metric buffers and the renorm cells (mins and slot-0
        # values of three steps, the totals)
        scratch = torch.empty(2 * B * spec.S + 7 * B, dtype=torch.int32,
                              device=dev)
        _build.launch(_kernel("plane_acs_global"), "plane_acs_global", dev,
                      metrics.data_ptr(), symbols.data_ptr(),
                      m_out.data_ptr(), out.data_ptr(), acc.data_ptr(),
                      scratch.data_ptr(),
                      _device_patterns(spec, dev).data_ptr(), B, T, spec.K,
                      spec.R, ctypes.cast(g, ctypes.c_void_p), *tail, grid,
                      per_block)
    return m_out, out[:, row0:row0 + T], acc


def _global_steps(spec: StaticSpec, metrics: torch.Tensor,
                  symbols: torch.Tensor, *, phase0: int = 0,
                  resident: int = 1 << 30, tile: int = GLOBAL_TILE
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """csrc/plane_acs_global.cu's schedule in plain torch, for the tests;
    returns what :func:`acs_plane` returns.

    The grid of ``global_grid(S, B, resident, tile)``; at each step every
    block steps its tiles in order, subtracting the renorm the step
    before left in the rotating cells (cell t-1 read, cell t folded with
    the tiles' minima and frame b's slot-0 value, cell t+1 reset by the
    tile that holds slot 0) before the add and the clamp; branch metrics
    from the kernel's patterns (thread part xor ``_plane_patterns``)."""
    B, T, symbols, packed = _acs_args(spec, metrics, symbols, None, 0)
    n, S, R = spec.K - 1, spec.S, spec.R
    phase0 = int(phase0) % n
    grid, per = global_grid(S, B, resident, tile)
    tpf = S // tile
    top = torch.iinfo(torch.int32).max
    q = np.arange(S)
    buf = [metrics.to(torch.int32)[rotated._rotr(q, -phase0, n)].t()
           .contiguous(), torch.empty((B, S), dtype=torch.int32)]
    mins = torch.full((3, B), top, dtype=torch.int32)
    mins[2] = 0
    slot0s = torch.zeros((3, B), dtype=torch.int32)
    acc = torch.zeros(B, dtype=torch.int32)
    kpat = _plane_patterns(spec)
    shifts = torch.arange(32, dtype=torch.int64)
    for t in range(T):
        phi = (phase0 + t) % n
        dist = 1 << (n - 1 - phi)
        tb = q & ~(31 << LANE_BITS)
        pat = rotated._branch_pattern(spec, rotated._rotr(tb & ~dist, -phi,
                                                          n)) \
            ^ kpat[phi][(q >> LANE_BITS) & 31]
        high = torch.as_tensor((pat[None, :] >> np.arange(R)[:, None]) & 1,
                               dtype=torch.bool)                   # (R, S)
        sv = symbols[:, t, :]
        dl = (spec.soft_low - sv).abs()[:, :, None]
        dh = (spec.soft_high - sv).abs()[:, :, None]
        bm_all = torch.where(high[None], dh, dl).sum(dim=1,
                                                     dtype=torch.int32)
        cur, nxt = buf[t & 1], buf[(t + 1) & 1]
        part_all = cur[:, torch.as_tensor(q ^ dist)]
        odd_all = torch.as_tensor((q & dist) != 0)
        cell, prev = t % 3, (t + 2) % 3
        dbit = torch.empty((B, S), dtype=torch.bool)
        for g in range(grid):
            for i in range(g * per, min((g + 1) * per, tpf * B)):
                b, lo = divmod(i, tpf)
                qs = slice(lo * tile, (lo + 1) * tile)
                sub = torch.where(slot0s[prev, b] >= spec.renorm_threshold,
                                  mins[prev, b], 0).to(torch.int32)
                bm = bm_all[b, qs]
                e_self = cur[b, qs] - sub + bm
                e_part = part_all[b, qs] - sub + (spec.max_error - bm)
                if spec.saturating:
                    e_self = torch.clamp(e_self, max=spec.metric_max)
                    e_part = torch.clamp(e_part, max=spec.metric_max)
                    c_lo = e_part - e_self <= 0
                    c_hi = e_part - e_self >= 0
                else:
                    e_self = e_self & spec.metric_max
                    e_part = e_part & spec.metric_max
                    c_lo = e_self - e_part > 0
                    c_hi = e_self - e_part < 0
                odd = odd_all[qs]
                ch = torch.where(odd, c_hi, c_lo)
                nm = torch.where(ch != odd, e_part, e_self)
                nxt[b, qs] = nm
                dbit[b, qs] = ch
                mins[cell, b] = torch.minimum(mins[cell, b], nm.min())
                if lo == 0:
                    slot0s[cell, b] = nm[0]
                    mins[(t + 1) % 3, b] = top
                    acc[b] += sub
        d = dbit.to(torch.int64).reshape(B, S // 4096, 32, COLS)
        packed[:, t] = wrap_int32((d << shifts[None, None, :, None])
                                  .sum(dim=2))
    fin = buf[T & 1]
    sub = torch.where(slot0s[(T + 2) % 3] >= spec.renorm_threshold,
                      mins[(T + 2) % 3], 0).to(torch.int32)
    m_out = torch.empty((S, B), dtype=torch.int32)
    m_out[rotated._rotr(q, -((phase0 + T) % n), n)] = (fin - sub[:, None]).t()
    return m_out, packed, acc + sub


# -- exact walks -----------------------------------------------------------

def _plane_bit(spec: StaticSpec, flat: torch.Tensor, row: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """Decision bit of slot ``q`` in row ``row`` of each frame; ``flat``
    is (B, rows * W) int32, ``row``/``q`` are (B, ...) int."""
    qrow = q >> LANE_BITS
    idx = row.to(torch.int64) * spec.W + ((qrow >> 5) << LANE_BITS) \
        + (q & (COLS - 1))
    word = flat.gather(1, idx.reshape(flat.shape[0], -1)).reshape(q.shape)
    return (word >> (qrow & 31)) & 1


def _rot_q(state: torch.Tensor, rot, n: int) -> torch.Tensor:
    return ((state >> rot) | (state << (n - rot))) & ((1 << n) - 1)


def _walk_args(spec, packed, start, rots, valid, rows):
    _check_spec(spec)
    if packed.dim() != 4 or tuple(packed.shape[2:]) != (_word_rows(spec),
                                                         COLS):
        raise ValueError(f"packed must be (B, T, {_word_rows(spec)}, "
                         f"{COLS}), got {tuple(packed.shape)}")
    B = packed.shape[0]
    if tuple(start.shape) != (B,):
        raise ValueError(f"start state must be ({B},), got "
                         f"{tuple(start.shape)}")
    for name, x in (("rots", rots), ("valid", valid)):
        if x is not None and (x.dim() != 1 or x.shape[0] < rows):
            raise ValueError(f"{name} must be 1-D with at least {rows} "
                             f"rows, got {tuple(x.shape)}")
    return _device_of(packed, start, rots, valid)


def _walk_plain(spec, packed, start, rows, rots, valid):
    n = spec.K - 1
    B = packed.shape[0]
    flat = packed.reshape(B, -1)
    state = start.to(torch.int32)
    bits = torch.empty((B, rows), dtype=torch.uint8, device=packed.device)
    for t in range(rows - 1, -1, -1):
        rot = rots[t].to(torch.int32) if rots is not None else (t + 1) % n
        d = _plane_bit(spec, flat, torch.full_like(state, t),
                       _rot_q(state, rot, n))
        bits[:, t] = d.to(torch.uint8)
        new_state = (state >> 1) | (d << (n - 1))
        if valid is not None:
            new_state = torch.where(valid[t] != 0, new_state, state)
        state = new_state
    return bits


def _walk_groups(spec, packed, start, lo, hi, rots, valid, group):
    """The walk kernels' group step (csrc/plane_walk_group.cuh, which
    fixes ``group`` at 5) in plain torch, for the tests: the same
    candidate nodes and resolve.

    Chain (b, c) walks rows [lo[c], hi[c]) of frame b from start[b, c];
    returns (B, C, rows) uint8 bits, 0 outside each chain's rows.  Node
    x = 2^j - 1 + i of a group with top row t0 (heap order) is row t0 - j
    under path bits i, row t0's highest; every node's word is read, then
    the rows resolve down the tree, x <- 2x + 1 + bit x."""
    n = spec.K - 1
    B, rows = packed.shape[:2]
    dev = packed.device
    flat = packed.reshape(B, -1)
    C = lo.shape[0]
    x = np.arange((1 << group) - 1)
    nj = np.array([int(v + 1).bit_length() - 1 for v in x])
    j = torch.as_tensor(nj, device=dev)
    i = torch.as_tensor(x + 1 - (1 << nj), device=dev)
    if rots is None:
        rots = (torch.arange(rows, device=dev) + 1) % n
    rots = rots.to(torch.int64)
    ok = (torch.ones(rows, dtype=torch.bool, device=dev) if valid is None
          else valid[:rows] != 0)
    s = start.to(torch.int64).clone()                            # (B, C)
    bits = torch.zeros((B, C, rows), dtype=torch.uint8, device=dev)
    groups = int(((hi - lo).clamp(min=0) + group - 1).div(
        group, rounding_mode="floor").max())
    for g in range(groups):
        top = hi - 1 - g * group                                 # (C,)
        left = (top - lo + 1).clamp(0, group)
        # each node's state: its j path bits through the valid rows above
        sc = s[:, :, None].expand(B, C, len(x))
        for m in range(group - 1):
            app = (m < j)[None, :] & ok[(top - m).clamp(0, rows - 1)][:, None]
            bit = (i >> (j - 1 - m).clamp(min=0)) & 1
            sc = torch.where(app, (sc >> 1) | (bit << (n - 1)), sc)
        r = (top[:, None] - j[None, :]).clamp(0, rows - 1)       # (C, nodes)
        d = _plane_bit(spec, flat, r.expand(B, C, len(x)),
                       _rot_q(sc, rots[r], n))                   # (B, C, nodes)
        # resolve down the tree: row t0 - m takes node x's bit
        node = torch.zeros((B, C), dtype=torch.int64, device=dev)
        for m in range(group):
            live = (m < left)[None, :]
            dm = d.gather(2, node[..., None])[..., 0]
            node = torch.where(live, 2 * node + 1 + dm, node)
            t = (top - m).clamp(0, rows - 1)
            s = torch.where(live & ok[t][None, :],
                            (s >> 1) | (dm << (n - 1)), s)
            idx = t[None, :, None].expand(B, C, 1)
            bits.scatter_(2, idx, torch.where(live[..., None],
                                              dm[..., None].to(torch.uint8),
                                              bits.gather(2, idx)))
    return bits


def _trunc_groups(spec, packed, end_state, total_bits, rots, L, O, group):
    """:func:`chainback_plane_truncated` on :func:`_walk_groups`, for the
    tests: the kernel's tiles, start states and commit rule."""
    n = spec.K - 1
    total_rows = total_bits + n
    NB = -(-total_rows // L)
    lo = torch.arange(NB, device=packed.device) * L
    start = torch.where((lo + L + O >= total_rows)[None, :],
                        end_state.to(torch.int64)[:, None], 0)
    bits = _walk_groups(spec, packed, start, lo,
                        (lo + L + O).clamp(max=total_rows), rots, None, group)
    r = torch.arange(packed.shape[1], device=packed.device)
    commit = (r[None, :] >= lo[:, None]) & (r[None, :] < lo[:, None] + L)
    return (bits * commit).sum(dim=1).to(torch.uint8)[:, n:total_rows]


def _walk(spec, packed, start, rows, rots, valid, plain):
    dev = _walk_args(spec, packed, start, rots, valid, rows)
    if plain or dev.type == "cpu":
        return _walk_plain(spec, packed, start, rows, rots, valid)
    _build.check_cuda(packed=packed, start=start, rots=rots, valid=valid)
    B = packed.shape[0]
    if B == 0:
        raise ValueError("empty batch")
    bits = torch.empty((B, rows), dtype=torch.uint8, device=dev)
    _build.launch(_kernel("plane_walk"), "plane_walk", dev, packed.data_ptr(),
                  start.data_ptr(),
                  rots.data_ptr() if rots is not None else None,
                  valid.data_ptr() if valid is not None else None,
                  bits.data_ptr(), rows, packed.shape[1], B, spec.K)
    return bits


def walk_plane_frames(spec: StaticSpec, packed: torch.Tensor,
                      start_state: torch.Tensor, *,
                      rots: Optional[torch.Tensor] = None,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Walk frame-major slot-order rows newest to oldest (the contract of
    ``walk_plane_frames``): packed (B, N, WRr, 128) int32, start_state
    (B,) int32 -> (B, N) uint8 per-row path bits.

    Row t reads slot q = rotr_n(s, rots[t]) (default (t + 1) mod n);
    s <- (s >> 1) | (d << (n-1)) unless valid[t] == 0, where the row
    emits its bit and keeps the state.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/plane_walk.cu`` or raise.
    """
    with trace.span("ops.plane_walk"):
        return _walk(spec, packed, start_state, packed.shape[1], rots, valid,
                     plain=False)


def walk_plane_frames_ref(spec: StaticSpec, packed: torch.Tensor,
                          start_state: torch.Tensor, *,
                          rots: Optional[torch.Tensor] = None,
                          valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain version of :func:`walk_plane_frames`, on any device."""
    return _walk(spec, packed, start_state, packed.shape[1], rots, valid,
                 plain=True)


def chainback_plane(spec: StaticSpec, packed: torch.Tensor,
                    end_state: torch.Tensor, total_bits: int,
                    rots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact traceback over (B, T, WRr, 128) slot-order rows, T >=
    total_bits + K - 1 (later rows are ignored); (B, total_bits) uint8.

    Walks rows [0, total_bits + n) from ``end_state`` and returns rows
    [n, n + total_bits): what the JAX version gets by walking the whole
    buffer with the rows past that range invalid."""
    n = spec.K - 1
    if packed.dim() == 4 and packed.shape[1] < total_bits + n:
        raise ValueError(f"decision history has {packed.shape[1]} rows < "
                         f"total_bits + K - 1 = {total_bits + n}")
    with trace.span("ops.plane_walk"):
        bits = _walk(spec, packed, end_state, total_bits + n, rots, None,
                     plain=False)
    return bits[:, n:]


def walk_plane(spec: StaticSpec, rows: torch.Tensor, end_state: torch.Tensor,
               *, rots=None, valid=None) -> torch.Tensor:
    """Time-major slot-order walk (the contract of ``walk_plane``, plain
    torch on any device): rows (N, WRr, 128, B) int32 -> (B, N) uint8.
    ``rots`` defaults to (i + 1) mod n, ``valid`` to all rows."""
    dev = rows.device
    if rots is not None:
        rots = torch.as_tensor(rots, dtype=torch.int32, device=dev)
    if valid is not None:
        valid = torch.as_tensor(valid, device=dev)
    return _walk_plain(spec, rows.permute(3, 0, 1, 2), end_state,
                       rows.shape[0], rots, valid)


# -- truncated walk --------------------------------------------------------

def _trunc_args(spec, packed, end_state, total_bits, rots, block, overlap):
    n = spec.K - 1
    total_rows = total_bits + n
    dev = _walk_args(spec, packed, end_state, rots, None, total_rows)
    if packed.shape[1] < total_rows:
        raise ValueError(f"decision history has {packed.shape[1]} rows < "
                         f"total_bits + K - 1 = {total_rows}")
    if block % WALK_SLAB or overlap % WALK_SLAB or block <= 0 or overlap < 0:
        raise ValueError("block and overlap must be multiples of 8 "
                         "(block > 0)")
    return dev


def _trunc_plain(spec, packed, end_state, total_bits, rots, L, O):
    n = spec.K - 1
    B = packed.shape[0]
    total_rows = total_bits + n
    NB = -(-total_rows // L)
    dev = packed.device
    flat = packed.reshape(B, -1)
    base = torch.arange(NB, device=dev) * L                    # (NB,)
    # tiles whose window reaches the stream's end start from end_state
    # (their walk is exact); the others start from 0 and converge over
    # the overlap rows
    exactish = (base + L + O >= total_rows)[None, :]
    state = torch.where(exactish, end_state.to(torch.int32)[:, None],
                        torch.zeros((B, NB), dtype=torch.int32, device=dev))
    committed = torch.zeros((B, NB, L), dtype=torch.uint8, device=dev)
    if rots is None:
        rots = (torch.arange(total_rows, device=dev) + 1) % n
    rots = rots.to(torch.int32)
    for i in range(L + O - 1, -1, -1):
        r = base + i
        ok = (r < total_rows)[None, :]
        rc = torch.clamp(r, max=total_rows - 1)
        rot = rots[rc][None, :]
        d = _plane_bit(spec, flat, rc[None, :].expand(B, NB),
                       _rot_q(state, rot, n))
        state = torch.where(ok, (state >> 1) | (d << (n - 1)), state)
        if i < L:
            committed[:, :, i] = d.to(torch.uint8)
    return committed.reshape(B, NB * L)[:, n:total_rows]


def chainback_plane_truncated(spec: StaticSpec, packed: torch.Tensor,
                              end_state: torch.Tensor, total_bits: int,
                              rots: Optional[torch.Tensor] = None,
                              block: int = 512, overlap: int = 128
                              ) -> torch.Tensor:
    """Block-parallel truncated traceback (the contract of
    ``chainback_plane_truncated``); (B, total_bits) uint8.

    The total_bits + n rows split into ``block``-row tiles that walk in
    parallel, each over its own block + ``overlap`` rows newest to
    oldest, committing its oldest ``block`` bits.  A tile whose window
    reaches the last row starts from ``end_state``, the others from 0;
    rows past the last are skipped.  With overlap >= ~10 K the bits equal
    the exact walk's with overwhelming probability.  CPU tensors take the
    plain version; CUDA tensors launch ``csrc/plane_walk_trunc.cu`` or
    raise.
    """
    with trace.span("ops.plane_walk_trunc"):
        dev = _trunc_args(spec, packed, end_state, total_bits, rots, block,
                          overlap)
        if dev.type == "cpu":
            return _trunc_plain(spec, packed, end_state, total_bits, rots,
                                block, overlap)
        _build.check_cuda(packed=packed, end_state=end_state, rots=rots)
        B = packed.shape[0]
        if B == 0:
            raise ValueError("empty batch")
        bits = torch.empty((B, total_bits), dtype=torch.uint8, device=dev)
        _build.launch(_kernel("plane_walk_trunc"), "plane_walk_trunc", dev,
                      packed.data_ptr(), end_state.data_ptr(),
                      rots.data_ptr() if rots is not None else None,
                      bits.data_ptr(), B, packed.shape[1], spec.K, total_bits,
                      block, overlap)
        return bits


def chainback_plane_truncated_ref(spec: StaticSpec, packed: torch.Tensor,
                                  end_state: torch.Tensor, total_bits: int,
                                  rots: Optional[torch.Tensor] = None,
                                  block: int = 512, overlap: int = 128
                                  ) -> torch.Tensor:
    """Plain version of :func:`chainback_plane_truncated`, on any
    device."""
    _trunc_args(spec, packed, end_state, total_bits, rots, block, overlap)
    return _trunc_plain(spec, packed, end_state, total_bits, rots, block,
                        overlap)


def decode_big_plane(spec: StaticSpec, metrics: torch.Tensor,
                     symbols: torch.Tensor, end_state: torch.Tensor,
                     total_bits: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """One-shot big-state decode on the plane path (the contract of
    ``decode_big_pallas``): (bits (B, total_bits) uint8, final metrics
    (S, B) state order, packed (B, T, WRr, 128), acc (B,))."""
    m, packed, acc = acs_plane(spec, metrics, symbols)
    bits = chainback_plane(spec, packed, end_state, total_bits)
    return bits, m, packed, acc
