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

  * :func:`acs_plane` (kernel ``csrc/plane_acs.cu``, fed the
    branch-pattern table of ``_plane_patterns``), plain version
    :func:`acs_plane_ref`;
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
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import rotated
from .torch_core import (KERNEL_MAX_RATE, MAX_LANE_STATES, StaticSpec,
                         symmetric_amplitude, wrap_int32)

__all__ = ["supports", "time_block_rows", "acs_plane", "acs_plane_ref",
           "walk_plane", "walk_plane_frames", "walk_plane_frames_ref",
           "chainback_plane", "chainback_plane_truncated",
           "chainback_plane_truncated_ref", "decode_big_plane",
           "MAX_PLANE_STATES", "LAUNCHES"]

COLS = 128          # lanes per plane row
LANE_BITS = 7
WALK_SLAB = 8       # the truncated walk's block and overlap are multiples

# The ACS kernel keeps one frame's int32 metrics in shared memory: up to
# S = 32768 (K=16, 128 KB) in one block, S = 65536 (K=17, 256 KB) split
# over a cluster of two; K=18 would need 512 KB.
MAX_PLANE_STATES = 65536

# Kernel launches by the public wrappers (reset and read by chip_smoke.py).
LAUNCHES = {"plane_acs": 0, "plane_walk": 0, "plane_walk_trunc": 0}


def supports(spec: StaticSpec) -> bool:
    """True for the plane class: S > 4096 with whole 32-row word rows
    (the JAX gate), up to the CUDA kernel's bound MAX_PLANE_STATES."""
    if spec.S <= MAX_LANE_STATES or spec.S % COLS:
        return False
    return (spec.S // COLS) // 32 >= 1 and spec.S <= MAX_PLANE_STATES


def time_block_rows(spec: StaticSpec) -> int:
    """2 (K-1): a plane decision buffer's row count rounds up to it (the
    JAX kernel's time block), which fixes a checkpoint's buffer shape."""
    return 2 * (spec.K - 1)


def _word_rows(spec: StaticSpec) -> int:
    return (spec.S // COLS) // 32


def _check_spec(spec: StaticSpec) -> None:
    if not supports(spec):
        raise ValueError(f"the plane kernels cover {MAX_LANE_STATES} < S <= "
                         f"{MAX_PLANE_STATES}, got S={spec.S}")


def _launch(name: str, symbol: str, argtypes, *args) -> None:
    from . import _build

    fn = getattr(_build.load(name), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _check_cuda(**tensors) -> None:
    for name, x in tensors.items():
        if x is not None and (x.dtype != torch.int32
                              or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 on CUDA, got "
                             f"{x.dtype}, contiguous={x.is_contiguous()}")


def _device_of(*tensors) -> torch.device:
    dev = tensors[0].device
    for x in tensors[1:]:
        if x is not None and x.device != dev:
            raise ValueError("inputs are on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _stream(dev: torch.device) -> int:
    with torch.cuda.device(dev):
        return torch.cuda.current_stream().cuda_stream


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


@functools.lru_cache(maxsize=64)
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

    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/plane_acs.cu`` or raise.
    """
    B, T, symbols, out = _acs_args(spec, metrics, symbols, out, row0)
    phase0 = int(phase0) % (spec.K - 1)
    if metrics.device.type == "cpu":
        return _acs_plain(spec, metrics, symbols, phase0, out, row0)
    _check_cuda(metrics=metrics, out=out)
    if spec.R > KERNEL_MAX_RATE:
        raise ValueError(f"the CUDA plane ACS takes R <= {KERNEL_MAX_RATE}, "
                         f"got R={spec.R}")
    if B == 0:
        raise ValueError("empty batch")
    symbols = symbols.contiguous()
    g = (ctypes.c_int * spec.R)(*rotated._gmask(spec))
    kpat = _plane_patterns(spec)
    m_out = torch.empty_like(metrics)
    acc = torch.empty(B, dtype=torch.int32, device=metrics.device)
    _launch("plane_acs", "vdt_plane_acs",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 2
            + [ctypes.c_int] * 9 + [ctypes.c_void_p],
            metrics.data_ptr(), symbols.data_ptr(), m_out.data_ptr(),
            out.data_ptr(), acc.data_ptr(), B, T, spec.K, spec.R,
            ctypes.cast(g, ctypes.c_void_p), kpat.ctypes.data, spec.soft_high,
            spec.soft_low, spec.max_error, spec.metric_max,
            spec.renorm_threshold, int(spec.saturating), phase0,
            out.shape[1], row0,
            _stream(metrics.device))
    return m_out, out[:, row0:row0 + T], acc


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
    _check_cuda(packed=packed, start=start, rots=rots, valid=valid)
    B = packed.shape[0]
    if B == 0:
        raise ValueError("empty batch")
    bits = torch.empty((B, rows), dtype=torch.uint8, device=dev)
    _launch("plane_walk", "vdt_plane_walk",
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
            packed.data_ptr(), start.data_ptr(),
            rots.data_ptr() if rots is not None else None,
            valid.data_ptr() if valid is not None else None,
            bits.data_ptr(), rows, packed.shape[1], B, spec.K, _stream(dev))
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
    dev = _trunc_args(spec, packed, end_state, total_bits, rots, block,
                      overlap)
    if dev.type == "cpu":
        return _trunc_plain(spec, packed, end_state, total_bits, rots,
                            block, overlap)
    _check_cuda(packed=packed, end_state=end_state, rots=rots)
    B = packed.shape[0]
    if B == 0:
        raise ValueError("empty batch")
    bits = torch.empty((B, total_bits), dtype=torch.uint8, device=dev)
    _launch("plane_walk_trunc", "vdt_plane_walk_trunc",
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
            packed.data_ptr(), end_state.data_ptr(),
            rots.data_ptr() if rots is not None else None, bits.data_ptr(),
            B, packed.shape[1], spec.K, total_bits, block, overlap,
            _stream(dev))
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
