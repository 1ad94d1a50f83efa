"""Batched traceback walk (the port of
the JAX package's ``ops/chainback_pallas.py``).

Every frame walks its packed decision rows newest to oldest with
``s <- (s >> 1) | (d << (K-2))``; row t carries data bit t - (K-1)
(viterbi_decoder_core.h:214-236).  With ``slot_order`` the rows came from
the rotated ACS (ops/rotated.py) and the walk un-rotates the state by each
row's rotation before it reads the bit: ``rots[t]`` when given
(``DecoderState.row_rots``: chunked updates restart the schedule per
chunk), else the one-shot schedule (t + 1) mod n.

:func:`chainback` and :func:`walk_rows` launch the CUDA kernel
(``csrc/chainback.cu``) for CUDA tensors and run the plain versions
(:func:`chainback_ref`, :func:`walk_rows_ref`) only for CPU tensors.  The
kernel has two designs, picked by :func:`walk_design` on the row width W:
tiles of whole rows prefetched ahead of the walk (W <= 8), or the walk
that loads the one word the state selects (wider rows).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import trace
from . import _build
from .torch_core import StaticSpec, _unpack_bit, needs_big_state

__all__ = ["chainback", "chainback_ref", "walk_rows", "walk_rows_ref",
           "walk_design", "TILED_MAX_WORDS"]

# Widest row (in int32 words) of the tiled walk (VDT_TILED_MAX_W in
# csrc/chainback.cu), a template on W in {1, 2, 4, 8}.
TILED_MAX_WORDS = 8


def walk_design(W: int) -> str:
    """The CUDA walk's design for rows of W words: ``"tiled"`` (all W
    words of a row loaded ahead of the walk, independent of the state) up
    to :data:`TILED_MAX_WORDS`, ``"chain"`` (the one word the state selects,
    loaded on the chain) above, where whole rows would read W times the
    words the walk needs."""
    if W < 1 or W & (W - 1):
        raise ValueError(f"rows are a power of two of words, got W={W}")
    return "tiled" if W <= TILED_MAX_WORDS else "chain"


def _check(spec: StaticSpec, packed: torch.Tensor, start: torch.Tensor,
           slot_order: bool, rots, valid, rows: int) -> None:
    if packed.dim() != 3 or packed.shape[1] != spec.W:
        raise ValueError(f"packed must be (T, W={spec.W}, B), got "
                         f"{tuple(packed.shape)}")
    B = packed.shape[2]
    if tuple(start.shape) != (B,):
        raise ValueError(f"start state must be ({B},), got "
                         f"{tuple(start.shape)}")
    if rots is not None and not slot_order:
        raise ValueError("rots is only meaningful with slot_order=True")
    if slot_order and needs_big_state(spec):
        raise ValueError("the slot_order walk covers S <= 4096; big-state "
                         "codes use the plane walk")
    for name, x in (("rots", rots), ("valid", valid)):
        if x is not None and (x.dim() != 1 or x.shape[0] < rows):
            raise ValueError(f"{name} must be 1-D with at least {rows} "
                             f"rows, got {tuple(x.shape)}")
    for x in (start, rots, valid):
        if x is not None and x.device != packed.device:
            raise ValueError("walk inputs are on different devices")


def _walk_ref(spec: StaticSpec, packed: torch.Tensor, start: torch.Tensor,
              rows: int, slot_order: bool, rots, valid) -> torch.Tensor:
    """(rows, B) uint8 path bits, plain torch ops over a loop on rows."""
    n = spec.K - 1
    smask = spec.S - 1
    B = packed.shape[2]
    state = start.to(torch.int32)
    bits = torch.empty((rows, B), dtype=torch.uint8, device=packed.device)
    for t in range(rows - 1, -1, -1):
        q = state
        if slot_order:
            rot = rots[t].to(torch.int32) if rots is not None \
                else (t + 1) % n
            q = ((state >> rot) | (state << (n - rot))) & smask
        d = _unpack_bit(spec, packed[t], q)
        bits[t] = d.to(torch.uint8)
        new_state = (state >> 1) | (d << (n - 1))
        if valid is not None:
            new_state = torch.where(valid[t] != 0, new_state, state)
        state = new_state
    return bits


# vdt_chainback's parameters, the stream last
_PARAMS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


def _walk_cuda(spec: StaticSpec, packed: torch.Tensor, start: torch.Tensor,
               rows: int, slot_order: bool, rots, valid) -> torch.Tensor:
    _build.check_cuda(packed=packed, start=start, rots=rots, valid=valid)
    B = packed.shape[2]
    if B == 0:
        raise ValueError("empty batch")
    fn = _build.kernel("chainback", "vdt_chainback", _PARAMS)
    bits = torch.empty((rows, B), dtype=torch.uint8, device=packed.device)
    _build.launch(fn, "chainback", packed.device, packed.data_ptr(),
                  start.data_ptr(),
                  rots.data_ptr() if rots is not None else None,
                  valid.data_ptr() if valid is not None else None,
                  bits.data_ptr(), rows, spec.W, B, spec.K, int(slot_order),
                  int(walk_design(spec.W) == "tiled"))
    return bits


def _walk(spec, packed, start, rows, slot_order, rots, valid, plain):
    _check(spec, packed, start, slot_order, rots, valid, rows)
    if plain or packed.device.type == "cpu":
        return _walk_ref(spec, packed, start, rows, slot_order, rots, valid)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    return _walk_cuda(spec, packed, start, rows, slot_order, rots, valid)


def _chainback(spec, packed, end_state, total_bits, slot_order, rots,
               plain, first_bit=0, n_bits=None):
    rows = total_bits + spec.K - 1
    if packed.dim() == 3 and packed.shape[0] < rows:
        raise ValueError("decision history shorter than total_bits + K - 1")
    if n_bits is None:
        n_bits = total_bits - first_bit
    if first_bit < 0 or n_bits < 0 or first_bit + n_bits > total_bits:
        raise ValueError(f"data bits [{first_bit}, {first_bit + n_bits}) "
                         f"lie outside [0, {total_bits})")
    # the walk stops at the oldest row it reads: row first_bit + K - 1 of
    # a later span, row 0 of the whole history
    lo = first_bit + spec.K - 1 if first_bit else 0
    if lo:
        if slot_order and rots is None:
            # the one-shot schedule of the whole history, before it is cut
            rots = torch.arange(1, rows + 1, dtype=torch.int32,
                                device=packed.device) % (spec.K - 1)
        packed = packed[lo:rows]
        rots = None if rots is None else rots[lo:rows]
    bits = _walk(spec, packed, end_state, rows - lo, slot_order, rots, None,
                 plain)
    skip = first_bit + spec.K - 1 - lo
    return bits[skip:skip + n_bits].t().contiguous()


def chainback(spec: StaticSpec, packed: torch.Tensor,
              end_state: torch.Tensor, total_bits: int, *,
              first_bit: int = 0, n_bits: Optional[int] = None,
              slot_order: bool = False,
              rots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Trace back (B, total_bits) uint8 data bits (the contract of
    ``chainback_pallas.chainback_pallas``).

    packed: (T, W, B) int32 decision rows with T >= total_bits + K - 1
    (later rows are ignored); end_state: (B,) int32 walk start states.
    ``first_bit``/``n_bits``: return only data bits [first_bit, first_bit
    + n_bits) (n_bits defaults to the rest); the walk still starts at row
    total_bits + K - 2 and stops at the oldest row it reads (a
    tail-biting frame's middle copy).
    ``slot_order``/``rots``: see the module docstring.
    """
    with trace.span("ops.chainback"):
        return _chainback(spec, packed, end_state, total_bits, slot_order,
                          rots, plain=False, first_bit=first_bit,
                          n_bits=n_bits)


def chainback_ref(spec: StaticSpec, packed: torch.Tensor,
                  end_state: torch.Tensor, total_bits: int, *,
                  slot_order: bool = False,
                  rots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`chainback`, on any device."""
    return _chainback(spec, packed, end_state, total_bits, slot_order, rots,
                      plain=True)


def walk_rows(spec: StaticSpec, packed: torch.Tensor,
              start_state: torch.Tensor, *, slot_order: bool = False,
              rots: Optional[torch.Tensor] = None,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw per-row walk (the contract of ``chainback_pallas.walk_rows``).

    packed: (N, W, B) int32 rows; start_state: (B,) int32.  Returns
    (N, B) uint8 path bits, row t carrying data bit t - (K-1), with no
    slicing.  A row with ``valid == 0`` emits its bit but leaves the walk
    state untouched (stream padding past the true end).
    """
    with trace.span("ops.chainback"):
        return _walk(spec, packed, start_state, packed.shape[0], slot_order,
                     rots, valid, plain=False)


def walk_rows_ref(spec: StaticSpec, packed: torch.Tensor,
                  start_state: torch.Tensor, *, slot_order: bool = False,
                  rots: Optional[torch.Tensor] = None,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`walk_rows`, on any device."""
    return _walk(spec, packed, start_state, packed.shape[0], slot_order,
                 rots, valid, plain=True)
