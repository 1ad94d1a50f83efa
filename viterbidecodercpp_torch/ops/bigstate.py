"""Rotated-layout one-shot decode for big state counts, plain torch (the
port of the JAX package's ``ops/bigstate.py``).

This is the JAX package's XLA path for S > 4096: ``ViterbiDecoder``
with ``backend="torch"`` decodes such codes through :func:`decode_big`.
Logical state s sits at slot ``rotr_n(s, t)`` after t steps (n = K-1),
so at phase phi = t mod n, j = (n-1-phi) mod n, the butterfly halves
are the slot pairs ``(p, p | 2^j)`` with bit j of p clear - strided
views, no gather - and new states 2h, 2h+1 land in place on p and
p | 2^j.  State 0 stays at slot 0, so the renormalisation gate is the
standard one.

Metrics ride compact between steps (uint8 or uint16 by the metric
width), as in the JAX version.  Decisions are packed in slot-pair
order ("i-order": lo slot p = a*2^(j+1) + b has index i = a*2^j + b and
its pair's bits sit at 2i, 2i+1), so the packed rows are
phase-dependent: read them with :func:`chainback_rotated`.  Everything
is bit-identical to the JAX functions.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import torch_core
from .torch_core import StaticSpec

__all__ = ["acs_scan_rotated", "chainback_rotated", "decode_big"]


def _rotr(x: np.ndarray, k: int, n: int) -> np.ndarray:
    """Rotate the low n bits of x right by k (any sign of k)."""
    k %= n
    mask = (1 << n) - 1
    return ((x >> k) | (x << (n - k))) & mask


def _phase_tables(spec: StaticSpec):
    """[(j, bt_perm (R, H) int32)] for phi = 0..n-1: the lo slots of
    phase phi in physical order are p = a*2^(j+1) + b (b < 2^j), slot
    index i = a*2^j + b, logical half-state h = rotl_n(p, phi)."""
    n = spec.K - 1
    bt = np.asarray(spec.bt, dtype=np.int32)          # (R, H) logical
    out = []
    for phi in range(n):
        j = (n - 1 - phi) % n
        i = np.arange(spec.H)
        a, b = i >> j, i & ((1 << j) - 1)
        p = (a << (j + 1)) | b
        out.append((j, bt[:, _rotr(p, -phi, n)]))
    return out


def _unrotate_perm(spec: StaticSpec, t: int) -> np.ndarray:
    """perm with m_logical[s] = m_phys[perm[s]] after t steps."""
    return _rotr(np.arange(spec.S), t, spec.K - 1)


def acs_scan_rotated(spec: StaticSpec, metrics: torch.Tensor,
                     symbols: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ACS over (B, T, R) symbols in the rotated layout.

    Same contract as :func:`torch_core.acs_scan` - metrics (S, B) int32
    in and out in state order, acc (B,) int32 - except that the packed
    (T, W, B) decision rows are in rotated i-order (consume them with
    :func:`chainback_rotated`).
    """
    n = spec.K - 1
    S, H = spec.S, spec.H
    B, T, R = symbols.shape
    device = metrics.device
    store_dt = torch.uint8 if spec.metric_max <= 0xFF else torch.uint16
    tables = [(j, torch.as_tensor(bt, device=device))
              for j, bt in _phase_tables(spec)]
    sym_t = symbols.to(torch.int32).permute(1, 2, 0)         # (T, R, B)
    m = metrics.to(store_dt)
    acc = torch.zeros(B, dtype=torch.int32, device=device)
    packed = torch.empty((T, spec.W, B), dtype=torch.int32, device=device)
    for t in range(T):
        j, btj = tables[t % n]
        mv = m.to(torch.int32).reshape(S >> (j + 1), 2, 1 << j, B)
        lo = mv[:, 0].reshape(H, B)
        hi = mv[:, 1].reshape(H, B)
        bm = (btj[:, :, None] - sym_t[t][:, None, :]).abs().sum(
            dim=0, dtype=torch.int32)                          # (H, B)
        new_lo, new_hi, dec0, dec1 = torch_core.acs_select(spec, lo, hi, bm)
        nm = torch.stack([new_lo.reshape(S >> (j + 1), 1 << j, B),
                          new_hi.reshape(S >> (j + 1), 1 << j, B)],
                         dim=1).reshape(S, B)
        nm, sub = torch_core._renormalise(spec, nm)
        acc = acc + sub
        m = nm.to(store_dt)
        packed[t] = torch_core.pack_decisions(spec, dec0, dec1)
    perm = torch.as_tensor(_unrotate_perm(spec, T), device=device)
    return m.to(torch.int32)[perm], packed, acc


def chainback_rotated(spec: StaticSpec, packed: torch.Tensor,
                      end_state: torch.Tensor, total_bits: int
                      ) -> torch.Tensor:
    """Traceback over :func:`acs_scan_rotated` rows; (B, total_bits) uint8.

    The decision for new state s' at row t (phi = t mod n, j =
    (n-1-phi) mod n): h = s' >> 1 sits at lo slot p = rotr_n(h, phi),
    whose index i drops bit j of p; the bit is 2i + (s' & 1).
    """
    n = spec.K - 1
    if packed.shape[0] < total_bits + n:
        raise ValueError("decision history shorter than total_bits + K - 1")
    mask = (1 << n) - 1
    B = packed.shape[2]
    state = end_state.to(torch.int32)
    bits = torch.empty((total_bits, B), dtype=torch.uint8,
                       device=packed.device)
    for k in range(total_bits - 1, -1, -1):
        t = k + n
        phi = t % n
        j = (n - 1 - phi) % n
        h = state >> 1
        p = ((h >> phi) | (h << (n - phi))) & mask
        i = ((p >> (j + 1)) << j) | (p & ((1 << j) - 1))
        d = torch_core._unpack_bit(spec, packed[t], (i << 1) | (state & 1))
        state = (state >> 1) | (d << (n - 1))
        bits[k] = d.to(torch.uint8)
    return bits.t().contiguous()


def decode_big(spec: StaticSpec, metrics: torch.Tensor,
               symbols: torch.Tensor, end_state: torch.Tensor,
               total_bits: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """One-shot big-state decode: rotated ACS + its traceback.

    Returns (bits (B, total_bits) uint8, final metrics (S, B) state
    order, packed (T, W, B) i-order rows, acc (B,))."""
    m, packed, acc = acs_scan_rotated(spec, metrics, symbols)
    bits = chainback_rotated(spec, packed, end_state, total_bits)
    return bits, m, packed, acc
