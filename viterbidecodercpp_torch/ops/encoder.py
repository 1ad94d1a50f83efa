"""Batched convolutional encoding on tensors (the port of
the JAX package's ``ops/encoder.py:86-141``).

Encoding is closed form: output bit j at time t is ``parity(G[j] & reg_t)``
with ``reg_t`` holding input bits ``t-K+1 .. t`` (newest at the LSB), so

    y[j, t] = XOR_{i : G[j] bit i set} x[t - i]

- a sum of shifted copies of the bit stream mod 2, with no sequential
dependency.  Runs on whatever device the input tensor lies on.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..codes import CodeSpec

__all__ = [
    "encode_bits",
    "encode_symbols",
    "bytes_to_bits",
    "bits_to_bytes",
]


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """(..., N) uint8 bytes -> (..., 8N) uint8 bits, MSB first
    (convolutional_encoder_shift_register.h:52)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=data.device)
    bits = (data.to(torch.uint8)[..., :, None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8N) bits -> (..., N) uint8 bytes, MSB first (chainback byte
    convention, viterbi_decoder_core.h:105-112)."""
    n = bits.shape[-1]
    if n % 8:
        raise ValueError(f"bit count {n} is not a multiple of 8")
    b = bits.reshape(*bits.shape[:-1], n // 8, 8).to(torch.int32)
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return (b << shifts).sum(dim=-1).to(torch.uint8)


def _tap_delays(code: CodeSpec) -> Tuple[Tuple[int, ...], ...]:
    """For each polynomial, the set of delays i with tap G bit i set."""
    return tuple(
        tuple(i for i in range(code.K) if (g >> i) & 1) for g in code.G
    )


def encode_bits(code: CodeSpec, bits: torch.Tensor,
                terminate: bool = True) -> torch.Tensor:
    """Encode (B, N) data bits -> (B, T, R) int32 output bits,
    T = N (+ K-1 tail).

    Zero initial state; with ``terminate`` the K-1 zero tail bits are
    appended (helpers/test_helpers.h:54-60).
    """
    B, N = bits.shape
    x = bits.to(torch.int32)
    if terminate:
        x = torch.cat([x, x.new_zeros(B, code.K - 1)], dim=1)
    T = x.shape[1]
    # delayed[i] = x shifted right by i with zero fill (initial state 0)
    xp = torch.cat([x.new_zeros(B, code.K - 1), x], dim=1)    # (B, T+K-1)
    outs = []
    for taps in _tap_delays(code):
        acc = x.new_zeros(B, T)
        for i in taps:
            acc = acc + xp[:, code.K - 1 - i:code.K - 1 - i + T]
        outs.append(acc & 1)
    return torch.stack(outs, dim=-1)                          # (B, T, R)


def encode_symbols(code: CodeSpec, bits: torch.Tensor, high: int,
                   low: int, terminate: bool = True) -> torch.Tensor:
    """Encode data bits to (B, T, R) int32 soft symbols in {low, high}."""
    y = encode_bits(code, bits, terminate)
    return torch.where(y == 1, torch.full_like(y, high),
                       torch.full_like(y, low))
