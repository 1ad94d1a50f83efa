"""Batched convolutional encoding and puncturing on tensors (the port of
the JAX package's ``ops/encoder.py``).

Encoding is closed form: output bit j at time t is ``parity(G[j] & reg_t)``
with ``reg_t`` holding input bits ``t-K+1 .. t`` (newest at the LSB), so

    y[j, t] = XOR_{i : G[j] bit i set} x[t - i]

- a sum of shifted copies of the bit stream mod 2, with no sequential
dependency.  Runs on whatever device the input tensor lies on.  Beside it:
the byte-at-a-time host encoder (:class:`ByteStreamEncoder`) and the
decode side of puncturing (:func:`depuncture`,
helpers/puncture_code_helpers.h:31-50).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..codes import CodeSpec, PunctureSpec, parity

__all__ = [
    "encode_bits",
    "encode_bits_tailbiting",
    "encode_symbols",
    "bytes_to_bits",
    "bits_to_bytes",
    "depuncture",
    "puncture_mask",
    "ByteStreamEncoder",
]


class ByteStreamEncoder:
    """Byte-at-a-time incremental encoder - the reference encoder ABC
    (convolutional_encoder.h:10-29): ``reset()`` clears the shift
    register; ``consume_byte(x)`` returns the R output bytes for one
    input byte, bits packed LSB-first in stream order t*R + j
    (convolutional_encoder_shift_register.h:40-62).

    Host-side convenience for protocol code that feeds bytes as they
    arrive; bulk encoding uses the closed-form :func:`encode_bits` or the
    native batch runtime (``utils/native.NativeEncoder``), both of which
    it matches bit-for-bit.
    """

    def __init__(self, code: CodeSpec):
        self.code = code
        self.K = code.K
        self.R = code.R
        self._mask = (1 << code.K) - 1
        self._reg = 0

    def reset(self) -> None:
        self._reg = 0

    def consume_byte(self, x: int) -> np.ndarray:
        """Encode one input byte (bits MSB-first) -> (R,) uint8 output
        bytes holding the 8*R encoded bits LSB-first."""
        y = np.zeros(self.R, np.uint8)
        curr_bit = 0
        for i in range(8):
            self._reg = ((self._reg << 1) | ((int(x) >> (7 - i)) & 1)) \
                & self._mask
            for g in self.code.G:
                b = int(parity(g & self._reg))
                y[curr_bit >> 3] |= np.uint8(b << (curr_bit & 7))
                curr_bit += 1
        return y

    def consume_bytes(self, data) -> np.ndarray:
        """Vector convenience: (n,) bytes -> (n, R) output bytes."""
        return np.stack([self.consume_byte(b) for b in np.asarray(data)])


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


def _convolve(code: CodeSpec, x: torch.Tensor,
              head: torch.Tensor) -> torch.Tensor:
    """(B, T) int32 bits, and the (B, K-1) bits before them -> (B, T, R)
    int32 output bits."""
    B, T = x.shape
    xp = torch.cat([head, x], dim=1)                           # (B, T+K-1)
    outs = []
    for taps in _tap_delays(code):
        acc = x.new_zeros(B, T)
        for i in taps:
            acc = acc + xp[:, code.K - 1 - i:code.K - 1 - i + T]
        outs.append(acc & 1)
    return torch.stack(outs, dim=-1)


def encode_bits(code: CodeSpec, bits: torch.Tensor,
                terminate: bool = True) -> torch.Tensor:
    """Encode (B, N) data bits -> (B, T, R) int32 output bits,
    T = N (+ K-1 tail).

    Zero initial state; with ``terminate`` the K-1 zero tail bits are
    appended (helpers/test_helpers.h:54-60).
    """
    B = bits.shape[0]
    x = bits.to(torch.int32)
    if terminate:
        x = torch.cat([x, x.new_zeros(B, code.K - 1)], dim=1)
    # delayed[i] = x shifted right by i with zero fill (initial state 0)
    return _convolve(code, x, x.new_zeros(B, code.K - 1))


def encode_bits_tailbiting(code: CodeSpec, bits: torch.Tensor
                           ) -> torch.Tensor:
    """Tail-biting encode (B, L) data bits -> (B, L, R) int32 output bits
    (3GPP TS 36.212 5.1.3.1): the register starts from the frame's last
    K-1 bits, so it ends where it started and no tail is sent.  L >= K-1.
    """
    L = bits.shape[1]
    if L < code.K - 1:
        raise ValueError(f"a tail-biting frame needs L >= K-1 = "
                         f"{code.K - 1} bits, got {L}")
    x = bits.to(torch.int32)
    return _convolve(code, x, x[:, L - (code.K - 1):])


def encode_symbols(code: CodeSpec, bits: torch.Tensor, high: int,
                   low: int, terminate: bool = True) -> torch.Tensor:
    """Encode data bits to (B, T, R) int32 soft symbols in {low, high}."""
    y = encode_bits(code, bits, terminate)
    return torch.where(y == 1, torch.full_like(y, high),
                       torch.full_like(y, low))


def puncture_mask(spec: PunctureSpec, total_symbols: int,
                  phase: int = 0) -> np.ndarray:
    """Host-side keep-mask for a periodic puncture pattern."""
    return spec.mask(total_symbols, phase)


def depuncture(punctured, keep_mask: np.ndarray,
               neutral: int) -> torch.Tensor:
    """Re-inflate punctured symbols to the full symbol lattice.

    Positions where ``keep_mask`` is False receive ``neutral`` (default
    midpoint 0 in the harness), matching ``decode_punctured_symbols``
    (helpers/puncture_code_helpers.h:31-50).  ``punctured`` has shape
    (B, total_kept); the output is (B, len(keep_mask)) int32 on its
    device.  The kept positions come from the host mask, are copied to
    that device and scattered with there: no read back from the device.
    """
    keep_mask = np.asarray(keep_mask, dtype=bool)
    kept_positions = np.flatnonzero(keep_mask)
    punctured = torch.as_tensor(punctured)
    B = punctured.shape[0]
    if punctured.shape[1] != kept_positions.size:
        raise ValueError(
            f"got {punctured.shape[1]} punctured symbols for a mask keeping "
            f"{kept_positions.size}")
    dev = punctured.device
    out = torch.full((B, keep_mask.size), int(neutral), dtype=torch.int32,
                     device=dev)
    out[:, torch.as_tensor(kept_positions, device=dev)] = \
        punctured.to(torch.int32)
    return out
