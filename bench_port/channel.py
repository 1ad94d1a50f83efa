"""The benchmark's inputs: random data bits, the code's encoder, BPSK, AWGN
at a stated Eb/No and quantisation to the decode type's soft range, made
on the device from a seeded ``torch.Generator``.

A frozen plain-torch copy of the port's channel, so that no change to the
program moves what it is fed:

  * ``encode`` from ``viterbidecodercpp_torch/ops/encoder.py`` lines
    97-125 (``_tap_delays``, ``encode_bits``), with an initial register;
  * ``awgn_sigma``, ``round_half_away`` and the arithmetic of
    ``modulate_encode`` and ``awgn_quantize`` from
    ``viterbidecodercpp_torch/utils/testsig.py`` lines 44-100.

The symbols are handed over in the configuration's ``symbol_dtype``, as a
receiver hands them over.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["awgn_sigma", "round_half_away", "encode", "channel"]


def awgn_sigma(ebno_db: float, code_rate: int) -> float:
    """Noise sigma for a real +/-1 signal at the given Eb/No."""
    esno_db = ebno_db - 10.0 * math.log10(float(code_rate))
    return (10.0 ** (-(esno_db + 3.0) / 10.0)) ** 0.5


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """std::round: halfway cases away from zero."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def encode(K: int, G: Sequence[int], bits: torch.Tensor, *,
           terminate: bool = True) -> torch.Tensor:
    """(N, L) data bits -> (N, T, R) int32 output bits, T = L (+ K-1 zero
    tail bits with ``terminate``), from the zero state: output bit r at
    time t is the parity of G[r] over bits t-K+1 .. t, newest at bit 0."""
    N = bits.shape[0]
    x = bits.to(torch.int32)
    if terminate:
        x = torch.cat([x, x.new_zeros(N, K - 1)], dim=1)
    T = x.shape[1]
    xp = torch.cat([x.new_zeros(N, K - 1), x], dim=1)       # (N, T + K-1)
    outs = []
    for g in G:
        acc = x.new_zeros(N, T)
        for i in range(K):
            if (int(g) >> i) & 1:
                acc = acc + xp[:, K - 1 - i:K - 1 - i + T]
        outs.append(acc & 1)
    return torch.stack(outs, dim=-1)


def channel(out_bits: torch.Tensor, generator: torch.Generator,
            ebno_db: float, high: int, low: int,
            dtype: torch.dtype) -> torch.Tensor:
    """BPSK (+1 for a 1), AWGN at ``ebno_db`` for the code's rate, and
    quantisation to [low, high]: (N, T, R) output bits -> (N, T * R)
    symbols of ``dtype``, in float32 as the port's channel computes."""
    N, T, R = out_bits.shape
    dev = out_bits.device
    x = torch.where(out_bits == 1, 1.0, -1.0).to(torch.float32)

    def f32(v):
        return torch.full((), v, dtype=torch.float32, device=dev)

    sigma = f32(awgn_sigma(ebno_db, R))
    noise = torch.randn(x.shape, generator=generator, dtype=torch.float32,
                        device=dev)
    noisy = x + sigma * noise
    mean, mag = (high + low) / 2.0, (high - low) / 2.0
    norm = 1.0 / torch.sqrt(1.0 + sigma * sigma)
    q = round_half_away(noisy * (f32(mag) * norm) + f32(mean))
    return torch.clamp(q, low, high).to(dtype).reshape(N, T * R)
