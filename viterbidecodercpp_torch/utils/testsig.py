"""Test-signal chain: modulation, AWGN, quantisation - batched, on the
device of the input (the port of the JAX package's ``utils/testsig.py``).

Reproduces the numeric chain of the reference BER harness
(run_snr_ber.cpp:318-359):

    EsNo_dB = EbNo_dB - 10 log10(R)
    sigma^2 = 10^(-(EsNo_dB + 3)/10)            # +3 dB for a real signal
    norm    = 1 / sqrt(1 + sigma^2)             # noisy-signal energy
    soft    = clamp(round(x * (mag * norm) + mean), low, high)

where encode uses +/-1.0 floats, ``mag = (high - low)/2`` and
``mean = (high + low)/2`` of the integer soft-decision range, and round
is half-away-from-zero (std::round, not banker's rounding).  Also hosts
the integer-noise helpers of test_helpers.h:66-93.

Randomness comes from an explicit ``torch.Generator`` on the input's
device in place of a ``jax.random`` key: the two give different numbers
from one seed, so only the deterministic pieces match the JAX package
exactly and the noise matches it in distribution.
"""

from __future__ import annotations

import math

import torch

from ..codes import CodeSpec
from ..ops import encoder

__all__ = [
    "awgn_sigma",
    "modulate_encode",
    "awgn_quantize",
    "round_half_away",
    "count_bit_errors",
    "add_noise",
    "add_binary_noise",
    "clamp_vector",
]


def awgn_sigma(EbNo_dB: float, code_rate: int) -> float:
    """Noise sigma for a real +/-1 signal at the given Eb/No
    (run_snr_ber.cpp:319-322)."""
    EsNo_dB = EbNo_dB - 10.0 * math.log10(float(code_rate))
    variance = 10.0 ** (-(EsNo_dB + 3.0) / 10.0)
    return variance ** 0.5


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """std::round semantics: halfway cases away from zero (torch.round
    is half-to-even, which would bias the quantiser)."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def modulate_encode(code: CodeSpec, bits: torch.Tensor,
                    terminate: bool = True) -> torch.Tensor:
    """Encode (B, N) data bits to (B, T, R) float32 +/-1 symbols
    (run_snr_ber.cpp:341-346 encodes with high=+1.0, low=-1.0)."""
    y = encoder.encode_bits(code, bits, terminate)
    return torch.where(y == 1, 1.0, -1.0).to(torch.float32)


def awgn_quantize(float_syms: torch.Tensor, generator: torch.Generator,
                  EbNo_dB: float, code_rate: int, config) -> torch.Tensor:
    """Add AWGN and quantise to the config's soft-decision integer range
    (run_snr_ber.cpp:348-359), in float32 as the JAX package does.
    ``config`` is anything carrying the soft range: a DecoderConfig
    (.soft_decision_high/low) or a torch_core.StaticSpec
    (.soft_high/low)."""
    high = getattr(config, "soft_decision_high", None)
    if high is None:
        high, low = config.soft_high, config.soft_low
    else:
        low = config.soft_decision_low
    dev = float_syms.device

    def f32(x):
        # a fill, not a copy from the host: a copy would sync the device
        return torch.full((), x, dtype=torch.float32, device=dev)

    sigma = f32(awgn_sigma(EbNo_dB, code_rate))
    noise = torch.randn(float_syms.shape, generator=generator,
                        dtype=torch.float32, device=dev)
    noisy = float_syms + sigma * noise
    mean = (high + low) / 2.0
    mag = (high - low) / 2.0
    norm = 1.0 / torch.sqrt(1.0 + sigma * sigma)
    q = round_half_away(noisy * (f32(mag) * norm) + f32(mean))
    return torch.clamp(q, low, high).to(torch.int32)


def add_noise(symbols: torch.Tensor, generator: torch.Generator,
              intensity: int) -> torch.Tensor:
    """Uniform integer noise in [-intensity, +intensity]
    (test_helpers.h:66-74)."""
    noise = torch.randint(-intensity, intensity + 1, symbols.shape,
                          generator=generator, dtype=torch.int32,
                          device=symbols.device)
    return symbols.to(torch.int32) + noise


def add_binary_noise(symbols: torch.Tensor, generator: torch.Generator,
                     flip_probability: float, low: int,
                     high: int) -> torch.Tensor:
    """Flip symbols to the opposite rail with the given probability - the
    hard-decision channel (test_helpers.h:76-85)."""
    flip = torch.rand(symbols.shape, generator=generator,
                      device=symbols.device) < flip_probability
    mid = (low + high) / 2.0
    flipped = torch.where(symbols > mid, low, high).to(torch.int32)
    return torch.where(flip, flipped, symbols.to(torch.int32))


def clamp_vector(symbols: torch.Tensor, low: int, high: int) -> torch.Tensor:
    """Clamp to the soft-decision range (test_helpers.h:88-93)."""
    return torch.clamp(symbols, low, high).to(torch.int32)


def count_bit_errors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Total differing bits between two bit tensors, a 0-d int32 tensor
    (test_helpers.h:95-104 without the byte LUT)."""
    return (a != b).sum(dtype=torch.int32)
