"""A BER batch's channel in one pass: encode with the K-1 zero tail, BPSK,
AWGN from noise already drawn and quantise to the soft range.

The contract, for a code of constraint length K and rate 1/R::

    bits (B, N) uint8 data bits, noise (B, T, R) float32 (T = N + K - 1),
    sigma, scale, mean: 0-d float32 tensors, low <= high ints ->
    (B, T, R) int32 symbols,

symbol (b, t, r) being ``clamp(round_half_away((s + sigma * n) * scale +
mean), low, high)`` with ``s = +1.0`` where ``parity(G[r] & reg_t)`` is 1
and ``-1.0`` otherwise, ``reg_t`` the register of step t (bit i is the
data bit i steps back; zero before step 0 and on the tail), every
operation rounded to float32 on its own.  Its plain version is
``testsig.quantise(testsig.modulate_encode(code, bits), noise, sigma,
scale, mean, low, high)``, bit for bit, with the scalars that
``testsig.channel_scalars`` makes.

:func:`encode_awgn_quantize` launches the CUDA kernel
(``csrc/awgn_channel.cu``) on CUDA tensors and raises on any other
device: ``testsig.encode_awgn_quantize`` sends other devices to the plain
chain.  The kernel takes K <= 32 (a step's register is one 32-bit word)
and any R up to :data:`MAX_RATE`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ..codes import CodeSpec

__all__ = ["encode_awgn_quantize", "kernel_check", "MAX_K", "MAX_RATE"]

MAX_K = 32        # VDT_CH_MAX_K in csrc/awgn_channel.cu
MAX_RATE = 8192   # the taps and a tile's bits fit 48 KB of shared memory


def kernel_check(code: CodeSpec, bits: torch.Tensor,
                 noise: torch.Tensor) -> None:
    """Raise ``ValueError`` for what the CUDA kernel does not take (on any
    device, so that the CPU tests reach it)."""
    if bits.dim() != 2:
        raise ValueError(f"bits must be (B, N), got {tuple(bits.shape)}")
    B, N = bits.shape
    want = (B, N + code.K - 1, code.R)
    if tuple(noise.shape) != want:
        raise ValueError(f"noise must be (B, N + K - 1, R) = {want}, got "
                         f"{tuple(noise.shape)}")
    if noise.dtype != torch.float32:
        raise ValueError(f"noise must be float32, got {noise.dtype}")
    if bits.device != noise.device:
        raise ValueError("bits and noise are on different devices")
    if code.K > MAX_K:
        raise ValueError(f"the CUDA channel takes K <= {MAX_K} (one 32-bit "
                         f"register a step), got K={code.K}")
    if code.R > MAX_RATE:
        raise ValueError(f"the CUDA channel takes R <= {MAX_RATE}, got "
                         f"R={code.R}")
    if bits.dtype != torch.uint8 or not bits.is_contiguous():
        raise ValueError(f"bits must be contiguous uint8, got {bits.dtype}, "
                         f"contiguous={bits.is_contiguous()}")
    if not noise.is_contiguous() or noise.data_ptr() % 16:
        raise ValueError("noise must be contiguous and start on a 16-byte "
                         "boundary")
    if bits.shape[0] == 0:
        raise ValueError("empty batch")


@functools.lru_cache(maxsize=64)
def _taps(G: tuple, device: torch.device) -> torch.Tensor:
    """The code's taps on the card as int32 words (K = 32 sets the sign
    bit), copied there once."""
    return torch.tensor([g - (1 << 32) if g >> 31 else g for g in G],
                        dtype=torch.int32, device=device)


# vdt_awgn_channel's parameters, the stream last
_PARAMS = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


def encode_awgn_quantize(code: CodeSpec, bits: torch.Tensor,
                         noise: torch.Tensor, sigma: torch.Tensor,
                         scale: torch.Tensor, mean: torch.Tensor,
                         low: int, high: int) -> torch.Tensor:
    """The channel of a batch on the card; see the module docstring for
    the contract.  Launches the kernel (``csrc/awgn_channel.cu``) or
    raises."""
    if bits.device.type != "cuda":
        raise ValueError(f"unsupported device {bits.device}")
    kernel_check(code, bits, noise)
    scalars = (sigma, scale, mean)
    if any(v.dtype != torch.float32 or v.numel() != 1
           or v.device != bits.device for v in scalars):
        raise ValueError("sigma, scale and mean must be one-element float32 "
                         "tensors on the device of the bits")
    B, N = bits.shape
    out = torch.empty(noise.shape, dtype=torch.int32, device=bits.device)
    fn = _build.kernel("awgn_channel", "vdt_awgn_channel", _PARAMS)
    _build.launch(fn, "awgn_channel", bits.device, bits.data_ptr(),
                  noise.data_ptr(), out.data_ptr(),
                  _taps(code.G, bits.device).data_ptr(),
                  *(v.data_ptr() for v in scalars), B, N, code.K, code.R,
                  int(low), int(high))
    return out
