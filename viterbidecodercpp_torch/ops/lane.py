"""Lane-resident state-order ACS for S <= 32 (the port of
the JAX package's ``ops/acs_pallas.py``).

The contract is ``acs_pallas``'s (and ``torch_core.acs_scan``'s):

    metrics (S, B) int32 state order, symbols (B, T, R) int32 ->
    (metrics (S, B) int32 state order, packed (T, W, B) int32 rows in
     ViterbiDecisionBits state order, acc (B,) int32).

W = 1 for every S <= 32, and bits >= S of a word are zero.  The branch
metric is the abs-diff of ``jax_core.acs_scan``, exact for any symbols
(the TPU kernel's default symmetric shortcut is exact only for symbols
in the soft range; the decoder clamps to it, so the two agree there).

The port routes K = 2..6 here; 64 <= S <= 4096 goes to the rotated kernel
(ops/rotated.py), which the JAX package's lane kernel also served.
:func:`acs_lane` launches the CUDA kernel (``csrc/lane_acs.cu``) for CUDA
tensors and runs the plain version :func:`acs_lane_ref` - the plain
state-order scan - only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .torch_core import KERNEL_MAX_RATE, StaticSpec, acs_scan

__all__ = ["supports", "acs_lane", "acs_lane_ref", "MAX_LANE_KERNEL_STATES",
           "LAUNCHES"]

MAX_LANE_KERNEL_STATES = 32   # one warp holds a whole frame

# Kernel launches by acs_lane (reset and read by chip_smoke.py).
LAUNCHES = 0


def supports(spec: StaticSpec) -> bool:
    """True for the lane class, S <= 32 (K <= 6)."""
    return spec.S <= MAX_LANE_KERNEL_STATES


def _check(spec: StaticSpec, metrics: torch.Tensor,
           symbols: torch.Tensor) -> Tuple[int, int]:
    if not supports(spec):
        raise ValueError(f"the lane ACS covers S <= {MAX_LANE_KERNEL_STATES}, "
                         f"got S={spec.S}: 64 <= S <= 4096 runs on the "
                         f"rotated kernel (ops/rotated.py)")
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


def acs_lane_ref(spec: StaticSpec, metrics: torch.Tensor,
                 symbols: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`acs_lane`, on any device."""
    _check(spec, metrics, symbols)
    return acs_scan(spec, metrics, symbols)


def acs_lane(spec: StaticSpec, metrics: torch.Tensor, symbols: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run T state-order ACS steps; see the module docstring for the
    contract.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``csrc/lane_acs.cu``) or raise."""
    B, T = _check(spec, metrics, symbols)
    if metrics.device.type == "cpu":
        return acs_scan(spec, metrics, symbols)
    if metrics.device.type != "cuda":
        raise ValueError(f"unsupported device {metrics.device}")
    for name, x in (("metrics", metrics), ("symbols", symbols)):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on CUDA, got "
                             f"{x.dtype}, contiguous={x.is_contiguous()}")
    if spec.R > KERNEL_MAX_RATE:
        raise ValueError(f"the CUDA lane ACS takes R <= {KERNEL_MAX_RATE}, "
                         f"got R={spec.R}")
    if B == 0:
        raise ValueError("empty batch")
    from . import _build

    lib = _build.load("lane_acs")
    fn = lib.vdt_lane_acs
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    bt = np.asarray(spec.bt, dtype=np.int32).reshape(-1)     # (R * H,)
    table = (ctypes.c_int * bt.size)(*bt.tolist())
    # time-major symbols: one step's loads of neighbouring frames are
    # neighbouring addresses
    sym_t = symbols.permute(1, 2, 0).contiguous()              # (T, R, B)
    m_out = torch.empty_like(metrics)
    packed = torch.empty((T, spec.W, B), dtype=torch.int32,
                         device=metrics.device)
    acc = torch.empty(B, dtype=torch.int32, device=metrics.device)
    with torch.cuda.device(metrics.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(metrics.data_ptr(), sym_t.data_ptr(), m_out.data_ptr(),
                 packed.data_ptr(), acc.data_ptr(), B, T, spec.K, spec.R,
                 ctypes.cast(table, ctypes.c_void_p), spec.max_error,
                 spec.metric_max, spec.renorm_threshold,
                 int(spec.saturating), stream)
    if err != 0:
        raise RuntimeError(f"lane ACS kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return m_out, packed, acc
