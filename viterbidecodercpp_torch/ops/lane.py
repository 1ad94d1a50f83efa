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
With ``out``, a contiguous (T, W, B) int32 tensor such as a slice of a
decoder's row buffer, the rows are written there and ``packed`` is
``out``.

The port routes K = 2..6 here; 64 <= S <= 4096 goes to the rotated kernel
(ops/rotated.py), which the JAX package's lane kernel also served.
:func:`acs_lane` launches the CUDA kernel (``csrc/lane_acs.cu``) for CUDA
tensors and runs the plain version :func:`acs_lane_ref` - the plain
state-order scan - only for CPU tensors.  The kernel reads the symbols
in the caller's layout and each state's branch pattern from
:func:`_lane_patterns`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import trace
from .torch_core import KERNEL_MAX_RATE, StaticSpec, acs_scan, rows_out

__all__ = ["supports", "acs_lane", "acs_lane_ref", "MAX_LANE_KERNEL_STATES"]

MAX_LANE_KERNEL_STATES = 32   # one warp holds a whole frame


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


@functools.lru_cache(maxsize=64)
def _lane_patterns(spec: StaticSpec) -> np.ndarray:
    """(S,) int32 branch patterns of the states, made once per spec: bit r
    of state s's pattern is set where bt[r][s >> 1] is the high level, so
    its branch metric is sum_r |(bit r ? high : low) - sym[r]|.

    The kernel builds its branch-metric tables from these and the two
    levels; a table with a third value has no such patterns."""
    bt = np.asarray(spec.bt, dtype=np.int64)              # (R, H)
    if not np.isin(bt, (spec.soft_high, spec.soft_low)).all():
        raise ValueError("branch table takes values other than the soft "
                         "levels; the lane kernel builds its metrics from "
                         "the two levels")
    high = bt[:, np.arange(spec.S) >> 1] == spec.soft_high  # (R, S)
    bits = high.astype(np.int64) << np.arange(spec.R)[:, None]
    return bits.sum(axis=0).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _launcher():
    from . import _build

    fn = _build.load("lane_acs").vdt_lane_acs
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    return fn


def acs_lane_ref(spec: StaticSpec, metrics: torch.Tensor,
                 symbols: torch.Tensor, out: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`acs_lane`, on any device."""
    _, T = _check(spec, metrics, symbols)
    if out is None:
        return acs_scan(spec, metrics, symbols)
    packed = rows_out(spec, metrics, T, out)
    m, rows, acc = acs_scan(spec, metrics, symbols)
    packed.copy_(rows)
    return m, packed, acc


def acs_lane(spec: StaticSpec, metrics: torch.Tensor, symbols: torch.Tensor,
             out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run T state-order ACS steps; see the module docstring for the
    contract.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``csrc/lane_acs.cu``) or raise."""
    with trace.span("ops.lane_acs"):
        B, T = _check(spec, metrics, symbols)
        if metrics.device.type == "cpu":
            return acs_lane_ref(spec, metrics, symbols, out)
        if metrics.device.type != "cuda":
            raise ValueError(f"unsupported device {metrics.device}")
        for name, x in (("metrics", metrics), ("symbols", symbols)):
            if x.dtype != torch.int32 or not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous int32 on CUDA, "
                                 f"got {x.dtype}, "
                                 f"contiguous={x.is_contiguous()}")
        if spec.R > KERNEL_MAX_RATE:
            raise ValueError(f"the CUDA lane ACS takes R <= "
                             f"{KERNEL_MAX_RATE}, got R={spec.R}")
        if B == 0:
            raise ValueError("empty batch")
        packed = rows_out(spec, metrics, T, out)
        fn = _launcher()
        pat = _lane_patterns(spec)
        m_out = torch.empty_like(metrics)
        acc = torch.empty(B, dtype=torch.int32, device=metrics.device)
        with torch.cuda.device(metrics.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(metrics.data_ptr(), symbols.data_ptr(),
                     m_out.data_ptr(), packed.data_ptr(), acc.data_ptr(), B,
                     T, spec.K, spec.R, pat.ctypes.data, spec.soft_high,
                     spec.soft_low, spec.max_error, spec.metric_max,
                     spec.renorm_threshold, int(spec.saturating), stream)
        if err != 0:
            raise RuntimeError(f"lane ACS kernel launch failed: CUDA error "
                               f"{err}")
        trace.count("launches.lane_acs")
        return m_out, packed, acc
