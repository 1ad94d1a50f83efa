"""The route of a decode: the kernels a code runs on and the layout of
their decision rows, decided once for a decoder, a streamer or a
time-parallel call.

Routing by state count S = 2**(K-1) (:func:`select_backend`):

  * ``"rotated"`` (64 <= S <= 4096): the rotated in-place ACS, slot-order
    rows (T, W, B) with a walk rotation a row, the slot-order walk
    (ops/rotated.py, ops/chainback.py);
  * ``"plane"`` (S > 4096): the plane ACS (a block or a cluster of
    blocks a frame up to K=19, global-memory metrics above), frame-major
    slot-order rows (B, T, W/128, 128) with a walk rotation a row, the
    plane walks, exact or truncated (ops/plane.py);
  * ``"lane"`` (S <= 32): the lane ACS, state-order rows (T, W, B), the
    state-order walk (ops/lane.py, ops/chainback.py);
  * ``"torch"``: the plain state-order scan and walk (ops/torch_core.py,
    ops/chainback.py), on any device.

A :class:`Route` launches the CUDA kernels on a card and runs their plain
versions on the CPU, or on any device with ``plain=True``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from . import chainback as chainback_ops
from . import lane, plane, rotated, torch_core
from .torch_core import StaticSpec

__all__ = ["Route", "route_for", "select_backend", "resolve_device",
           "BACKENDS"]

BACKENDS = ("rotated", "plane", "lane", "torch")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device with its card index; raises without a
    card (no fallback to the CPU) and for a device other than a card or
    the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def select_backend(spec: StaticSpec, device: torch.device,
                   backend: str = "auto") -> str:
    """Resolve ``backend`` for a spec on a device (routing by state count,
    see the module docstring); raises for a named backend outside its
    class and, on a CUDA device, for a kernel backend at R > 16."""
    S = spec.S
    if device.type == "cuda" and spec.R > torch_core.KERNEL_MAX_RATE \
            and backend in ("auto", "rotated", "plane", "lane"):
        raise NotImplementedError(
            f"no CUDA kernel for rate 1/{spec.R}: the ACS kernels take "
            f"R <= {torch_core.KERNEL_MAX_RATE} (their tap masks and "
            f"branch-pattern tables); run such a code with backend=\"torch\" "
            f"(the plain scan, on the card or the CPU)")
    in_class = rotated.ROTATED_MIN_STATES <= S <= torch_core.MAX_LANE_STATES
    if backend == "auto":
        # S = 2^(K-1): the three classes cover every K >= 2
        if in_class:
            return "rotated"
        return "plane" if plane.supports(spec) else "lane"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "rotated" and not in_class:
        raise ValueError(f"the rotated backend covers "
                         f"{rotated.ROTATED_MIN_STATES} <= S <= "
                         f"{torch_core.MAX_LANE_STATES}, got S={S}")
    if backend == "plane" and not plane.supports(spec):
        raise ValueError(f"the plane backend covers "
                         f"S > {torch_core.MAX_LANE_STATES}, got S={S}")
    if backend == "lane" and not lane.supports(spec):
        raise ValueError(f"the lane backend covers S <= "
                         f"{lane.MAX_LANE_KERNEL_STATES}, got S={S}")
    return backend


def _scan(spec, metrics, symbols, out=None):
    """``torch_core.acs_scan``, which returns rows of its own: ``out`` is
    not written (:meth:`Route.acs` copies them there)."""
    return torch_core.acs_scan(spec, metrics, symbols)


def _kernels(name: str) -> tuple:
    """(ACS, its plain version, walk, its plain version) of route
    ``name``, looked up as the route is made (a test may put a fake in a
    module's place first)."""
    if name == "plane":
        return (plane.acs_plane, plane.acs_plane_ref,
                plane.walk_plane_frames, plane.walk_plane_frames_ref)
    walks = (chainback_ops.walk_rows, chainback_ops.walk_rows_ref)
    if name == "rotated":
        return (rotated.acs_rotated, rotated.acs_rotated_ref) + walks
    if name == "lane":
        return (lane.acs_lane, lane.acs_lane_ref) + walks
    return (_scan, _scan, walks[1], walks[1])


@dataclasses.dataclass(frozen=True)
class Route:
    """One route for one spec, made by :func:`route_for`.

    ``name``: the backend; ``plain``: the kernels' plain versions on every
    device; ``graphable``: a card's kernels, which a stream's push replays
    as one CUDA graph (not the cooperative plane ACS of K >= 20);
    ``slot_order``: decision rows are slot-rotated, one walk rotation a
    row (``DecoderState.row_rots``); ``time_axis``: the rows' time axis
    (1 in the plane layout (B, T, W/128, 128), else 0 in (T, W, B));
    ``time_block``: a decision buffer's row count rounds up to it (the
    JAX plane kernel's time block, so that a checkpoint's buffer has one
    shape in both packages; 1 elsewhere).
    """

    name: str
    spec: StaticSpec
    plain: bool
    graphable: bool
    slot_order: bool
    time_axis: int
    time_block: int
    _acs: Callable = dataclasses.field(repr=False)
    _walk: Callable = dataclasses.field(repr=False)

    def buffer_rows(self, rows: int) -> int:
        """The row count of a decision buffer that holds ``rows`` rows."""
        return -(-rows // self.time_block) * self.time_block

    def rows_shape(self, batch: int, rows: int) -> tuple:
        """The shape of ``rows`` decision rows of ``batch`` frames."""
        if self.time_axis:
            return (batch, rows, self.spec.W // plane.COLS, plane.COLS)
        return (rows, self.spec.W, batch)

    def capacity(self, phys: int, decision_rows: int) -> int:
        """How many rows of a buffer of ``phys`` rows updates may fill: the
        rows past ``decision_rows`` that round a buffer up to the time
        block are never read."""
        return min(phys, decision_rows) if self.time_block > 1 else phys

    def clamp(self, symbols: torch.Tensor) -> torch.Tensor:
        """``symbols`` as int32, clamped to the soft range: the decoder's
        input contract (helpers/test_helpers.h:88-93), so that every route
        agrees on symbols outside it."""
        return torch.clamp(symbols.to(torch.int32), self.spec.soft_low,
                           self.spec.soft_high)

    def acs(self, metrics: torch.Tensor, symbols: torch.Tensor,
            out: Optional[torch.Tensor] = None, row0: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The ACS over (B, T, R) int32 ``symbols`` from (S, B) state-order
        ``metrics``: (metrics, rows, acc (B,)).  With ``out``, a buffer of
        decision rows in this route's layout, the T rows are written to
        its rows [row0, row0 + T) and ``rows`` is that view; without, the
        rows are new."""
        metrics, symbols = metrics.contiguous(), symbols.contiguous()
        if self.time_axis:
            return self._acs(self.spec, metrics, symbols, out=out, row0=row0)
        if out is None:
            return self._acs(self.spec, metrics, symbols)
        rows = out[row0:row0 + symbols.shape[1]]
        # the kernels write straight into contiguous rows (a carry built
        # by hand may not be); the plain scan returns rows of its own
        m, packed, acc = self._acs(self.spec, metrics, symbols,
                                   rows if rows.is_contiguous() else None)
        if packed.data_ptr() != rows.data_ptr():
            rows.copy_(packed)
        return m, rows, acc

    def walk(self, rows: torch.Tensor, start: torch.Tensor,
             rots: Optional[torch.Tensor] = None,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, N) uint8 path bits of a walk over N decision rows from the
        (B,) int32 ``start`` states, row t carrying data bit t - (K-1):
        ``rots`` the rows' walk rotations (slot-order routes; ignored on
        the others), a row with ``valid == 0`` emits its bit and keeps the
        walk's state."""
        if self.time_axis:
            return self._walk(self.spec, rows, start, rots=rots, valid=valid)
        return self._walk(self.spec, rows, start, slot_order=self.slot_order,
                          rots=rots if self.slot_order else None,
                          valid=valid).t()

    def chainback(self, decisions: torch.Tensor, ends: torch.Tensor,
                  total_bits: int, rots: Optional[torch.Tensor] = None, *,
                  first_bit: int = 0, n_bits: Optional[int] = None,
                  mode: str = "exact", block: int = 512, overlap: int = 128
                  ) -> torch.Tensor:
        """A decoder's traceback (its kernels on a card) from the (B,)
        int32 ``ends`` after row total_bits + K - 2 of ``decisions``: the
        (B, n_bits) uint8 data bits [first_bit, first_bit + n_bits)
        (n_bits defaults to the rest).  ``rots``: the rows' walk rotations
        (slot-order routes; None follows the one-shot schedule).
        ``mode="truncated"`` (plane only) walks ``block``-row tiles in
        parallel, each warmed up by ``overlap`` rows."""
        if mode not in ("exact", "truncated"):
            raise ValueError(f"unknown chainback mode {mode!r}")
        if n_bits is None:
            n_bits = total_bits - first_bit
        spec = self.spec
        if mode == "truncated":
            if self.name != "plane":
                raise ValueError(
                    "mode='truncated' is for the big-state plane backend"
                    " (small codes' exact chainback is already parallel"
                    " across frames and faster than a truncated walk)")
            bits = plane.chainback_plane_truncated(
                spec, decisions, ends, total_bits, rots, block, overlap)
        elif self.name == "plane":
            bits = plane.chainback_plane(spec, decisions, ends, total_bits,
                                         rots)
        elif self.name == "torch":
            bits = torch_core.chainback_scan(spec, decisions, ends,
                                             total_bits)
        else:
            # these walks stop at the oldest row they read
            return chainback_ops.chainback(
                spec, decisions, ends, total_bits, first_bit=first_bit,
                n_bits=n_bits, slot_order=self.slot_order,
                rots=rots if self.slot_order else None)
        if (first_bit, n_bits) == (0, total_bits):
            return bits
        return bits[:, first_bit:first_bit + n_bits].contiguous()


def route_for(spec: StaticSpec, device, backend: str = "auto",
              plain: bool = False) -> Route:
    """The route of ``spec`` on ``device`` (a card or the CPU, not touched
    here) for ``backend`` (see :func:`select_backend`); ``plain`` runs the
    kernels' plain versions."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    name = select_backend(spec, device, backend)
    acs, acs_plain, walk, walk_plain = _kernels(name)
    big = name == "plane"
    return Route(
        name=name, spec=spec, plain=bool(plain),
        graphable=(device.type == "cuda" and not plain and name != "torch"
                   and not (big and plane.acs_kernel(spec)
                            == "plane_acs_global")),
        slot_order=name in ("rotated", "plane"),
        time_axis=1 if big else 0,
        time_block=plane.time_block_rows(spec) if big else 1,
        _acs=acs_plain if plain else acs,
        _walk=walk_plain if plain else walk)
