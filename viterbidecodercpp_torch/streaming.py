"""Bounded-latency streaming decode (the port of
the JAX package's ``streaming.py``).

Bits come out continuously with a fixed decision delay instead of at the
end of a frame.  Each push runs the route's ACS on one chunk, appends its
decision rows to a ring of the last ``window`` rows (newest last), walks
the whole ring back from each frame's best state (the first minimum of
the state-order metrics) and commits the oldest ``chunk`` bits: the
truncated-traceback Viterbi decoder.  With ``window`` >= ~30 K the output
equals the exact decode on clean-enough channels.

Routes are the decoder's (``decoder.select_backend``): ``"rotated"``
(64 <= S <= 4096; rotated ACS, slot-order ring, slot-order walk),
``"plane"`` (4096 < S <= 65536; plane ACS, (B, window, W/128, 128) ring,
frame-major plane walk), ``"lane"`` (S <= 32; lane ACS, state-order ring,
state-order walk) and ``"torch"`` (the plain state-order scan and walk,
on any device).  Every push restarts the ACS schedule at phase 0 and the
ring shifts by exactly ``chunk`` rows, so ring row i of a slot-order
route walks with the static rotation ((i mod chunk) + 1) mod n.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .codes import CodeSpec
from .config import DecoderConfig, DecodeType, get_decode_config
from .decoder import select_backend
from .ops import chainback, lane, plane, rotated, torch_core

__all__ = ["StreamingState", "StreamingDecoder"]


@dataclasses.dataclass
class StreamingState:
    """Carry for a continuous decode, with the JAX ``StreamingState``'s
    fields: the metric vector, the last ``window`` decision rows (newest
    last) and the rows seen so far."""

    metrics: torch.Tensor    # (S, B) int32, state order
    history: torch.Tensor    # (window, W, B); (B, window, W/128, 128) plane
    rows_seen: torch.Tensor  # () int32
    # Host mirror of rows_seen (None: read it from the device once).
    host_rows: Optional[int] = dataclasses.field(default=None,
                                                 compare=False)


class StreamingDecoder:
    """Fixed-latency streaming decoder for one (code, config) pair.

    ``push`` consumes ``chunk`` trellis steps of symbols per call and, once
    the ring is primed (``window`` rows seen), emits ``chunk`` decided bits
    per call, delayed by ``window`` steps::

        sd = StreamingDecoder(code, "SOFT16", window=256, chunk=64,
                              device="cuda")
        state = sd.reset(batch)
        for block in symbol_blocks:          # (B, chunk * R) each
            state, bits, valid = sd.push(state, block)
            if valid:                        # a Python bool
                consume(bits)                # (B, chunk) uint8

    ``plain=True`` runs the plain versions of the route's kernels on any
    device (same layouts, same schedule): the reference the kernels are
    held against on the card.
    """

    def __init__(self, code: CodeSpec,
                 config: Union[DecoderConfig, DecodeType, str], *,
                 window: int, chunk: int, backend: str = "auto",
                 device="cuda", plain: bool = False):
        if not isinstance(config, DecoderConfig):
            config = get_decode_config(DecodeType(config), code.R)
        if chunk < 1 or window < 1 or window % chunk:
            raise ValueError("window must be a positive multiple of chunk")
        self.code = code
        self.config = config
        self.spec = torch_core.make_static_spec(code, config)
        self.window = int(window)
        self.chunk = int(chunk)
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self.backend = select_backend(self.spec, self.device, backend)
        self.plain = bool(plain)
        self._rots = None

    def _ring_rots(self) -> torch.Tensor:
        """(window,) int32 walk rotations of the ring's rows, made on the
        device at first use (construction touches no card)."""
        if self._rots is None:
            n = self.spec.K - 1
            self._rots = torch.as_tensor(
                (np.arange(self.window) % self.chunk + 1) % n,
                dtype=torch.int32, device=self.device)
        return self._rots

    def reset(self, batch: int, starting_state: int = 0) -> StreamingState:
        spec = self.spec
        if self.backend == "plane":
            shape = (batch, self.window, spec.W // plane.COLS, plane.COLS)
        else:
            shape = (self.window, spec.W, batch)
        return StreamingState(
            metrics=torch_core.initial_metrics(spec, batch, starting_state,
                                               self.device),
            history=torch.zeros(shape, dtype=torch.int32, device=self.device),
            rows_seen=torch.zeros((), dtype=torch.int32, device=self.device),
            host_rows=0,
        )

    def push(self, state: StreamingState, symbols
             ) -> Tuple[StreamingState, torch.Tensor, bool]:
        """Consume (B, chunk * R) symbols; returns (state, bits, valid).

        ``bits`` is (B, chunk) uint8, the bits decided ``window`` steps
        ago; ``valid`` is False while the ring primes (the first
        window / chunk - 1 pushes)."""
        spec, chunk, plain = self.spec, self.chunk, self.plain
        symbols = torch.as_tensor(symbols, device=self.device)
        if symbols.dim() != 2 or symbols.shape[1] != chunk * spec.R:
            raise ValueError(f"push expects (B, chunk*R = {chunk * spec.R}) "
                             f"symbols, got {tuple(symbols.shape)}")
        B = symbols.shape[0]
        if B != state.metrics.shape[1]:
            raise ValueError(f"symbols carry {B} frames, the state "
                             f"{state.metrics.shape[1]}")
        # the decoder's input clamp (helpers/test_helpers.h:88-93)
        syms = torch.clamp(symbols.to(torch.int32), spec.soft_low,
                           spec.soft_high).reshape(B, chunk, spec.R)
        metrics = state.metrics.contiguous()
        route = self.backend
        if route == "plane":
            acs = plane.acs_plane_ref if plain else plane.acs_plane
            metrics, packed, _ = acs(spec, metrics, syms)
            history = torch.cat([state.history[:, chunk:], packed], dim=1)
        else:
            acs = {"rotated": (rotated.acs_rotated, rotated.acs_rotated_ref),
                   "lane": (lane.acs_lane, lane.acs_lane_ref),
                   "torch": (torch_core.acs_scan, torch_core.acs_scan),
                   }[route][plain]
            metrics, packed, _ = acs(spec, metrics, syms)
            history = torch.cat([state.history[chunk:], packed], dim=0)
        # torch.argmin takes the first minimum, as jnp.argmin does
        best = torch.argmin(metrics, dim=0).to(torch.int32)
        rots = self._ring_rots() if route in ("rotated", "plane") else None
        if route == "plane":
            walk = (plane.walk_plane_frames_ref if plain
                    else plane.walk_plane_frames)
            bits = walk(spec, history, best, rots=rots)[:, :chunk]
        else:
            walk = (chainback.walk_rows_ref if plain or route == "torch"
                    else chainback.walk_rows)
            rows = walk(spec, history, best, slot_order=rots is not None,
                        rots=rots)
            bits = rows[:chunk].t()
        seen = state.host_rows
        if seen is None:
            seen = int(state.rows_seen)
        new_state = StreamingState(metrics=metrics, history=history,
                                   rows_seen=state.rows_seen + chunk,
                                   host_rows=seen + chunk)
        return new_state, bits.contiguous(), seen + chunk >= self.window
