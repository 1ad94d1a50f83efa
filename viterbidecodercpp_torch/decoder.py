"""Public decoder API: an explicit decode carry + a reference-shaped
wrapper (the port of the JAX package's ``decoder.py``).

The reference exposes a stateful core (``ViterbiDecoder_Core``:
``reset`` / ``update`` / ``chainback`` / ``get_error``,
viterbi_decoder_core.h:157-243) whose key property is incremental
decoding: ``update`` may be called repeatedly in arbitrary chunks before
one ``chainback``.  As in the JAX package the carry is explicit data
(:class:`DecoderState`) with the same fields, the same decision layout
and the same ``.npz`` checkpoint format, so a stream checkpointed by one
package continues in the other.

Every call is batched over ``B`` independent frames, on the route that
ops/route.py picks at construction by state count S = 2**(K-1): the
rotated, plane or lane kernels (see :class:`ViterbiDecoder`), launched on
a CUDA device and run as their plain versions on the CPU.
``select_backend`` and ``resolve_device`` live there and are re-exported
here.  The kernels take rates up to 1/16: on a CUDA device a code with
R > 16 is refused at construction (``NotImplementedError``) unless
``backend="torch"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import trace
from .codes import CodeSpec
from .config import DecoderConfig, DecodeType, get_decode_config
from .ops import bigstate, torch_core
from .ops.route import resolve_device, route_for, select_backend

__all__ = ["DecoderState", "ViterbiDecoder", "select_backend",
           "resolve_device"]

_FIELDS = ("metrics", "decisions", "accumulated_error", "bit_cursor",
           "row_rots")


@dataclasses.dataclass
class DecoderState:
    """The resumable decode carry, with the JAX ``DecoderState``'s fields.

    ``decisions`` is (rows, W, B) int32 words on the rotated, lane and
    torch backends and (B, rows_phys, W/128, 128) on the plane backend,
    whose row count rounds up to ``plane.time_block_rows``.  ``update``
    writes the decision rows and ``row_rots`` of its chunk in place (the
    JAX package donates the carry to the same effect): keep using the
    state it returns, not the one passed in.
    """

    metrics: torch.Tensor            # (S, B) int32, state-major
    decisions: torch.Tensor          # packed decision rows, see above
    accumulated_error: torch.Tensor  # (B,) int32 renormalisation total
    bit_cursor: torch.Tensor         # () int32 next decision row to write
    # Rotated and plane backends: per-decision-row walk rotations
    # (slot-order rows), one per row of ``decisions``.
    row_rots: Optional[torch.Tensor] = None   # (rows,) int32
    # Host mirror of bit_cursor (None: read it from the device once).
    host_cursor: Optional[int] = dataclasses.field(default=None,
                                                   compare=False)

    @property
    def batch(self) -> int:
        return self.metrics.shape[1]

    def to_numpy(self) -> dict:
        """The carry as numpy arrays under the JAX state's field names
        (``row_rots`` only when present)."""
        out = {}
        for f in _FIELDS:
            v = getattr(self, f)
            if v is not None:
                out[f] = v.detach().cpu().numpy()
        return out

    @classmethod
    def from_numpy(cls, d: dict, device="cuda") -> "DecoderState":
        """Build a carry from arrays under the JAX state's field names,
        e.g. ``{f: np.asarray(getattr(jax_state, f)) ...}``; either
        decision layout (3-D rows or the 4-D plane buffer)."""
        def t(name):
            return torch.tensor(np.asarray(d[name]), dtype=torch.int32,
                                device=device)
        return cls(metrics=t("metrics"), decisions=t("decisions"),
                   accumulated_error=t("accumulated_error"),
                   bit_cursor=t("bit_cursor"),
                   row_rots=(t("row_rots") if d.get("row_rots") is not None
                             else None))

    def save(self, path: str) -> None:
        """Checkpoint the carry to an .npz file (the JAX package's
        format and keys)."""
        np.savez(path, **self.to_numpy())

    @classmethod
    def load(cls, path: str, device="cuda") -> "DecoderState":
        """Restore a carry written by :meth:`save` of either package."""
        with np.load(path) as z:
            return cls.from_numpy({f: z[f] for f in z.files}, device)


class ViterbiDecoder:
    """Batched Viterbi decoder for one (code, config) pair.

    API parity with the JAX package's ``ViterbiDecoder`` and the
    reference core: ``reset`` ~ viterbi_decoder_core.h:202, ``update`` ~
    viterbi_decoder_scalar.h:29, ``chainback`` ~ viterbi_decoder_core.h:214,
    ``get_error`` ~ viterbi_decoder_core.h:195, ``set_traceback_length`` ~
    viterbi_decoder_core.h:180.

    ``backend``:
      * ``"rotated"`` - rotated ACS + slot-order walk (64 <= S <= 4096):
        the CUDA kernels on a CUDA device, their plain versions on the CPU.
      * ``"plane"``   - plane ACS + plane walks (S > 4096), the same
        way.
      * ``"lane"``    - lane ACS + state-order walk (S <= 32), the same
        way.
      * ``"torch"``   - the plain state-order scan, on any device (and
        the rotated-layout scan of ops/bigstate.py for ``decode`` with
        S > 4096).
      * ``"auto"``    - ``"rotated"``, ``"plane"`` or ``"lane"`` by S.

    Input contract: soft symbols lie in [soft_decision_low,
    soft_decision_high]; the decoder clamps inputs to that range
    (helpers/test_helpers.h:88-93), so all backends agree bit-for-bit.
    """

    def __init__(self, code: CodeSpec,
                 config: Union[DecoderConfig, DecodeType, str], *,
                 traceback_length: int = 0, backend: str = "auto",
                 device="cuda"):
        if not isinstance(config, DecoderConfig):
            config = get_decode_config(DecodeType(config), code.R)
        self.code = code
        self.config = config
        self.spec = torch_core.make_static_spec(code, config)
        self.device = torch.device(device)
        self._route = route_for(self.spec, self.device, backend)
        self.backend = self._route.name
        self._traceback_length = int(traceback_length)

    # -- capacity ---------------------------------------------------------
    @property
    def traceback_length(self) -> int:
        """Max data bits the decision buffer can hold (excludes the K-1
        tail rows, like get_traceback_length viterbi_decoder_core.h:189)."""
        return self._traceback_length

    def set_traceback_length(self, length: int) -> None:
        self._traceback_length = int(length)

    @property
    def decision_rows(self) -> int:
        return self._traceback_length + self.code.K - 1

    # -- state ------------------------------------------------------------
    def reset(self, batch: int, starting_state: int = 0) -> DecoderState:
        """Fresh carry for ``batch`` frames (viterbi_decoder_core.h:202-211).
        Decision rows are (rows, W, B) words, slot order on the rotated
        backend (with ``row_rots``) and state order on the lane and torch
        backends,
        or a (B, rows_phys, W/128, 128) plane buffer (with ``row_rots``)
        on the plane backend."""
        return self._reset(batch, starting_state, zero_fill=True)

    def _reset(self, batch: int, starting_state: int,
               zero_fill: bool) -> DecoderState:
        with trace.span("decoder.reset"):
            return self._blank(
                torch_core.initial_metrics(self.spec, batch, starting_state,
                                           self.device),
                self.decision_rows, zero_fill)

    def _blank(self, metrics: torch.Tensor, rows: int,
               zero_fill: bool) -> DecoderState:
        """A carry at ``metrics`` with room for ``rows`` decision rows."""
        route, dev, batch = self._route, self.device, metrics.shape[1]
        rows = route.buffer_rows(rows)
        alloc = torch.zeros if zero_fill else torch.empty
        return DecoderState(
            metrics=metrics,
            decisions=alloc(route.rows_shape(batch, rows), dtype=torch.int32,
                            device=dev),
            accumulated_error=torch.zeros(batch, dtype=torch.int32,
                                          device=dev),
            bit_cursor=torch.zeros((), dtype=torch.int32, device=dev),
            row_rots=(torch.zeros(rows, dtype=torch.int32, device=dev)
                      if route.slot_order else None),
            host_cursor=0,
        )

    # -- hot path ---------------------------------------------------------
    def update(self, state: DecoderState, symbols) -> DecoderState:
        """Consume (B, N) soft symbols (N a multiple of R); returns the new
        carry with N/R more decision rows written (in place into
        ``state.decisions``).  Call as many times as you like before
        ``chainback`` (run_punctured_decoder.cpp:258-282)."""
        with trace.span("decoder.update"):
            return self._update(state, symbols)

    def _update(self, state: DecoderState, symbols) -> DecoderState:
        spec, route = self.spec, self._route
        n = spec.K - 1
        symbols = torch.as_tensor(symbols, device=self.device)
        if symbols.dim() != 2:
            raise ValueError(f"symbols must be (B, N), got "
                             f"{tuple(symbols.shape)}")
        B, N = symbols.shape
        if N % self.code.R:
            raise ValueError("symbol count must be a multiple of R")
        if B != state.batch:
            raise ValueError(f"symbols carry {B} frames, the state {state.batch}")
        nbits = N // self.code.R
        phys = state.decisions.shape[route.time_axis]
        capacity = route.capacity(phys, self.decision_rows)
        # Mirror of the reference's capacity assert
        # (viterbi_decoder_core.h:180-186): a write past the decision
        # buffer would otherwise corrupt the tail.  A state from load()
        # pays one device read the first time.
        cursor = state.host_cursor
        if cursor is None:
            with trace.host_read("decoder.cursor"):
                cursor = int(state.bit_cursor)
        if cursor + nbits > capacity:
            raise ValueError(
                f"decision buffer overflow: {cursor} rows used + "
                f"{nbits} new > capacity {capacity} "
                "(set_traceback_length before reset, or chainback "
                "and reset between blocks)")
        syms = route.clamp(symbols).reshape(B, nbits, spec.R)
        row_rots = state.row_rots
        if route.slot_order and row_rots is None:
            # a state from a torch-backend decoder, built by hand, or a
            # plane checkpoint from before row_rots: its rows follow the
            # one-shot global schedule (row + 1) mod n
            row_rots = torch.as_tensor((np.arange(phys) + 1) % n,
                                       dtype=torch.int32, device=self.device)
        metrics, _, acc = route.acs(state.metrics, syms, out=state.decisions,
                                    row0=cursor)
        if route.slot_order:
            # row i of this chunk is slot-rotated by (i + 1) mod n
            row_rots[cursor:cursor + nbits] = (
                torch.arange(1, nbits + 1, dtype=torch.int32,
                             device=self.device) % n)
        return DecoderState(
            metrics=metrics,
            decisions=state.decisions,
            accumulated_error=state.accumulated_error + acc,
            bit_cursor=state.bit_cursor + nbits,
            row_rots=row_rots,
            host_cursor=cursor + nbits,
        )

    # -- readout ----------------------------------------------------------
    def get_error(self, state: DecoderState,
                  end_state: int = 0) -> torch.Tensor:
        """(B,) normalised path metric at ``end_state``
        (viterbi_decoder_core.h:195-199, incl. its ``% NUMSTATES``
        index wrap)."""
        return state.metrics[end_state & (self.spec.S - 1), :]

    def chainback(self, state: DecoderState, total_bits: int,
                  end_state: int = 0, *, mode: str = "exact",
                  block: int = 512, overlap: int = 128) -> torch.Tensor:
        """Trace back and return (B, total_bits) uint8 decoded data bits
        (viterbi_decoder_core.h:214-236).

        ``mode="exact"`` is the reference-exact sequential walk.
        ``mode="truncated"`` (plane backend only) splits the walk into
        ``block``-row tiles that trace back in parallel, each warmed up by
        an ``overlap``-row walk: with overlap >= ~10 K the bits equal the
        exact walk's with overwhelming probability, but are no longer
        guaranteed maximum-likelihood.
        """
        with trace.span("decoder.chainback"):
            ends = torch.full((state.batch,), end_state, dtype=torch.int32,
                              device=state.decisions.device)
            return self._chainback(state, total_bits, ends, mode, block,
                                   overlap)

    def _chainback(self, state: DecoderState, total_bits: int,
                   ends: torch.Tensor, mode: str = "exact", block: int = 512,
                   overlap: int = 128, first_bit: int = 0,
                   n_bits: Optional[int] = None) -> torch.Tensor:
        """The walk from the (B,) int32 end states ``ends`` after row
        total_bits + K - 2, on the decoder's route: data bits [first_bit,
        first_bit + n_bits) (n_bits defaults to the rest)."""
        if total_bits > self._traceback_length:
            raise ValueError("total_bits exceeds traceback_length")
        # slot-order rows: each row's recorded rotation; a state without
        # row_rots follows the one-shot schedule
        return self._route.chainback(
            state.decisions, ends, total_bits, state.row_rots,
            first_bit=first_bit, n_bits=n_bits, mode=mode, block=block,
            overlap=overlap)

    def chainback_bytes(self, state: DecoderState, total_bits: int,
                        end_state: int = 0) -> np.ndarray:
        """Host-side convenience: decoded bits packed MSB-first to bytes."""
        bits = self.chainback(state, total_bits, end_state).cpu().numpy()
        return np.packbits(bits, axis=-1, bitorder="big")

    # -- one-shot convenience ----------------------------------------------
    def decode(self, symbols, total_bits: int, *, end_state: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """reset + update + chainback in one call.

        Returns (bits (B, total_bits), final_error (B,), accumulated (B,)).

        When ``total_bits`` exceeds the traceback capacity this grows it
        via set_traceback_length, and the growth is sticky, exactly like
        the reference core's (viterbi_decoder_core.h:180-186).  On the
        torch backend a code with S > 4096 decodes through the
        rotated-layout scan (ops/bigstate.py), as the JAX xla backend's
        decode does, without touching the traceback length.
        """
        with trace.span("decoder.decode"):
            return self._decode(symbols, total_bits, end_state)

    def _decode(self, symbols, total_bits: int, end_state: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        spec = self.spec
        symbols = torch.as_tensor(symbols, device=self.device)
        B = symbols.shape[0]
        if torch_core.needs_big_state(spec) and self.backend == "torch":
            m0 = torch_core.initial_metrics(spec, B, 0, self.device)
            ends = torch.full((B,), end_state, dtype=torch.int32,
                              device=self.device)
            syms = self._route.clamp(symbols).reshape(B, -1, spec.R)
            bits, m, _, acc = bigstate.decode_big(spec, m0, syms, ends,
                                                  total_bits)
            return bits, m[end_state & (spec.S - 1), :], acc
        if self._traceback_length < total_bits:
            self.set_traceback_length(total_bits)
        # a buffer the one update fills up to every row the chainback
        # reads needs no zero fill (a plane buffer at Cassini B=512 is 2 GB)
        nrows = symbols.shape[-1] // self.code.R
        state = self._reset(B, 0, zero_fill=(
            nrows < total_bits + self.code.K - 1))
        state = self.update(state, symbols)
        bits = self.chainback(state, total_bits, end_state)
        return bits, self.get_error(state, end_state), state.accumulated_error

    def decode_tailbiting(self, symbols, total_bits: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """Circular decode of tail-biting frames (3GPP TS 36.212 5.1.3.1:
        the encoder starts from the frame's last K-1 bits, so its start
        and end states are the same and unknown).

        ``symbols``: (B, total_bits * R) soft symbols, e.g. the output of
        :func:`~viterbidecodercpp_torch.ratematch.dematch`.  Every state
        starts at the same metric, the trellis runs over three copies of
        the frame (3L steps), each frame's walk starts at its first state
        of least metric (as ``StreamingDecoder.push`` picks it) and
        returns the middle copy's bits, by then independent of the
        unknown start.  Returns (bits (B, total_bits), the best state's
        metric (B,), the renormalisation total (B,)), as :meth:`decode`
        does.  Needs total_bits >= K - 1.
        """
        with trace.span("decoder.tailbiting"):
            return self._decode_tailbiting(symbols, int(total_bits))

    def _decode_tailbiting(self, symbols, L: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        spec, n = self.spec, self.code.K - 1
        symbols = torch.as_tensor(symbols, device=self.device)
        if symbols.dim() != 2 or symbols.shape[1] != L * spec.R:
            raise ValueError(f"symbols must be (B, {L * spec.R}) for "
                             f"{L}-bit frames at R={spec.R}, got "
                             f"{tuple(symbols.shape)}")
        if L < n:
            raise ValueError(f"a tail-biting frame needs total_bits >= "
                             f"K-1 = {n}, got {L}")
        B, rows = symbols.shape[0], 3 * L
        # the walk covers all 3L rows (sticky growth, as decode's)
        if self._traceback_length < rows - n:
            self.set_traceback_length(rows - n)
        state = self._blank(torch_core.equal_metrics(spec, B, self.device),
                            rows, zero_fill=False)
        state = self.update(state, symbols.repeat(1, 3))
        # torch.argmin takes the first minimum, as push does
        best = torch.argmin(state.metrics, dim=0)
        metric = state.metrics.gather(0, best[None])[0]
        with trace.span("decoder.chainback"):
            bits = self._chainback(state, rows - n, best.to(torch.int32),
                                   first_bit=L, n_bits=L)
        trace.count("tailbiting.frames", B)
        trace.count("tailbiting.rows", B * rows)
        return bits, metric, state.accumulated_error
