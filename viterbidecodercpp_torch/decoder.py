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

Every call is batched over ``B`` independent frames.  Routing by state
count S = 2**(K-1):

  * 64 <= S <= 4096 (K = 7..13): the rotated in-place ACS kernel and the
    slot-order traceback walk (ops/rotated.py, ops/chainback.py);
  * S > 4096 (K >= 14): the plane ACS kernels (a block or a cluster of
    blocks up to K=19, global-memory metrics above) and the plane walks,
    exact or truncated (ops/plane.py);
  * S <= 32 (K = 2..6): the lane ACS kernel and the state-order walk
    (ops/lane.py, ops/chainback.py).

The kernel backends launch CUDA kernels on a CUDA device and run their
plain versions on the CPU.  The kernels take rates up to 1/16: on a
CUDA device a code with R > 16 is refused at construction
(``NotImplementedError``) unless ``backend="torch"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import trace
from .codes import CodeSpec
from .config import DecoderConfig, DecodeType, get_decode_config
from .ops import bigstate, lane, plane, rotated, torch_core
from .ops import chainback as chainback_ops

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


def select_backend(spec: torch_core.StaticSpec, device: torch.device,
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
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self.backend = backend = select_backend(self.spec, self.device,
                                                backend)
        self._rotated = backend == "rotated"
        self._plane = backend == "plane"
        self._lane = backend == "lane"
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
            spec, dev = self.spec, self.device
            rows = self.decision_rows
            if self._plane:
                # rows round up to the JAX plane kernel's time block, so a
                # checkpoint's buffer has one shape in both packages; rows
                # past decision_rows are never written or read
                tb = plane.time_block_rows(spec)
                rows = -(-rows // tb) * tb
                shape = (batch, rows, spec.W // plane.COLS, plane.COLS)
            else:
                shape = (rows, spec.W, batch)
            alloc = torch.zeros if zero_fill else torch.empty
            return DecoderState(
                metrics=torch_core.initial_metrics(spec, batch, starting_state,
                                                   dev),
                decisions=alloc(shape, dtype=torch.int32, device=dev),
                accumulated_error=torch.zeros(batch, dtype=torch.int32,
                                              device=dev),
                bit_cursor=torch.zeros((), dtype=torch.int32, device=dev),
                row_rots=(torch.zeros(rows, dtype=torch.int32, device=dev)
                          if self._rotated or self._plane else None),
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
        spec = self.spec
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
        phys = state.decisions.shape[1 if self._plane else 0]
        # the plane buffer is padded past decision_rows with rows that are
        # never read, so its logical capacity is the smaller count
        capacity = min(phys, self.decision_rows) if self._plane else phys
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
        # Decoder contract (helpers/test_helpers.h:88-93): clamp to the
        # soft range so every backend agrees on out-of-range inputs.
        syms = torch.clamp(symbols.to(torch.int32), spec.soft_low,
                           spec.soft_high).reshape(B, nbits, spec.R)
        row_rots = state.row_rots
        slot_rows = self._rotated or self._plane
        if slot_rows and row_rots is None:
            # a state from a torch-backend decoder, built by hand, or a
            # plane checkpoint from before row_rots: its rows follow the
            # one-shot global schedule (row + 1) mod n
            row_rots = torch.as_tensor((np.arange(phys) + 1) % n,
                                       dtype=torch.int32, device=self.device)
        if self._plane:
            # the kernel writes the chunk's rows straight into the buffer
            metrics, _, acc = plane.acs_plane(
                spec, state.metrics.contiguous(), syms,
                out=state.decisions, row0=cursor)
        else:
            rows = state.decisions[cursor:cursor + nbits]
            if self._rotated or self._lane:
                # the kernel writes the chunk's rows straight into the
                # buffer (a carry built by hand may not be contiguous)
                acs = rotated.acs_rotated if self._rotated else lane.acs_lane
                metrics, packed, acc = acs(
                    spec, state.metrics.contiguous(), syms.contiguous(),
                    out=rows if rows.is_contiguous() else None)
            else:
                metrics, packed, acc = torch_core.acs_scan(
                    spec, state.metrics, syms)
            if packed.data_ptr() != rows.data_ptr():
                rows.copy_(packed)
        if slot_rows:
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
            return self._chainback(state, total_bits, end_state, mode, block,
                                   overlap)

    def _chainback(self, state: DecoderState, total_bits: int,
                   end_state: int, mode: str, block: int,
                   overlap: int) -> torch.Tensor:
        if total_bits > self._traceback_length:
            raise ValueError("total_bits exceeds traceback_length")
        if mode not in ("exact", "truncated"):
            raise ValueError(f"unknown chainback mode {mode!r}")
        ends = torch.full((state.batch,), end_state, dtype=torch.int32,
                          device=state.decisions.device)
        if mode == "truncated":
            if not self._plane:
                raise ValueError(
                    "mode='truncated' is for the big-state plane backend"
                    " (small codes' exact chainback is already parallel"
                    " across frames and faster than a truncated walk)")
            return plane.chainback_plane_truncated(
                self.spec, state.decisions, ends, total_bits,
                state.row_rots, block, overlap)
        # slot-order rows: stream each row's recorded rotation; a state
        # without row_rots follows the one-shot schedule
        if self._plane:
            return plane.chainback_plane(self.spec, state.decisions, ends,
                                         total_bits, state.row_rots)
        if self._rotated:
            return chainback_ops.chainback(
                self.spec, state.decisions, ends, total_bits,
                slot_order=True, rots=state.row_rots)
        if self._lane:
            return chainback_ops.chainback(self.spec, state.decisions, ends,
                                           total_bits, slot_order=False)
        return torch_core.chainback_scan(self.spec, state.decisions, ends,
                                         total_bits)

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
        if torch_core.needs_big_state(spec) and not self._plane:
            m0 = torch_core.initial_metrics(spec, B, 0, self.device)
            ends = torch.full((B,), end_state, dtype=torch.int32,
                              device=self.device)
            # the same input clamp as update (decoder-wide contract)
            syms = torch.clamp(symbols.to(torch.int32).reshape(B, -1, spec.R),
                               spec.soft_low, spec.soft_high)
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
