"""Bounded-latency streaming decode (the port of
the JAX package's ``streaming.py``).

Bits come out continuously with a fixed decision delay instead of at the
end of a frame.  Each push runs the route's ACS on one chunk, appends its
decision rows to a ring of the last ``window`` rows (newest last), walks
the whole ring back from each frame's best state (the first minimum of
the state-order metrics) and commits the oldest ``chunk`` bits: the
truncated-traceback Viterbi decoder.  With ``window`` >= ~30 K the output
equals the exact decode on clean-enough channels.

Routes are the decoder's (``ops/route.py``): ``"rotated"``
(64 <= S <= 4096; rotated ACS, slot-order ring, slot-order walk),
``"plane"`` (S > 4096; plane ACS, (B, window, W/128, 128) ring,
frame-major plane walk), ``"lane"`` (S <= 32; lane ACS, state-order ring,
state-order walk) and ``"torch"`` (the plain state-order scan and walk,
on any device).  Every push restarts the ACS schedule at phase 0 and the
ring shifts by exactly ``chunk`` rows, so ring row i of a slot-order
route walks with the static rotation ((i mod chunk) + 1) mod n.

A stream's state lives in a *slot* of the decoder: its metrics, two
rings (a push shifts one into the other), the row count, the static
symbols a push copies in, and, on a card's kernel routes, a CUDA graph of
the whole push from each ring, captured against those buffers.
A push updates the slot in place and consumes the state it was given
(the JAX push donates it); the slot goes back to the decoder when the
last state that refers to it is dropped.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import trace
from .codes import CodeSpec
from .config import DecoderConfig, DecodeType, get_decode_config
from .ops import torch_core
from .ops.route import route_for

__all__ = ["StreamingState", "StreamingDecoder"]


@dataclasses.dataclass
class StreamingState:
    """Carry for a continuous decode, with the JAX ``StreamingState``'s
    fields: the metric vector, the last ``window`` decision rows (newest
    last) and the rows seen so far.

    ``push`` consumes the state it is given: push the state it returns.
    The tensors of a state that ``push`` returned belong to the decoder,
    which overwrites them at the stream's next pushes."""

    metrics: torch.Tensor    # (S, B) int32, state order
    history: torch.Tensor    # (window, W, B); (B, window, W/128, 128) plane
    rows_seen: torch.Tensor  # () int32
    # Host mirror of rows_seen (None: read it from the device once).
    host_rows: Optional[int] = dataclasses.field(default=None,
                                                 compare=False)
    # The stream's hold on its slot and the push count of the slot at
    # which this state is current (None: a state push did not return)
    _lease: Optional["_Lease"] = dataclasses.field(default=None,
                                                   compare=False, repr=False)
    _gen: int = dataclasses.field(default=0, compare=False, repr=False)


class _Slot:
    """One stream's buffers: the metrics, two rings (a push shifts the
    ring ``cur`` into the other, which then holds the state), the row
    count, the static symbols a push copies in, the push count, and
    ``replays``: for each ring the replay of a push from it (None until
    the push is captured, and always on a route that does not capture)."""

    __slots__ = ("symbols", "metrics", "rings", "cur", "rows_seen", "gen",
                 "replays")

    def __init__(self, sd: "StreamingDecoder", B: int):
        spec, dev = sd.spec, sd.device
        self.symbols = torch.empty((B, sd.chunk * spec.R), dtype=torch.int32,
                                   device=dev)
        self.metrics = torch.empty((spec.S, B), dtype=torch.int32, device=dev)
        self.rings = tuple(torch.empty(sd._ring_shape(B), dtype=torch.int32,
                                       device=dev) for _ in range(2))
        self.cur = 0
        self.rows_seen = torch.empty((), dtype=torch.int32, device=dev)
        self.gen = 0
        self.replays = None


class _Lease:
    """A stream's hold on its slot, shared by every state of the stream;
    when the last of them is dropped the slot returns to the decoder's
    free list, which keeps one slot a batch size."""

    __slots__ = ("slot", "pool")

    def __init__(self, slot: _Slot, pool: Dict[int, List[_Slot]]):
        self.slot, self.pool = slot, pool

    def __del__(self):
        free = self.pool.setdefault(self.slot.metrics.shape[1], [])
        if not free:
            free.append(self.slot)


def _replay(graph, bits: torch.Tensor, counts: dict) -> torch.Tensor:
    """Replay a captured push; its kernels count as launched."""
    graph.replay()
    trace.add(counts)
    return bits


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

    On a card the kernel routes replay each push after a stream's first as
    one CUDA graph; the plain versions, the ``"torch"`` route, the CPU
    and the cooperative plane ACS (K >= 20) run eagerly.
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
        self._route = route_for(self.spec, self.device, backend, plain)
        self.backend = self._route.name
        self.plain = self._route.plain
        self._rots = None
        # free slots by batch size
        self._free: Dict[int, List[_Slot]] = {}
        self._graphed = self._route.graphable

    def _ring_rots(self) -> torch.Tensor:
        """(window,) int32 walk rotations of the ring's rows, made on the
        device at first use (construction touches no card)."""
        if self._rots is None:
            n = self.spec.K - 1
            self._rots = torch.as_tensor(
                (np.arange(self.window) % self.chunk + 1) % n,
                dtype=torch.int32, device=self.device)
        return self._rots

    def _ring_shape(self, batch: int) -> tuple:
        return self._route.rows_shape(batch, self.window)

    def reset(self, batch: int, starting_state: int = 0) -> StreamingState:
        return StreamingState(
            metrics=torch_core.initial_metrics(self.spec, batch,
                                               starting_state, self.device),
            history=torch.zeros(self._ring_shape(batch), dtype=torch.int32,
                                device=self.device),
            rows_seen=torch.zeros((), dtype=torch.int32, device=self.device),
            host_rows=0,
        )

    def push(self, state: StreamingState, symbols
             ) -> Tuple[StreamingState, torch.Tensor, bool]:
        """Consume (B, chunk * R) symbols; returns (state, bits, valid).

        ``bits`` is (B, chunk) uint8, the bits decided ``window`` steps
        ago; ``valid`` is False while the ring primes (the first
        window / chunk - 1 pushes).  ``state`` is consumed: pushing it
        again raises ``ValueError``."""
        with trace.span("streaming.push"):
            return self._push(state, symbols)

    def _push(self, state: StreamingState, symbols
              ) -> Tuple[StreamingState, torch.Tensor, bool]:
        spec, chunk = self.spec, self.chunk
        symbols = torch.as_tensor(symbols)
        if symbols.dim() != 2 or symbols.shape[1] != chunk * spec.R:
            raise ValueError(f"push expects (B, chunk*R = {chunk * spec.R}) "
                             f"symbols, got {tuple(symbols.shape)}")
        B = symbols.shape[0]
        if B != state.metrics.shape[1]:
            raise ValueError(f"symbols carry {B} frames, the state "
                             f"{state.metrics.shape[1]}")
        lease = self._bind(state, B)
        slot = lease.slot
        seen = state.host_rows
        if seen is None:
            with trace.host_read("streaming.rows_seen"):
                seen = int(slot.rows_seen)
        # the state is consumed from here on, whatever happens below
        slot.gen += 1
        state._lease, state._gen = lease, -1
        slot.symbols.copy_(symbols)
        src, slot.cur = slot.cur, 1 - slot.cur
        if slot.replays is not None:
            trace.count("streaming.graph_replays")
            bits = slot.replays[src]()
        else:
            trace.count("streaming.eager_pushes")
            bits = self._eager(slot, src)
        # a copy: a replay overwrites the graph's bits
        bits = bits.clone(memory_format=torch.contiguous_format)
        new_state = StreamingState(slot.metrics, slot.rings[slot.cur],
                                   slot.rows_seen, seen + chunk, lease,
                                   slot.gen)
        return new_state, bits, seen + chunk >= self.window

    def _bind(self, state: StreamingState, B: int) -> _Lease:
        """The lease of the slot that holds ``state``: its own if push
        returned it, else a free (or new) slot with its tensors copied in."""
        lease = state._lease
        if lease is not None:
            if lease.pool is not self._free:
                raise ValueError("the state belongs to another "
                                 "StreamingDecoder")
            if state._gen != lease.slot.gen:
                raise ValueError("the state was consumed by an earlier push: "
                                 "push the state that push returned")
            return lease
        shapes = ((state.metrics, (self.spec.S, B)),
                  (state.history, self._ring_shape(B)),
                  (state.rows_seen, ()))
        for x, shape in shapes:
            if tuple(x.shape) != shape:
                raise ValueError(f"the state's tensors must be {shapes[0][1]}"
                                 f", {shapes[1][1]} and (), got "
                                 f"{[tuple(y.shape) for y, _ in shapes]}")
        free = self._free.get(B)
        slot = free.pop() if free else _Slot(self, B)
        slot.metrics.copy_(state.metrics)
        slot.rings[slot.cur].copy_(state.history)
        slot.rows_seen.copy_(state.rows_seen)
        return _Lease(slot, self._free)

    def _eager(self, slot: _Slot, src: int) -> torch.Tensor:
        """A push from ring ``src`` that does not replay: the body, and on
        a graphed decoder also the capture of the slot's replays."""
        if not self._graphed:
            return self._body(slot, src)
        trace.count("streaming.graph_captures")
        bits, slot.replays = self._capture(slot, src)
        return bits

    def _capture(self, slot: _Slot, src: int):
        """The push from ring ``src``, run on a side stream (the warm-up a
        capture needs), then a capture of the push from each ring into one
        graph each, sharing a memory pool (a stream replays them in turn,
        and nothing a replay leaves in the pool is read after the next).
        Returns the push's bits and the two replays.  A capture runs
        nothing, and skips ``torch.cuda.graph``'s emptying of the cache."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        pool = torch.cuda.graph_pool_handle()
        replays = []
        with torch.cuda.stream(side):
            bits = self._body(slot, src)
            for ring in (0, 1):
                graph = torch.cuda.CUDAGraph()
                with trace.held() as counts:
                    graph.capture_begin(pool=pool)
                    try:
                        static_bits = self._body(slot, ring)
                    finally:
                        graph.capture_end()
                replays.append(functools.partial(_replay, graph, static_bits,
                                                 counts))
        cur.wait_stream(side)
        bits.record_stream(cur)
        return bits, tuple(replays)

    def _body(self, slot: _Slot, src: int) -> torch.Tensor:
        """One push on the slot's buffers, in place: the symbols' clamp, the
        ACS into the tail of the other ring after ring ``src``'s newest
        rows, the best states, the walk and the row count.  Returns the
        push's (B, chunk) bits: a view of the walk's oldest ``chunk``
        rows."""
        route, chunk = self._route, self.chunk
        B = slot.metrics.shape[1]
        keep = self.window - chunk
        old, ring = slot.rings[src], slot.rings[1 - src]
        axis = route.time_axis
        syms = route.clamp(slot.symbols).reshape(B, chunk, self.spec.R)
        ring.narrow(axis, 0, keep).copy_(old.narrow(axis, chunk, keep))
        metrics, _, _ = route.acs(slot.metrics, syms, out=ring, row0=keep)
        # torch.argmin takes the first minimum, as jnp.argmin does
        best = torch.argmin(metrics, dim=0).to(torch.int32)
        rots = self._ring_rots() if route.slot_order else None
        bits = route.walk(ring, best, rots=rots)[:, :chunk]
        slot.metrics.copy_(metrics)
        slot.rows_seen.add_(chunk)
        return bits
