"""Spans and counters of the port's own layers.

One recorder for the process::

    from viterbidecodercpp_torch import trace
    trace.enable()
    ...                              # decode, push, decode_stream_sp calls
    trace.disable()
    spans = trace.drain()            # [Record], in the order they opened
    trace.counters()                 # {"launches.rotated_acs": 12, ...}

A span is one call of a layer; its :class:`Record` holds ``name``,
``detail`` (a stage, or None), its ``id``, the id of its ``parent`` span
(None for a root), ``call``, the id of its root, shared by every span
under one root call, and ``start_ns`` and ``end_ns`` read with
``time.time_ns()``, the clock of ``torch.profiler``'s kineto events (an
event's ``start_ns()``, whose offset from
``kineto_results.trace_start_ns()`` is its ``time_range``), so spans
lie on a profiled trace's timeline.

Tracing is off by default.  Off, a span site costs one flag test and
returns one shared no-op context; on, spans stay in memory until
:func:`drain`.  Spans nest per thread.  Counters always count: kernel
launches as ``launches.<kernel>``, device-to-host reads of the
program as ``host_reads.<site>``, and a stream's pushes as
``streaming.graph_replays`` (replays of a captured CUDA graph),
``streaming.eager_pushes`` (pushes run op by op, a capturing push among
them) and ``streaming.graph_captures`` (a slot's capture, of its two
graphs).  A capture launches nothing: the launches counted while a graph
is captured are :func:`held` and :func:`add`-ed at each of its replays,
so ``launches.<kernel>`` counts the kernels the device ran.  Nothing is written anywhere.

:func:`timed_span` is a span that also times its body on the device for
a caller's ``timings`` dict (CUDA events, synchronising at both ends).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

__all__ = ["Record", "Span", "enable", "disable", "span", "timed_span",
           "host_read", "count", "add", "held", "counters", "reset_counters",
           "drain", "self_ns"]

_on = False
# closed spans as plain tuples (Record's fields), which the garbage
# collector stops tracking: a long window adds no collection work
_records: List[tuple] = []
_ids = itertools.count(1)
_local = threading.local()
_counters: Dict[str, int] = {}


class _Off:
    """The shared context of a span site while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Record(NamedTuple):
    """A closed span (see the module docstring)."""

    name: str
    detail: Optional[str]
    id: int
    parent: Optional[int]
    call: int
    start_ns: int
    end_ns: int


class Span:
    """The context of an open span; recorded when it closes."""

    __slots__ = ("name", "detail", "id", "parent", "call", "start_ns",
                 "end_ns")

    def __init__(self, name: str, detail: Optional[str] = None):
        self.name = name
        self.detail = detail
        self.parent = None

    def __enter__(self) -> "Span":
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.call = self.id
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        _stack().pop()
        _records.append((self.name, self.detail, self.id, self.parent,
                         self.call, self.start_ns, self.end_ns))
        return False


def enable() -> None:
    """Record spans from now on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording spans (the recorded ones stay until drain)."""
    global _on
    _on = False


def span(name: str, detail: Optional[str] = None):
    """A context that records a span ``name`` around its body while
    tracing is on, else the shared no-op context."""
    if not _on:
        return _OFF
    return Span(name, detail)


class _Timed:
    """A span whose body is also timed for ``timings[key]``."""

    __slots__ = ("span", "timings", "key", "cuda", "t0")

    def __init__(self, name, detail, timings, key, device):
        self.span = span(name, detail)
        self.timings, self.key = timings, key
        self.cuda = torch.device(device).type == "cuda"

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ev.synchronize()
        return ev

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.t0 = self._now()
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        t1 = self._now()
        secs = self.t0.elapsed_time(t1) / 1e3 if self.cuda else t1 - self.t0
        self.timings[self.key] = self.timings.get(self.key, 0.0) + secs
        return False


def timed_span(name: str, detail: Optional[str], timings: Optional[dict],
               key: str, device):
    """:func:`span`, which with a ``timings`` dict also adds the seconds of
    its body to ``timings[key]``: CUDA events on a card, the host clock
    on the CPU, the device synchronised at both ends (a body that waits
    on the host counts its wait).  ``timings`` None adds no timing and
    no synchronisation."""
    if timings is None:
        return span(name, detail)
    return _Timed(name, detail, timings, key, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (counters always count), or to the
    dict of this thread's :func:`held` context."""
    counts = getattr(_local, "held", None)
    if counts is None:
        counts = _counters
    counts[name] = counts.get(name, 0) + n


def add(counts: Dict[str, int]) -> None:
    """Add each of ``counts`` to its counter."""
    for name, n in counts.items():
        count(name, n)


@contextlib.contextmanager
def held():
    """A context whose counts in this thread go to the dict it yields
    instead of the counters (a graph's capture: its replays :func:`add`
    them); other threads count as before."""
    outer, _local.held = getattr(_local, "held", None), {}
    try:
        yield _local.held
    finally:
        _local.held = outer


def host_read(site: str):
    """Count a device-to-host read at ``site`` as ``host_reads.<site>``;
    returns the span ``host_read.<site>`` to hold around it."""
    count("host_reads." + site)
    return span("host_read." + site)


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_counters)


def reset_counters() -> None:
    _counters.clear()


def drain() -> List[Record]:
    """The closed spans, in the order they opened; clears them."""
    out = [Record._make(r) for r in sorted(_records, key=lambda r: r[2])]
    _records.clear()
    return out


def self_ns(spans: List[Record]) -> Dict[int, int]:
    """{span id: its duration minus the part its child spans cover} over
    ``spans`` (children of one thread do not overlap)."""
    out = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out
