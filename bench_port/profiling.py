"""A ``torch.profiler`` window on the card and what the benchmark reads from
it: the device's busy time and idle share, each device operation's time
and count, and the longest idle gaps.

The busy and idle arithmetic (``WARMUP`` profiled steps dropped before
the window, ``idle_share``, the self device time of an event, and which
events count) is a frozen copy of ``tools/torch_profile_trace.py`` lines
41-56, 81-95 and 101-125.  Only CUDA activity is recorded, so the host
pays for no CPU-op instrumentation.  No chrome trace is written.
"""

from __future__ import annotations

import re
import time
from typing import Callable

import torch

__all__ = ["WARMUP", "TOP", "WINDOW_S", "idle_share", "trace_window",
           "short_name"]

TOP = 10
# the traced window's length at most: reading the profiler's events costs
# ~7 s a second of a busy window, and each run has 360 s
WINDOW_S = 5.0
# steps profiled before the window and dropped: the profiler can lose a
# window's first device events
WARMUP = 2


def idle_share(busy_us: float, window_us: float) -> float:
    """1 - busy / window; raises where that falls outside [0, 1]."""
    share = 1 - busy_us / window_us
    if not 0 <= share <= 1:
        raise RuntimeError(
            f"device idle share {share:.4f} outside [0, 1] ({busy_us:.1f} us "
            f"of device operations in a {window_us:.1f} us window): the "
            f"window counted operations it did not hold")
    return share


def _self_us(e) -> float:
    us = getattr(e, "self_device_time_total", None)
    if us is None:
        us = getattr(e, "self_cuda_time_total", 0)
    return us


def _counted(e) -> bool:
    # an aten:: operator's self device time is that of the kernels it
    # launched, which appear under their own names: count those only; the
    # step markers are the profiler's own
    if e.key.startswith("ProfilerStep"):
        return False
    return _self_us(e) > 0 and not e.key.startswith("aten::")


# words of a long template name that say nothing of what the kernel does
_GENERIC = {"at", "native", "detail", "memory", "std", "array", "char", "int",
            "unsigned", "long", "ul", "lambda", "operator", "const", "anon",
            "true", "false", "c10", "Scalar", "TensorIteratorBase",
            "gpu_kernel_impl_nocast", "TrivialOffsetCalculator",
            "LoadWithCast", "StoreWithCast", "ReduceOp", "BUnaryFunctor",
            "AUnaryFunctor", "BinaryFunctor", "ClampLimits"}


def short_name(name: str) -> str:
    """A device operation's name without its return type and argument
    list; a long template name keeps its first telling word."""
    name = re.sub(r"^void ", "", name.strip()).replace(
        "(anonymous namespace)", "anon")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            name = name[:i].rstrip()
            break
    if len(name) > 60 and "<" in name:
        base, args = name.split("<", 1)
        words = [w for w in re.findall(r"[A-Za-z_]\w*", args)
                 if w not in _GENERIC]
        name = f"{base}<{words[0]}>" if words else base
    return name or "(unnamed device operation)"


def _gaps(prof, top: int) -> list:
    """[[name, seconds]]: the device's idle time between its operations,
    summed by the operation that ended each gap (the host was issuing the
    work that led to it), the longest first."""
    spans = []
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU:
            continue
        r = e.time_range
        spans.append((r.start, r.end, e.name))
    spans.sort()
    idle = {}
    end = None
    for s, t, name in spans:
        if end is not None and s > end:
            key = f"host before {short_name(name)}"
            idle[key] = idle.get(key, 0.0) + (s - end) / 1e6
        end = t if end is None else max(end, t)
    return sorted(([k, v] for k, v in idle.items()),
                  key=lambda kv: -kv[1])[:top]


def trace_window(warm: Callable[[], None],
                 window: Callable[[float], dict]) -> dict:
    """Profile ``window(seconds)``, ``WINDOW_S`` seconds of the cell's
    traffic, on the current card after ``WARMUP`` profiled calls of
    ``warm()`` that are dropped.  Returns ``window()``'s dict
    with ``busy_s``, ``window_s``, ``idle_share``, ``kernels`` ({name:
    [count, seconds]} of every counted device operation), ``device_events``
    (their count), ``device_ops`` and ``idle_gaps`` (the top ``TOP``,
    [[name, seconds]])."""
    from torch.profiler import ProfilerActivity, profile, schedule
    sched = schedule(wait=0, warmup=WARMUP, active=1, repeat=1)
    with profile(activities=[ProfilerActivity.CUDA], schedule=sched) as prof:
        # the warm-up's device work ends before the window opens, and the
        # window's before it closes
        for _ in range(WARMUP):
            warm()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        out = window(WINDOW_S)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    ops = [e for e in prof.key_averages() if _counted(e)]
    ops.sort(key=_self_us, reverse=True)
    busy = sum(_self_us(e) for e in ops)
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time in the window")
    out.update(
        busy_s=busy / 1e6, window_s=window_us / 1e6,
        idle_share=idle_share(busy, window_us),
        kernels={e.key: [e.count, _self_us(e) / 1e6] for e in ops},
        device_events=sum(e.count for e in ops),
        device_ops=[[short_name(e.key), _self_us(e) / 1e6]
                    for e in ops[:TOP]],
        idle_gaps=_gaps(prof, TOP))
    return out
