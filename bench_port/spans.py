"""The program's own spans on the card's timeline: where the host was while
the device sat idle, and what each layer of a call costs on the host.

``span_window(warm, window)`` profiles ``SPAN_WINDOW_S`` seconds of a
cell's traffic as ``profiling.trace_window`` does (CUDA activity only,
``profiling.WARMUP`` dropped steps, the same counted device operations),
with the program's recorder (``viterbidecodercpp_torch.trace``) on.  The
recorder's spans read ``time.time_ns()``, the clock of the profiler's
events, and are placed on the trace by its ``trace_start_ns()``.  Each
idle gap of the device between consecutive counted operations is split
over the innermost program span open on the host at each instant; time
under no span goes to ``caller`` (the benchmark's own loop).

The per-layer readers of a traced run call ``of(rec)``, which runs one
such window for the cell of this process's command line
(``bench_port/run.py --workload <cell> --seed <n> ...``), after every
other number of the run has been taken: the traffic's own set-up and
loop again, on fresh inputs from the same seed, and for the cell on
several cards a fleet of ranks that runs this file as a script.  A
program without the recorder gives nothing to read (None).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Optional

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port import harness, profiling  # noqa: E402

__all__ = ["SPAN_WINDOW_S", "CALLER", "span_window", "device_ops",
           "idle_gaps", "segments", "split_idle", "per_call", "of",
           "median_ms"]

SPAN_WINDOW_S = 2.0
CALLER = "caller"
# the window's anchors: ANCHORS adds on a float64 scalar, each followed by
# a synchronise, at each end; no traffic runs a float64 kernel.  GUARD
# multiplies on it follow the last: the profiler was seen to drop up to
# ~2,100 of the last events of a window on the card (and a few inside
# it), and those are then the guard's, not the anchors'
ANCHORS = 3
ANCHOR_KERNEL = "CUDAFunctorOnSelf_add<double>"
MARKER = "<double>"
GUARD = 8000
TOKEN = "SPAN_WINDOW_RESULT "
TOP = 10


# -- arithmetic on the trace and the spans (no card needed) -----------------

def device_ops(prof) -> list:
    """[(start_us, end_us, name)] of the window's counted device
    operations (``profiling._counted``'s: no profiler step, no aten
    operator, no empty event), on the trace's clock, by start."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    out = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events()
           if getattr(e, "device_type", None) != cpu
           and not e.name.startswith(("ProfilerStep", "aten::"))
           and e.time_range.end > e.time_range.start]
    out.sort()
    return out


def idle_gaps(ops) -> list:
    """[(start, end)]: the device's idle time between consecutive
    operations ``ops`` ([(start, end, ...)] by start)."""
    gaps, end = [], None
    for s, t, *_ in ops:
        if end is not None and s > end:
            gaps.append((end, s))
        end = t if end is None else max(end, t)
    return gaps


def _label(s) -> str:
    return s.name if s.detail is None else f"{s.name}({s.detail})"


def segments(spans, clock: Callable[[int], float] = None) -> list:
    """[(start_us, end_us, label)]: the host's time under ``spans``
    (``trace.Record``s of one thread), cut where the innermost open span
    changes, by start, each instant mapped by ``clock`` (ns -> us; by
    default ns / 1000)."""
    ids = {s.id for s in spans}
    kids, roots = {}, []
    for s in sorted(spans, key=lambda s: (s.start_ns, s.id)):
        if s.parent in ids:
            kids.setdefault(s.parent, []).append(s)
        else:
            roots.append(s)
    out = []
    us = clock or (lambda ns: ns / 1e3)

    def walk(s):
        t = s.start_ns
        for c in kids.get(s.id, ()):
            if c.start_ns > t:
                out.append((us(t), us(c.start_ns), _label(s)))
            walk(c)
            t = max(t, c.end_ns)
        if s.end_ns > t:
            out.append((us(t), us(s.end_ns), _label(s)))

    for r in roots:
        walk(r)
    return out


def split_idle(gaps, segs) -> dict:
    """{label: seconds}: each gap of ``gaps`` ([(start_us, end_us)], by
    start, disjoint) split over the segments ``segs`` (``segments``) that
    cover it, ``CALLER`` where none does.  The values sum to the gaps'
    total."""
    out = {}

    def add(label, a, b):
        out[label] = out.get(label, 0.0) + (b - a) / 1e6

    i = 0
    for g0, g1 in gaps:
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        t, j = g0, i
        while t < g1:
            if j < len(segs) and segs[j][0] < g1:
                s0, s1, label = segs[j]
                if s0 > t:
                    add(CALLER, t, s0)
                    t = s0
                e = min(s1, g1)
                if e > t:
                    add(label, t, e)
                    t = e
                j += 1
            else:
                add(CALLER, t, g1)
                t = g1
    return out


def per_call(spans, self_ns: dict) -> dict:
    """{root name: {"total": [seconds a call], "self": {span name:
    [seconds a call of its spans' self time]}}}, the lists aligned by
    call (0 where a call has no such span)."""
    roots = {s.id: s for s in spans if s.id == s.call}
    sums = {}
    for s in spans:
        if s.call in roots:
            d = sums.setdefault(s.call, {})
            d[s.name] = d.get(s.name, 0) + self_ns[s.id]
    out = {}
    for cid in sorted(sums):
        r = roots[cid]
        o = out.setdefault(r.name, {"total": [], "self": {}})
        n = len(o["total"])
        o["total"].append((r.end_ns - r.start_ns) / 1e9)
        for name, ns in sums[cid].items():
            o["self"].setdefault(name, [0.0] * n).append(ns / 1e9)
        for v in o["self"].values():
            v.extend([0.0] * (n + 1 - len(v)))
    return out


def median_ms(values) -> Optional[float]:
    return statistics.median(values) * 1e3 if values else None


def host_clock(pairs) -> tuple:
    """(clock, rate): the least-squares line through ``pairs`` ([(host
    ns, trace us)]) as a map ns -> us, and the trace clock's rate against
    the host's less 1 (None where the pairs span no time: the line then
    keeps the host's rate)."""
    h0 = pairs[0][0]
    xs = [(h - h0) / 1e3 for h, _ in pairs]
    ys = [u for _, u in pairs]
    if max(xs) > min(xs):
        slope, icept = statistics.linear_regression(xs, ys)
        rate = slope - 1
    else:
        slope, icept, rate = 1.0, statistics.fmean(ys) - xs[0], None
    return (lambda ns: icept + slope * (ns - h0) / 1e3), rate


def anchor_pairs(heads, tails, marks, ops) -> list:
    """[(host ns, trace us)]: each anchor's host instant (after its
    synchronise; ``heads`` before the window, ``tails`` after) beside its
    kernel's end among ``marks`` ([(start, end, name)] by start); the
    window's operations ``ops`` divide the two groups.  Where the
    profiler dropped anchors, the heads lose their first and the tails
    their last."""
    first = ops[0][0] if ops else float("inf")
    last = ops[-1][1] if ops else float("-inf")
    head = [m[1] for m in marks if m[1] <= first][-len(heads):]
    tail = [m[1] for m in marks if m[0] >= last][:len(tails)]
    return list(zip(heads[len(heads) - len(head):], head)) + \
        list(zip(tails, tail))


# -- the window on the card -------------------------------------------------

def _has_recorder() -> bool:
    if importlib.util.find_spec("viterbidecodercpp_torch.trace") is None:
        print("span window: the program has no recorder "
              "(viterbidecodercpp_torch.trace); nothing to read",
              file=sys.stderr)
        return False
    return True


def span_window(warm: Callable[[], None], window: Callable[[float], dict],
                device: str = "cuda") -> Optional[dict]:
    """Profile ``window(SPAN_WINDOW_S)`` with the program's recorder on,
    after ``profiling.WARMUP`` profiled calls of ``warm()`` that are
    dropped.  The window lies between two groups of ``ANCHORS`` anchors,
    each a small kernel and a synchronise: the host's instant after each
    and its kernel's end in the trace fix the line that places the spans
    on the trace (``anchor_pairs``, ``host_clock``).  Returns
    ``window()``'s dict with ``window_s``, ``spans`` (their count),
    ``idle_s`` (the device's idle seconds between its counted
    operations), ``idle_by_span`` ({label: seconds}, ``CALLER``
    included), ``idle_in_program_s``, ``per_call``, ``counters`` (each
    counter's increase over the window), ``device_counts`` ({short name:
    events}), ``launch_check`` ({launch counter: [its increase, the
    trace's events of that kernel]}) and ``clock``: the anchors found at each end, how far the
    trace's own start (``trace_start_ns()``) would have put each
    (``offset_us``), each one's distance from the line (``residual_us``)
    and the trace clock's rate against the host's (``rate_ppm``).  None
    when the program has no recorder.  On the CPU (``device="cpu"``, a
    rehearsal) there are no device operations."""
    if not _has_recorder():
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from viterbidecodercpp_torch import trace

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    mark = torch.zeros(1, dtype=torch.float64, device=device)

    def anchors() -> list:
        out = []
        for _ in range(ANCHORS):
            mark.add_(1)
            sync()
            out.append(time.time_ns())
        return out

    sched = schedule(wait=0, warmup=profiling.WARMUP, active=1, repeat=1)
    # the CPU's own activity only in a rehearsal, where there is no card
    act = ProfilerActivity.CUDA if device == "cuda" else ProfilerActivity.CPU
    with profile(activities=[act], schedule=sched) as prof:
        for _ in range(profiling.WARMUP):
            warm()
            sync()
            prof.step()
        trace.drain()
        before = trace.counters()
        heads = anchors()
        trace.enable()
        try:
            t0 = time.perf_counter()
            out = window(SPAN_WINDOW_S)
            sync()
            window_s = time.perf_counter() - t0
        finally:
            trace.disable()
        tails = anchors()
        for _ in range(GUARD):
            mark.mul_(1)
        sync()
        prof.step()
    spans = trace.drain()
    after = trace.counters()
    every = device_ops(prof)
    ops = [o for o in every if MARKER not in o[2]]
    marks = [o for o in every if ANCHOR_KERNEL in o[2]]
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    pairs = anchor_pairs(heads, tails, marks, ops)
    found = [sum(1 for h, _ in pairs if h in heads),
             sum(1 for h, _ in pairs if h in tails)]
    if pairs:
        # anchors at one end only fix the offset, not the rate
        clock, rate = host_clock(pairs if all(found) else pairs[:1])
        out["clock"] = {
            "anchors": found,
            "offset_us": [u - (h - start_ns) / 1e3 for h, u in pairs],
            "residual_us": [u - clock(h) for h, u in pairs],
            "rate_ppm": None if rate is None else rate * 1e6}
    else:
        # a rehearsal on the CPU (no device operation) or no anchor found:
        # the trace's own start
        def clock(ns):
            return (ns - start_ns) / 1e3
    gaps = idle_gaps(ops)
    idle = split_idle(gaps, segments(spans, clock))
    counts = {}
    for _, _, name in ops:
        name = profiling.short_name(name)
        counts[name] = counts.get(name, 0) + 1
    grown = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    # each kernel launch the program counted against its events in the
    # trace: a shortfall is events the profiler dropped
    out["launch_check"] = {
        k: [n, sum(v for name, v in counts.items()
                   if k[len("launches."):] in name)]
        for k, n in grown.items() if k.startswith("launches.")}
    top = sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])
    out.update(
        window_s=window_s, spans=len(spans),
        idle_s=sum((b - a) for a, b in gaps) / 1e6, idle_by_span=idle,
        idle_in_program_s=sum(v for k, v in idle.items() if k != CALLER),
        per_call=per_call(spans, trace.self_ns(spans)),
        counters=grown,
        device_counts=counts)
    roots = {k: median_ms(v["total"]) for k, v in out["per_call"].items()}
    print(f"span window: {out.get('calls')} calls in {window_s:.4f} s "
          f"(outside median {out.get('enqueue_ms')} ms), "
          f"{len(spans)} spans, median ms a root span {json.dumps(roots)}, "
          f"counters {json.dumps(out['counters'])}, device operations "
          f"{json.dumps(counts)}, launches against events "
          f"{json.dumps(out['launch_check'])}, "
          f"clock {json.dumps(out.get('clock'))}; "
          f"device idle {out['idle_s']:.6f} s by span "
          f"(top {TOP}): {json.dumps(top[:TOP])}", file=sys.stderr,
          flush=True)
    return out


# -- the cells --------------------------------------------------------------

def of(rec: dict) -> Optional[list]:
    """The span windows of a traced run's record (one a card: a list),
    measured at the first call and kept in ``rec["spans"]``; None for an
    untraced record, a process not started as ``bench_port/run.py`` or a
    program without the recorder."""
    if "spans" not in rec:
        rec["spans"] = _measure(rec) if "trace" in rec else None
    return rec["spans"]


def _command_run() -> Optional[harness.Run]:
    """The run of this process's command line, if it is
    ``bench_port/run.py --workload <cell> --seed <n> ... --trace 1``."""
    if Path(sys.argv[0]).name != "run.py":
        return None
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int)
    args, _ = ap.parse_known_args(sys.argv[1:])
    if args.workload is None or args.seed is None or args.trace != 1:
        return None
    return harness.Run(harness.find_cell(args.workload), args.seed,
                       args.seconds or 0.0, True, "cuda", time.time())


def _measure(rec: dict) -> Optional[list]:
    run = _command_run()
    if run is None or not _has_recorder():
        return None
    traffic = run.cell.entry["traffic"]
    print(f"span window: {run.cell.name}, a second set-up for "
          f"{SPAN_WINDOW_S} s of traffic with the recorder on",
          file=sys.stderr, flush=True)
    if traffic == "sp_decode":
        out = _fleet(run)
    else:
        out = [{"batch_decode": _batch, "stream_push": _stream}[traffic](run)]
    t = rec["trace"]
    for i, o in enumerate(out):
        print(f"span window, rank {i}: {o['calls'] / o['window_s']:.2f} "
              f"calls/s with spans, {t['calls'] / t['window_s']:.2f} in "
              f"the trace window (rank 0) without", file=sys.stderr)
    return out


def _traffic(run):
    return harness.load_module(run.cell.bench_dir / "traffic"
                               / f"{run.cell.entry['traffic']}.py")


def _batch(run) -> dict:
    import torch

    mod, p = _traffic(run), run.cell.params
    dec, pool, _, shape = mod._setup(run)
    nbits = shape["data_bits"]
    for i in range(int(p["warmup"])):
        dec.decode(pool[i % len(pool)], nbits)
    if run.device == "cuda":
        torch.cuda.synchronize()
    def window(seconds):
        # the same calls timed from outside, as decoder.enqueue_ms times
        # the untraced window's
        enqueue = []
        n = mod._loop(dec, pool, nbits, seconds, enqueue=enqueue)
        return {"calls": n, "enqueue_ms": median_ms(enqueue)}

    return span_window(lambda: dec.decode(pool[0], nbits), window,
                       run.device)


def _stream(run) -> dict:
    mod, p = _traffic(run), run.cell.params
    sd, pool, _, shape = mod._setup(run)
    B, P = shape["B"], shape["pass_pushes"]
    state = sd.reset(B)
    for j in range(int(p["warmup"])):
        state, bits, _ = sd.push(state, pool[0][j % P])
        bits.cpu()

    def warm():
        sd.push(sd.reset(B), pool[0][0])[1].cpu()

    return span_window(warm, lambda s: {"calls": mod._loop(sd, pool, s)},
                       run.device)


def _fleet(run) -> list:
    from viterbidecodercpp_torch.parallel import launch

    world = int(run.cell.params["ranks"])
    here = str(Path(__file__).resolve())

    def cmd(rank, init_method):
        return [sys.executable, here, "--bench-dir", str(run.cell.bench_dir),
                "--workload", run.cell.name, "--seed", str(run.seed),
                "--seconds", repr(SPAN_WINDOW_S), "--device", run.device,
                "--init-method", init_method,
                "--world", str(world), "--rank", str(rank)]

    outs = launch.spawn_fleet(cmd, world,
                              timeout=float(run.cell.params["timeout"]))
    ranks = []
    for r, text in enumerate(outs):
        lines = text.splitlines()
        hits = [ln for ln in lines if ln.startswith(TOKEN)]
        if not hits:
            raise RuntimeError(f"span window rank {r} printed no result:\n"
                               f"{text}")
        ranks.append(json.loads(hits[-1][len(TOKEN):]))
        rest = [ln for ln in lines if not ln.startswith(TOKEN)]
        if rest:
            print(f"--- span window rank {r} ---\n" + "\n".join(rest),
                  file=sys.stderr)
    return ranks


def _rank(args) -> None:
    """One rank of the time-tiled cell's span window: the traffic's
    stream and tile, its warm-up, a count of back-to-back calls fixed from
    rank 0's probe, then the window."""
    import torch
    import torch.distributed as dist

    from viterbidecodercpp_torch.ops import torch_core
    from viterbidecodercpp_torch.parallel import block_sp, launch
    from viterbidecodercpp_torch.parallel.mesh import make_mesh

    cell = harness.find_cell(args.workload, Path(args.bench_dir))
    run = harness.Run(cell, args.seed, SPAN_WINDOW_S, True, args.device,
                      time.time())
    p = cell.params
    dev = launch.initialize(args.init_method, args.world, args.rank,
                            device=args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    try:
        mesh = make_mesh((args.world,), ("time",), dev.type)
        code, dconf, _, arr, T = _traffic(run)._stream(run, dev, args.world)
        tile = launch.local_block(arr, mesh, (None, "time", None)) \
            .contiguous()
        del arr
        spec = torch_core.make_static_spec(code, dconf)

        def call():
            block_sp.decode_stream_sp(spec, mesh, tile,
                                      overlap=int(p["overlap"]),
                                      total_rows=T, device=dev)

        for _ in range(int(p["warmup"])):
            call()
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(int(p["probe"])):
            call()
        sync()
        per_call = torch.tensor([(time.perf_counter() - t0)
                                 / int(p["probe"])], dtype=torch.float64,
                                device=dev)
        dist.broadcast(per_call, src=0)
        per_call = float(per_call.item())
        dist.barrier()

        def window(seconds):
            n = max(1, round(seconds / per_call))
            for _ in range(n):
                call()
            return {"calls": n}

        out = span_window(call, window, dev.type)
        print(TOKEN + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def _main(argv=None) -> None:
    global SPAN_WINDOW_S
    ap = argparse.ArgumentParser(description="one rank of the span window "
                                 "of a time-tiled cell (started by the "
                                 "benchmark)")
    ap.add_argument("--bench-dir", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    args = ap.parse_args(argv)
    SPAN_WINDOW_S = args.seconds
    _rank(args)


if __name__ == "__main__":
    _main()
