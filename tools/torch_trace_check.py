#!/usr/bin/env python3
"""Checks on the card that the port's spans (``viterbidecodercpp_torch.trace``)
lie on ``torch.profiler``'s device timeline, at the batch decode of Voyager
SOFT8 (B=1024 frames of 2048 bits):

1. the anchor: ``--anchors`` spans, each around one rotated-ACS launch
   and ``torch.cuda.synchronize()``, 1 ms apart, the first dropped.  On
   the trace's own clock (an instant's offset from ``trace_start_ns()``)
   each span's end lies ``raw`` microseconds after its kernel's end;
   the line fitted through those points gives the two clocks' relative
   rate (``rate_ppm``), and nine spans in ten end within ``--anchor-us``
   of that line (``residual``; its largest is printed) -- the placement
   ``bench_port/spans.py`` makes from the anchors around a window;
2. the launch counters: ``launches.rotated_acs`` and
   ``launches.chainback`` over a profiled window of ``--calls`` decode
   calls equal the trace's counts of ``rotated_acs*`` and ``chainback*``
   kernels in it;
3. the decode span: the median ``decoder.decode`` span of those calls and
   the median of the same calls timed from outside (the host clock around
   each call, no synchronise) agree within 10%.

It also times decode calls under the profiler with the recorder off and
on, in turns (``cost``: calls a second and the median call).  It prints
one JSON object and exits 0 when the three checks hold, 1 otherwise or
without a card.

    python3 tools/torch_trace_check.py [--anchors N] [--calls N]
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import viterbidecodercpp_torch as pt  # noqa: E402
from viterbidecodercpp_torch import trace  # noqa: E402
from viterbidecodercpp_torch.ops import rotated, torch_core  # noqa: E402

B, NBITS = 1024, 2048


def _profiled(body):
    """Run ``body()`` under a CUDA-only profile with the recorder on;
    returns (spans, [(start_us, end_us, name)] of device events, the
    trace's start in ns)."""
    from torch.profiler import ProfilerActivity, profile

    trace.drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace.enable()
        try:
            body()
            torch.cuda.synchronize()
        finally:
            trace.disable()
    cpu = torch.autograd.DeviceType.CPU
    events = [(e.time_range.start, e.time_range.end, e.name)
              for e in prof.events()
              if getattr(e, "device_type", None) != cpu]
    return trace.drain(), events, \
        prof.profiler.kineto_results.trace_start_ns()


def anchor(dec, syms, n: int) -> dict:
    """Microseconds from each launch's kernel end to its span's end on
    the trace's own clock, the first launch dropped, and the line fitted
    through them."""
    spec = dec.spec
    m0 = torch_core.initial_metrics(spec, B, 0, syms.device)
    x = torch.clamp(syms.to(torch.int32), spec.soft_low,
                    spec.soft_high).reshape(B, -1, spec.R).contiguous()
    rotated.acs_rotated(spec, m0, x)
    torch.cuda.synchronize()

    def body():
        for _ in range(n):
            with trace.span("anchor"):
                rotated.acs_rotated(spec, m0, x)
                torch.cuda.synchronize()
            time.sleep(0.001)

    spans, events, start_ns = _profiled(body)
    kernels = sorted(e for e in events if "rotated_acs" in e[2])
    anchors = [s for s in spans if s.name == "anchor"]
    if len(kernels) != len(anchors):
        raise RuntimeError(f"{len(kernels)} rotated-ACS kernels in the "
                           f"trace for {len(anchors)} anchor spans")
    # the i-th span launched the i-th kernel
    host = [(s.end_ns - start_ns) / 1e3 for s in anchors][1:]
    raw = [h - k[1] for h, k in zip(host, kernels[1:])]
    slope, icept = statistics.linear_regression(host, raw)
    resid = [r - (icept + slope * h) for h, r in zip(host, raw)]
    dec = statistics.quantiles(resid, n=10)
    return {"raw": {"min": min(raw), "median": statistics.median(raw),
                    "max": max(raw)},
            "rate_ppm": slope * 1e6,
            "residual": {"min": min(resid), "p10": dec[0],
                         "median": statistics.median(resid), "p90": dec[-1],
                         "max": max(resid)},
            "n": len(raw)}


def cost(dec, pool, rounds: int, seconds: float) -> dict:
    """Decode calls a second and the median call (ms), back to back under
    the profiler, with the recorder off and on in turns."""
    from torch.profiler import ProfilerActivity, profile

    out = {"off": [], "on": []}
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(rounds):
            for side in ("off", "on"):
                if side == "on":
                    trace.enable()
                calls, lat = 0, []
                t_end = time.perf_counter() + seconds
                while True:
                    t0 = time.perf_counter()
                    if t0 >= t_end:
                        break
                    dec.decode(pool[calls % len(pool)], NBITS)
                    lat.append(time.perf_counter() - t0)
                    calls += 1
                    if calls % 4 == 0:
                        torch.cuda.synchronize()
                torch.cuda.synchronize()
                trace.disable()
                trace.drain()
                out[side].append([calls / seconds,
                                  statistics.median(lat) * 1e3])
    return out


def counts(dec, pool, calls: int) -> dict:
    """The launch counters, the trace's kernel counts and the decode
    medians of ``calls`` decode calls."""
    outside = []

    def body():
        for i in range(calls):
            t0 = time.perf_counter()
            dec.decode(pool[i % len(pool)], NBITS)
            outside.append(time.perf_counter() - t0)

    trace.reset_counters()
    spans, events, _ = _profiled(body)
    c = trace.counters()
    decode = [(s.end_ns - s.start_ns) / 1e9 for s in spans
              if s.name == "decoder.decode"]
    return {"launches.rotated_acs": c.get("launches.rotated_acs", 0),
            "trace.rotated_acs": sum("rotated_acs" in e[2] for e in events),
            "launches.chainback": c.get("launches.chainback", 0),
            "trace.chainback": sum("chainback" in e[2] for e in events),
            "decode_span_ms": statistics.median(decode) * 1e3,
            "decode_outside_ms": statistics.median(outside) * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--anchors", type=int, default=50)
    ap.add_argument("--anchor-us", type=float, default=50.0)
    ap.add_argument("--calls", type=int, default=400)
    ap.add_argument("--cost-rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_trace_check: no CUDA device", file=sys.stderr)
        return 1
    code = pt.get_code("Voyager")
    dec = pt.ViterbiDecoder(code, "SOFT8", device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    T = (NBITS + code.K - 1) * code.R
    pool = [torch.randint(-127, 128, (B, T), generator=gen,
                          dtype=torch.int8, device="cuda") for _ in range(8)]
    for x in pool:
        dec.decode(x, NBITS)
    torch.cuda.synchronize()
    out = {"card": torch.cuda.get_device_name(),
           "anchor_us": anchor(dec, pool[0], args.anchors)}
    out.update(counts(dec, pool, args.calls))
    out["cost"] = cost(dec, pool, args.cost_rounds, 1.0)
    res = out["anchor_us"]["residual"]
    ok = {"anchor": max(-res["p10"], res["p90"]) <= args.anchor_us,
          "rotated_acs": out["launches.rotated_acs"]
          == out["trace.rotated_acs"] == args.calls,
          "chainback": out["launches.chainback"]
          == out["trace.chainback"] == args.calls,
          "decode": abs(out["decode_span_ms"] / out["decode_outside_ms"] - 1)
          <= 0.10}
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
