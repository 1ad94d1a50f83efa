#!/usr/bin/env python3
"""Throughput benchmark on the PyTorch port (the twin of
tools/run_benchmark.py, parity with examples/run_benchmark.cpp).

For each (code, decode type, route) it times the ACS update and the
chainback apart and writes JSON rows in the reference's schema
(run_benchmark.cpp:297-327): name, decode_type, simd_type, K, R, G,
batch, total_input_bits, total_symbols, update_symbols_ns and
chainback_bits_ns (lists of per-sample times in ns), so that
tools/parse_benchmark.py and tools/compare_benchmark.py read them
unmodified.  Each row also names its ``device``.

``simd_type`` is the route: ``ROTATED``, ``PLANE`` or ``LANE`` (the
kernels the decoder picks by state count: rotated ACS + slot-order walk,
plane ACS + plane walk, lane ACS + state-order walk) or ``TORCH`` (the
plain state-order scan and walk).  On the card the kernel routes launch
the CUDA kernels; with ``--cpu`` every route runs its plain version on
the CPU.

Timing: the carries are chained, so no call can be hoisted out of a
loop: each update's output metrics feed the next update, and each
chainback's end state comes from the previous call's bits.  A sample is
the marginal time a repetition between two rep counts, (t(reps) -
t(1)) / (reps - 1), with ``reps`` calibrated as the JAX tool does (the
smallest 17 x 8^k whose loop takes 0.15 s more than one call).  On the
card t is taken by CUDA events, on the CPU by the host clock.

    python3 tools/torch_run_benchmark.py -c 0 -d soft8 -T 0.5        # card
    python3 tools/torch_run_benchmark.py --cpu -c 0 -d soft8 -B 2 -M 4 -T 0.1

Flags: -c code index, -d decode type, -s route (``cuda``: the kernel
route, ``torch``: the plain scan; default both), -B frames a batch, -M
input bytes a frame, -T seconds a combination, -o out.json, -l/--list the
registry, ``--cpu``.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np
import torch

import viterbidecodercpp_torch as pt
from viterbidecodercpp_torch.decoder import select_backend
from viterbidecodercpp_torch.ops import (chainback, lane, plane, rotated,
                                         torch_core)

REPS = 17            # the first calibration count (run_benchmark.py)
MIN_LOOP_S = 0.15    # t(reps) - t(1) a calibrated loop must exceed


def print_code_list(file=None):
    """Print the common-code registry like cli_print_codes
    (cli_filters.h:68-86): ID | name | K R | coefficients."""
    file = file or sys.stderr
    width = max(len(c.name) for c in pt.COMMON_CODES)
    print(f"ID | {'Name':>{width}} |  K  R | Coefficients", file=file)
    for i, code in enumerate(pt.COMMON_CODES):
        coeffs = ",".join(str(g) for g in code.G)
        print(f"{i:2d} | {code.name:>{width}} | {code.K:2d} {code.R:2d} | "
              f"[{coeffs}]", file=file)


def _route_fns(spec, route: str, total_bits: int):
    """(acs(m, syms) -> (m, packed, acc), walk(packed, ends) -> bits) of
    a route: the functions the decoder's update and chainback call."""
    if route == "rotated":
        return (lambda m, s: rotated.acs_rotated(spec, m, s),
                lambda p, e: chainback.chainback(spec, p, e, total_bits,
                                                 slot_order=True))
    if route == "plane":
        return (lambda m, s: plane.acs_plane(spec, m, s),
                lambda p, e: plane.chainback_plane(spec, p, e, total_bits))
    if route == "lane":
        return (lambda m, s: lane.acs_lane(spec, m, s),
                lambda p, e: chainback.chainback(spec, p, e, total_bits))
    return (lambda m, s: torch_core.acs_scan(spec, m, s),
            lambda p, e: torch_core.chainback_scan(spec, p, e, total_bits))


def _timer(device: torch.device):
    """t(fn): seconds of one call of ``fn``, ending on the device."""
    if device.type == "cuda":
        def timed(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
    else:
        def timed(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
    return timed


def bench_combo(code: pt.CodeSpec, decode_type: pt.DecodeType, route: str,
                batch: int, nbytes: int, seconds: float, device) -> dict:
    """Time ``route``'s update and chainback for one code and decode type;
    one row of the reference schema."""
    device = torch.device(device)
    config = pt.get_decode_config(decode_type, code.R)
    spec = torch_core.make_static_spec(code, config)
    total_bits = nbytes * 8
    T = total_bits + code.K - 1
    rng = np.random.RandomState(0)
    syms = torch.as_tensor(rng.randint(config.soft_decision_low,
                                       config.soft_decision_high + 1,
                                       (batch, T, code.R)).astype(np.int32),
                           device=device)
    m0 = torch_core.initial_metrics(spec, batch, 0, device)
    ends = torch.zeros(batch, dtype=torch.int32, device=device)
    acs, walk = _route_fns(spec, route, total_bits)
    timed = _timer(device)

    def update_n(reps):
        m = m0
        for _ in range(reps):
            m, _, _ = acs(m, syms)
        return m

    _, packed, _ = acs(m0, syms)

    def chainback_n(reps):
        e = ends
        for _ in range(reps):
            bits = walk(packed, e)
            e = torch.clamp(bits[:, 0].to(torch.int32), max=spec.S - 1)
        return e

    # warm-up: builds and loads the kernels, fills the caches
    update_n(1)
    chainback_n(1)

    def calibrate(fn):
        reps = REPS
        while reps < (1 << 20):
            t1 = timed(lambda: fn(1))
            tn = timed(lambda: fn(reps))
            if tn - t1 > MIN_LOOP_S:
                return reps
            reps *= 8
        return reps

    u_reps = calibrate(update_n)
    c_reps = calibrate(chainback_n)
    update_ns, chainback_ns = [], []
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        u1 = timed(lambda: update_n(1))
        un = timed(lambda: update_n(u_reps))
        update_ns.append(max(int((un - u1) / (u_reps - 1) * 1e9), 1))
        c1 = timed(lambda: chainback_n(1))
        cn = timed(lambda: chainback_n(c_reps))
        chainback_ns.append(max(int((cn - c1) / (c_reps - 1) * 1e9), 1))
    return {
        "name": code.name,
        "decode_type": decode_type.value,
        "simd_type": route.upper(),
        "K": code.K,
        "R": code.R,
        "G": list(code.G),
        "batch": batch,
        "total_input_bits": batch * total_bits,
        "total_symbols": batch * T * code.R,
        "update_symbols_ns": update_ns,
        "chainback_bits_ns": chainback_ns,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }


def run(codes, decode_types, routes, batch: int, nbytes: int,
        seconds: float, device, log=None) -> list:
    """Rows for every (code, decode type, route); ``routes`` holds
    ``"cuda"`` (the route the decoder picks) and/or ``"torch"``."""
    device = torch.device(device)
    rows = []
    for code in codes:
        for dt in decode_types:
            spec = torch_core.make_static_spec(
                code, pt.get_decode_config(dt, code.R))
            for r in routes:
                route = select_backend(spec, device) if r == "cuda" else r
                if log:
                    log(f"benchmarking {code.name} {dt.value} "
                        f"{route.upper()}...")
                rows.append(bench_combo(code, dt, route, batch, nbytes,
                                        seconds, device))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", type=int, default=None, help="code index filter")
    ap.add_argument("-d", default=None, choices=["soft16", "soft8", "hard8"])
    ap.add_argument("-s", default=None, choices=["cuda", "torch"],
                    help="route: the kernel route the decoder picks "
                         "(plain versions with --cpu) or the plain scan; "
                         "default both")
    ap.add_argument("-B", type=int, default=512, help="frames per batch")
    ap.add_argument("-M", type=int, default=256, help="input bytes/frame")
    ap.add_argument("-T", type=float, default=2.0, help="seconds per combo")
    ap.add_argument("-o", default=None, help="output file (default stdout)")
    ap.add_argument("-l", "--list", action="store_true",
                    help="list the common-code registry and exit")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU instead of the "
                         "kernels on the card")
    args = ap.parse_args(argv)
    if args.list:
        print_code_list()
        return 0
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_run_benchmark: no CUDA card "
                 "(torch.cuda.is_available() is false); pass --cpu to run "
                 "the plain versions on the CPU")
    codes = [c for i, c in enumerate(pt.COMMON_CODES)
             if args.c is None or i == args.c]
    dts = [dt for dt in pt.DECODE_TYPES
           if not args.d or dt.value.lower() == args.d]
    routes = [args.s] if args.s else ["cuda", "torch"]
    rows = run(codes, dts, routes, args.B, args.M, args.T,
               "cpu" if args.cpu else "cuda",
               log=lambda line: print(line, file=sys.stderr, flush=True))
    out = json.dumps(rows, indent=1)
    if args.o:
        with open(args.o, "w") as f:
            f.write(out)
    else:
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
