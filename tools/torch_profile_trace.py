#!/usr/bin/env python3
"""A torch.profiler trace of the PyTorch port's decode pipeline (the twin
of tools/profile_trace.py).

Where the reference wraps reset/update/chainback in nanosecond timers
(run_benchmark.cpp:267-281), on the card the ground truth is the device
trace.  The tool decodes ``reps`` batches through
``ViterbiDecoder.decode`` (the route the decoder picks) under
``torch.profiler`` (after WARMUP profiled decodes that are dropped),
writes the Chrome trace ``trace.json`` into
``outdir`` (chrome://tracing or Perfetto load it), and prints the top
device operations by self time and the device's idle share of the
traced window (1 - the kernels' own time / the window's host-clock
time; a share outside [0, 1] means the window counted kernels it did
not hold, and the tool raises).  With ``--cpu`` the plain versions run on the CPU and the table
lists CPU operations; no device share is measured.

    python3 tools/torch_profile_trace.py [outdir] [reps] [mode] [--cpu]

Modes: ``voyager`` (Voyager SOFT8, B=1024 x 2048 trellis steps: the
rotated kernels) and ``cassini`` (Cassini SOFT16, B=256 x 1024 steps:
the plane kernels).  ``-B``/``-T`` shrink a mode for a CPU run.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np
import torch

import viterbidecodercpp_torch as pt

# mode -> (code, decode type, frames, trellis steps)
MODES = {"voyager": ("Voyager", "SOFT8", 1024, 2048),
         "cassini": ("Cassini", "SOFT16", 256, 1024)}
TOP = 10
# decodes profiled before the window and dropped: the profiler can lose a
# window's first device events
WARMUP = 2


def idle_share(busy_us: float, window_us: float) -> float:
    """1 - busy / window; raises where that falls outside [0, 1]."""
    share = 1 - busy_us / window_us
    if not 0 <= share <= 1:
        raise RuntimeError(
            f"torch_profile_trace: device idle share {share:.4f} outside "
            f"[0, 1] ({busy_us:.1f} us of kernels in a {window_us:.1f} us "
            f"window): the window counted kernels it did not hold")
    return share


def trace(outdir: str, reps: int, mode: str, device, batch=None,
          steps=None) -> dict:
    """Profile ``reps`` decodes of ``mode``; returns the trace's path, the
    route, the top operations (name, self ms, calls) and, on a card, the
    device's busy time and idle share."""
    from torch.profiler import ProfilerActivity, profile, schedule
    device = torch.device(device)
    name, dtype, B, T = MODES[mode]
    B, T = batch or B, steps or T
    code = pt.get_code(name)
    dec = pt.ViterbiDecoder(code, dtype, device=device)
    total_bits = T - (code.K - 1)
    lo, hi = dec.config.soft_decision_low, dec.config.soft_decision_high
    rng = np.random.RandomState(0)
    syms = torch.as_tensor(rng.randint(lo, hi + 1, (B, T * code.R))
                           .astype(np.int32), device=device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dec.decode(syms, total_bits)       # builds and loads the kernels
    sync()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    sched = schedule(wait=0, warmup=WARMUP, active=reps, repeat=1)
    with profile(activities=activities, schedule=sched) as prof:
        # the warm-up's kernels end before the window opens, and the
        # window's before it closes
        for _ in range(WARMUP):
            dec.decode(syms, total_bits)
            sync()
            prof.step()
        t0 = time.perf_counter()
        for i in range(reps):
            dec.decode(syms, total_bits)
            if i < reps - 1:
                prof.step()
        sync()
        window_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "trace.json")
    prof.export_chrome_trace(path)

    def self_us(e):
        if on_card:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            return us
        return e.self_cpu_time_total

    # an aten:: operator's self device time is that of the kernels it
    # launched, which appear under their own names: on the card count
    # those only; the step markers are the profiler's own
    def counted(e):
        if e.key.startswith("ProfilerStep"):
            return False
        return self_us(e) > 0 and not (on_card and e.key.startswith("aten::"))

    ops = [e for e in prof.key_averages() if counted(e)]
    ops.sort(key=self_us, reverse=True)
    out = {"path": path, "route": dec.backend, "B": B, "T": T, "reps": reps,
           "window_ms": window_us / 1e3,
           "top": [(e.key, self_us(e) / 1e3, e.count) for e in ops[:TOP]]}
    if on_card:
        busy = sum(self_us(e) for e in ops)
        out["device_busy_ms"] = busy / 1e3
        out["idle_share"] = idle_share(busy, window_us)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir", nargs="?", default=None,
                    help="trace directory (default $TMPDIR/vdt_torch_trace)")
    ap.add_argument("reps", nargs="?", type=int, default=8)
    ap.add_argument("mode", nargs="?", default="voyager",
                    choices=sorted(MODES))
    ap.add_argument("-B", type=int, default=None,
                    help="frames (default: the mode's)")
    ap.add_argument("-T", type=int, default=None,
                    help="trellis steps (default: the mode's)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU instead of the "
                         "kernels on the card")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_profile_trace: no CUDA card "
                 "(torch.cuda.is_available() is false); pass --cpu to "
                 "trace the plain versions on the CPU")
    outdir = args.outdir or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "vdt_torch_trace")
    device = "cpu" if args.cpu else "cuda"
    r = trace(outdir, args.reps, args.mode, device, args.B, args.T)
    where = (torch.cuda.get_device_name(0) if device == "cuda" else "cpu")
    print(f"{args.mode}: {r['reps']} decodes of B={r['B']} x T={r['T']} on "
          f"the {r['route']} route, {where}; window {r['window_ms']:.3f} ms")
    print(f"top {'device' if device == 'cuda' else 'CPU'} operations by self "
          f"time:")
    for key, ms, calls in r["top"]:
        print(f"  {ms:12.4f} ms  {calls:6d} calls  {key}")
    if device == "cuda":
        print(f"device busy {r['device_busy_ms']:.4f} ms, idle share "
              f"{r['idle_share']:.4f}")
    else:
        print("device idle share: not measured (a CPU run)")
    print(f"trace written to {r['path']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
