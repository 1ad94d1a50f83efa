#!/usr/bin/env python3
"""Run one cell of the benchmark of viterbidecodercpp_torch once.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The process loads the program and builds its inputs from the seed,
warms up, measures for ``--seconds``, compares what the timed path
produced with the plain reference, and prints one JSON object as the last
line of its standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks`` (each number compared, beside its limit; also the last lines
of standard error).

It prints no result and exits non-zero without enough CUDA cards, when
the cell's files or the program are missing or a kernel cannot be built
(a JSON ``error`` line on standard error), and when a module of jax,
jaxlib, flax or the JAX package has been loaded.  The CUDA kernels are
built at a first run into ``viterbidecodercpp_torch/_build/`` inside the
checkout, and loaded from there by later runs.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _fail(what: str, code: int = 2) -> int:
    print(json.dumps({"error": what}), file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench_port import harness
    try:
        cell = harness.find_cell(args.workload)
        import torch
        if not torch.cuda.is_available():
            return _fail("no CUDA device (torch.cuda.is_available() is "
                         "false): the benchmark runs on the card only")
        if torch.cuda.device_count() < cell.chips:
            return _fail(f"cell {cell.name} needs {cell.chips} CUDA "
                         f"devices, {torch.cuda.device_count()} visible")
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), device="cuda",
                               t_start=T_START)
    except (harness.BenchError, ImportError, RuntimeError, OSError) as e:
        traceback.print_exc()
        return _fail(f"{type(e).__name__}: {e}", 1)
    for line in harness.check_lines(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
