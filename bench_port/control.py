#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference, computed one
metric width below the configuration's (8-bit metrics for SOFT16, 4-bit
for SOFT8) and put in the program's place, judged by the same comparison
on the run's own inputs and sample.  A sound comparison finds it wrong.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3

prints one JSON line a seed: the numbers compared, beside the cell's
limits, and whether the control came out correct (it must not).  The
inputs are made on the card from each seed, as a run makes them; the
benchmark's runs never run this.  The tests call ``readings`` on the
CPU at small sizes.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(name: str, seed: int, device: str,
             bench_dir: Path = None) -> dict:
    """The control's numbers on one seed of cell ``name``."""
    from bench_port import harness
    from bench_port.reference import viterbi as ref

    bench_dir = bench_dir or harness.BENCH_DIR
    cell = harness.find_cell(name, bench_dir)
    traffic = harness.load_module(Path(bench_dir) / "traffic"
                                  / f"{cell.entry['traffic']}.py")
    bits = ref.DECODE_TYPES[cell.config["decode_type"]][3] // 2
    run = harness.Run(cell, seed, 0.0, False, device, time.time())
    checks = dict(traffic.control(run, bits))
    limits = cell.spec["limits"]
    return {"workload": name, "seed": seed, "metric_bits": bits,
            "checks": {k: {"value": v, "limit": limits[k]}
                       for k, v in checks.items()},
            "correct": all(v <= limits[k] for k, v in checks.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device"}), file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
