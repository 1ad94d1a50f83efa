"""Helpers of the benchmark's tests: a copy of the benchmark's files in a
temporary directory, cut to sizes the CPU runs in seconds."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import harness  # noqa: E402

# params and data bits that keep each cell's run on the CPU to seconds
TINY = {"voyager-batch": {"frames": 8, "pool": 3, "check_slots": 2,
                          "check_frames": 4},
        "cassini-batch": {"frames": 2, "pool": 2, "check_slots": 1,
                          "check_frames": 2},
        "voyager-stream": {"frames": 4, "pass_pushes": 12, "pool": 2,
                           "check_passes": 2, "check_frames": 3},
        "voyager-sp4": {"frames": 4, "stream_bits": 1024, "overlap": 64,
                        "check_frames": 3, "timeout": 120}}
TINY_BITS = {"voyager": 64, "cassini": 32}
CELLS = tuple(TINY)


def tiny_tree(tmp: Path) -> Path:
    """A copy of BENCHMARK.json and bench_port/ under ``tmp`` with the
    cells cut to TINY; returns the copy's bench_port directory."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp)
    bench = tmp / "bench_port"
    shutil.copytree(ROOT / "bench_port", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, params in TINY.items():
        edit(bench / "workloads" / f"{name}.json",
             lambda w, p=params: w["params"].update(p))
    for name, bits in TINY_BITS.items():
        edit(bench / "configs" / f"{name}.json",
             lambda c, b=bits: c.update(data_bits=b))
    return bench


def edit(path: Path, fn) -> None:
    obj = json.loads(path.read_text())
    fn(obj)
    path.write_text(json.dumps(obj))


def run_tiny(bench: Path, name: str, seed: int = 12_345_678_901,
             seconds: float = 0.5) -> dict:
    return harness.run_cell(name, seed, seconds, False, device="cpu",
                            t_start=time.time(), bench_dir=bench)
