"""The benchmark's core: find a cell by its name, run its traffic, read its
metrics, judge its outputs and build the result line.

Everything that belongs to one cell, configuration, traffic mix or metric
lives in a file of its own, found by the name that ``BENCHMARK.json``
gives it, under the benchmark's directory (``bench_port/``):

  * ``workloads/<cell>.json``: the configuration, ``chips``, ``traffic``,
    the traffic's ``params``, the ``limits`` of the numbers its
    comparison reports, ``why`` and ``who``;
  * ``configs/<config>.json``: the code (``K``, ``G``), the decode type,
    the symbol type, the data bits a frame, the channel's Eb/No,
    ``source``, ``reduced`` and ``assumed``;
  * ``traffic/<kind>.py``: one driver a kind of traffic, whose
    ``run(run: Run) -> dict`` drives the program and returns the record
    described below;
  * ``metrics/<metric>.py``: one reader a metric, whose ``read(rec)``
    returns the metric's value from the record, or None where the record
    holds nothing to read.

A new configuration, cell or metric is therefore new files plus an entry
in ``BENCHMARK.json``.

The record a driver returns holds ``attempted`` and ``failed`` (calls),
``setup_s``, ``checks`` ([name, value] of each number its comparison with
the plain reference gives), ``device`` (``kind``, ``count``,
``memory_peak_bytes``), ``shape`` (the sizes of one call), the
quantities its readers take (such as ``window_s``, ``symbols``,
``push_latency_s``, ``enqueue_s``, ``sp_timings``) and, in a traced run,
``trace`` (see ``profiling.trace_window``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

__all__ = ["BENCH_DIR", "FORBIDDEN", "BenchError", "Cell", "Run",
           "find_cell", "load_module", "forbidden_modules", "sample_frames",
           "run_cell", "check_lines"]

BENCH_DIR = Path(__file__).resolve().parent
# top-level module names the benchmark's process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "viterbidecodercpp_tpu")


class BenchError(RuntimeError):
    """A cell that cannot run as its files describe it."""


def _load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise BenchError(f"missing {path}") from None


def load_module(path: Path):
    """Import the Python file at ``path`` under a name of its own."""
    if not path.is_file():
        raise BenchError(f"missing {path}")
    name = "bench_port_" + "_".join(path.with_suffix("").parts[-2:]) \
        .replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict            # its entry in BENCHMARK.json
    spec: dict             # workloads/<name>.json
    config: dict           # configs/<config>.json
    end_to_end: list       # BENCHMARK.json's end-to-end metrics it reports
    per_layer: list        # and its per-layer metrics
    bench_dir: Path

    @property
    def params(self) -> dict:
        return self.spec["params"]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def find_cell(name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of the ``BENCHMARK.json`` beside ``bench_dir``,
    with its workload and configuration files."""
    bench_dir = Path(bench_dir)
    bench = _load_json(bench_dir.parent / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise BenchError(f"BENCHMARK.json has no cell {name!r}")
    entry = entries[0]
    spec = _load_json(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if spec.get(key) != entry.get(key):
            raise BenchError(f"workloads/{name}.json gives {key} "
                             f"{spec.get(key)!r}, BENCHMARK.json "
                             f"{entry.get(key)!r}")
    config = _load_json(bench_dir / "configs" / f"{entry['config']}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    moves = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moves)]
    return Cell(name, entry, spec, config, e2e, layer, bench_dir)


@dataclasses.dataclass
class Run:
    """What a traffic driver is given."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str            # "cuda" on the chip; "cpu" only in tests
    t_start: float         # time.time() at the process's start

    def mark(self, what: str) -> None:
        """Say on standard error how far into the set-up ``what`` ended."""
        print(f"setup: {what} at {time.time() - self.t_start:.3f} s",
              file=sys.stderr, flush=True)

    def rng(self, stream: int) -> np.random.Generator:
        """A host generator for the benchmark's own draws (samples), one
        stream a use, from the seed."""
        return np.random.default_rng([self.seed, stream])


def sample_frames(rng: np.random.Generator, B: int, n: int) -> np.ndarray:
    """``n`` frames of ``B``, one drawn in each of ``n`` equal strata, so
    that every part of the batch is looked at."""
    n = min(n, B)
    edges = np.linspace(0, B, n + 1).astype(np.int64)
    return np.array([rng.integers(lo, hi) for lo, hi in
                     zip(edges[:-1], edges[1:])], np.int64)


def forbidden_modules(names=None) -> list:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if names is None else names
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def check_lines(checks: dict) -> list:
    return [f"check {k}: {v['value']} (limit {v['limit']})"
            for k, v in checks.items()]


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str, t_start: float,
             bench_dir: Path = BENCH_DIR) -> dict:
    """Run cell ``name`` once; returns the result line's object."""
    cell = find_cell(name, bench_dir)
    traffic = load_module(Path(bench_dir) / "traffic"
                          / f"{cell.entry['traffic']}.py")
    run = Run(cell, int(seed), float(seconds), bool(trace), device, t_start)
    rec = traffic.run(run)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_module(Path(bench_dir) / "metrics"
                            / f"{m['name']}.py").read(rec)
        if value is None:
            if not trace:
                raise BenchError(f"{name}: nothing to read for the "
                                 f"end-to-end metric {m['name']}")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    limits = cell.spec["limits"]
    checks = {}
    for key, value in rec["checks"]:
        if key not in limits:
            raise BenchError(f"workloads/{name}.json has no limit for "
                             f"{key}")
        checks[key] = {"value": value, "limit": limits[key]}
    found = sorted(set(forbidden_modules()) | set(rec.get("modules", ())))
    if found:
        raise BenchError(f"forbidden modules loaded: {found}")
    device_info = dict(rec["device"])
    device_info["platform"] = "gpu" if device == "cuda" else device
    if trace:
        device_info["busy_s"] = rec["trace"]["busy_s"]
        device_info["window_s"] = rec["trace"]["window_s"]
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
           "metrics": metrics,
           "device": {k: device_info[k] for k in (
               "platform", "kind", "count", "memory_peak_bytes",
               *(("busy_s", "window_s") if trace else ()))}}
    if trace:
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["checks"] = checks
    return out
