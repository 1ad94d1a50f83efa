"""What a run loads holds no jax and no JAX package, and the plain
reference loads nothing of the program either: each checked in a fresh
interpreter, by every module's top-level name."""

import json
import subprocess
import sys

from bench_port_tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "viterbidecodercpp_tpu"}

RUN = """
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, {tests!r})
from bench_port_tiny import tiny_tree, run_tiny
bench = tiny_tree(Path(tempfile.mkdtemp()))
out = run_tiny(bench, {cell!r}, seconds=0.2)
assert out["correct"], out
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import bench_port.reference.viterbi, bench_port.counts.bounds
import bench_port.counts.roofline
print(json.dumps(sorted(sys.modules)))
"""


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return {m.split(".", 1)[0] for m in json.loads(
        out.stdout.strip().splitlines()[-1])}


def test_run_loads_no_jax():
    """A whole run of a cell (the program, the traffic, every reader, the
    reference): the batch cell here, each rank of the 4-rank cell checks
    itself and the run fails on a find."""
    tops = loaded(RUN.format(tests=str(ROOT / "bench_port" / "tests"),
                             cell="voyager-batch"))
    assert "viterbidecodercpp_torch" in tops
    assert not tops & FORBIDDEN


def test_reference_loads_no_program():
    tops = loaded(REFERENCE.format(root=str(ROOT)))
    assert "numpy" in tops
    assert not tops & (FORBIDDEN | {"viterbidecodercpp_torch", "torch"})


def test_forbidden_by_whole_top_level_name():
    from bench_port import harness
    names = ["jax.numpy", "jaxlib", "viterbidecodercpp_tpu.ops",
             "viterbidecodercpp_torch", "jaxtyping", "flax.linen"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax.numpy", "jaxlib", "viterbidecodercpp_tpu.ops"]
