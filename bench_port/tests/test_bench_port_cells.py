"""Every cell runs end to end on the CPU at a tiny size (the program's
plain versions in place of its kernels), a cell added as files alone
runs too, and the entry point refuses to run without the card."""

import json
import shutil
import subprocess
import sys

import pytest

from bench_port_tiny import CELLS, ROOT, edit, run_tiny, tiny_tree

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell, tmp_path):
    out = run_tiny(tiny_tree(tmp_path), cell)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert all(c["value"] == c["limit"] == 0
               for c in out["checks"].values())


def test_new_cell_from_files(tmp_path):
    """A configuration and a cell added as new files and BENCHMARK.json
    entries, no existing file of bench_port/ edited: the CDMA 2000 code
    (K=9, R=1/4) under the batch traffic."""
    bench = tiny_tree(tmp_path)
    (bench / "configs" / "cdma2000.json").write_text(json.dumps({
        "name": "cdma2000", "code": "CDMA 2000", "K": 9,
        "G": [501, 441, 331, 315], "decode_type": "SOFT16",
        "arith": "saturating", "symbol_dtype": "int16", "data_bits": 48,
        "ebno_db": 2.0, "source": "https://example.org/cdma2000",
        "reduced": [], "assumed": {}}))
    (bench / "workloads" / "cdma2000-batch.json").write_text(json.dumps({
        "name": "cdma2000-batch", "config": "cdma2000", "chips": 1,
        "traffic": "batch_decode",
        "params": {"frames": 4, "pool": 2, "warmup": 1, "check_slots": 2,
                   "check_frames": 4},
        "limits": {"bit_mismatches": 0, "metric_mismatches": 0,
                   "acc_mismatches": 0, "batches_unchecked": 0},
        "why": "x", "who": "x"}))

    def add(b):
        b["configs"].append({"name": "cdma2000", "source": "x",
                             "file": "bench_port/configs/cdma2000.json",
                             "reduced": [], "why": "x"})
        b["workloads"].append({"name": "cdma2000-batch",
                               "config": "cdma2000", "chips": 1,
                               "traffic": "batch_decode", "why": "x"})
        for m in b["end_to_end"] + b["per_layer"]:
            if "voyager-batch" in m.get("workloads", []):
                m["workloads"].append("cdma2000-batch")

    edit(tmp_path / "BENCHMARK.json", add)
    out = run_tiny(bench, "cdma2000-batch")
    assert out["correct"]
    assert set(out["metrics"]) == {"decode_symbols_per_s", "setup_s"}


def run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", "voyager-batch",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    out = run_py(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "error" in out.stderr.strip().splitlines()[-1]


def test_benchmark_alone_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and bench_port/."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in __import__("os").environ.items()
           if k != "PYTHONPATH"}
    out = run_py(tmp_path, env)
    assert out.returncode != 0 and out.stdout == ""
