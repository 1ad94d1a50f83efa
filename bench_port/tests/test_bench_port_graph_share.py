"""The reader of ``push.graph_share`` on span windows' counters, and its
entry in BENCHMARK.json."""

import importlib.util
import json

import pytest

from bench_port_tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _read(rec):
    path = ROOT / "bench_port" / "metrics" / "push.graph_share.py"
    spec = importlib.util.spec_from_file_location("m_graph_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


@pytest.mark.parametrize("counters,want", [
    ({"streaming.graph_replays": 99, "streaming.eager_pushes": 1}, 0.99),
    ({"streaming.graph_replays": 7}, 1.0),
    ({"streaming.eager_pushes": 5, "launches.chainback": 5}, 0.0),
    ({"launches.chainback": 5}, None),
    ({}, None)])
def test_share_of_replayed_pushes(counters, want):
    got = _read({"spans": [{"counters": counters}]})
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("rec", [{"spans": None}, {"spans": []}])
def test_no_window_reads_nothing(rec):
    assert _read(rec) is None


def test_entry():
    entry = {m["name"]: m for m in BENCH["per_layer"]}["push.graph_share"]
    assert entry == {"name": "push.graph_share", "unit": "share",
                     "better": "higher", "source": "program_span",
                     "layer": "streaming.py StreamingDecoder.push",
                     "moves": "push_p95_ms", "workloads": ["voyager-stream"]}
