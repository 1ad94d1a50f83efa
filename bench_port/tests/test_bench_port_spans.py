"""The span window's arithmetic (``bench_port/spans.py``) on synthetic
device operations and spans, and the readers of its metrics: each idle
second goes to exactly one label, and a record without a span window
reads as nothing.  One test runs a tiny window on the card."""

import importlib.util
import json
import sys

import pytest

from bench_port_tiny import ROOT, tiny_tree
from bench_port import harness, spans
from viterbidecodercpp_torch import trace

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = {"decoder.update.self_ms", "decoder.chainback.self_ms",
       "ops.launch_ms", "idle.in_program_share.batch", "push.host_ms",
       "idle.in_program_share.stream", "sp.host_read_ms",
       "idle.in_program_share.sp"}


def _span(name, sid, parent, call, t0, t1, detail=None):
    return trace.Record(name, detail, sid, parent, call, t0, t1)


def _reader(name):
    path = ROOT / "bench_port" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"m_{len(name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# a decode from 0 to 100 us (reset 5-10, update 10-40 over its ACS
# 20-30, chainback 50-80 over its walk 60-70), a second from 200 to 250
# with only an update (210-240); times in ns
SPANS = [_span("decoder.decode", 1, None, 1, 0, 100_000),
         _span("decoder.reset", 2, 1, 1, 5_000, 10_000),
         _span("decoder.update", 3, 1, 1, 10_000, 40_000),
         _span("ops.rotated_acs", 4, 3, 1, 20_000, 30_000),
         _span("decoder.chainback", 5, 1, 1, 50_000, 80_000),
         _span("ops.chainback", 6, 5, 1, 60_000, 70_000),
         _span("decoder.decode", 7, None, 7, 200_000, 250_000),
         _span("decoder.update", 8, 7, 7, 210_000, 240_000, "x")]


def test_segments_follow_the_innermost_span():
    segs = spans.segments(SPANS)
    assert segs == [(0.0, 5.0, "decoder.decode"),
                    (5.0, 10.0, "decoder.reset"),
                    (10.0, 20.0, "decoder.update"),
                    (20.0, 30.0, "ops.rotated_acs"),
                    (30.0, 40.0, "decoder.update"),
                    (40.0, 50.0, "decoder.decode"),
                    (50.0, 60.0, "decoder.chainback"),
                    (60.0, 70.0, "ops.chainback"),
                    (70.0, 80.0, "decoder.chainback"),
                    (80.0, 100.0, "decoder.decode"),
                    (200.0, 210.0, "decoder.decode"),
                    (210.0, 240.0, "decoder.update(x)"),
                    (240.0, 250.0, "decoder.decode")]
    # a clock moves every instant
    shifted = spans.segments(SPANS, lambda ns: (ns + 1_000) / 1e3)
    assert [(a - 1, b - 1, n) for a, b, n in shifted] == segs


def test_host_clock_is_the_line_through_the_anchors():
    clock, rate = spans.host_clock([(1_000_000, 50.0), (3_000_000, 2050.2)])
    assert clock(1_000_000) == pytest.approx(50.0)
    assert clock(3_000_000) == pytest.approx(2050.2)
    assert clock(2_000_000) == pytest.approx(1050.1)
    assert rate == pytest.approx(1e-4)
    # one instant: the host's rate, through the point
    clock, rate = spans.host_clock([(1_000_000, 50.0), (1_000_000, 52.0)])
    assert rate is None and clock(1_004_000) == pytest.approx(55.0)


def test_anchor_pairs_survive_dropped_anchors():
    heads, tails = [100_000, 200_000, 300_000], [900_000, 950_000, 990_000]
    ops = [(400.0, 410.0, "k"), (800.0, 805.0, "k")]
    mark = "add<double>"
    marks = [(x - 1.0, x, mark) for x in (99.0, 199.0, 299.0, 899.0, 949.0,
                                          989.0)]
    assert spans.anchor_pairs(heads, tails, marks, ops) == \
        list(zip(heads + tails, (99.0, 199.0, 299.0, 899.0, 949.0, 989.0)))
    # the profiler lost the first head and the last two tails
    assert spans.anchor_pairs(heads, tails, marks[1:4], ops) == \
        [(200_000, 199.0), (300_000, 299.0), (900_000, 899.0)]
    assert spans.anchor_pairs(heads, tails, [], ops) == []


def test_idle_split_adds_up():
    ops = [(0.0, 2.0, "k"), (1.0, 3.0, "k"),     # overlapping: no gap
           (25.0, 27.0, "k"),                     # gap 3-25: three spans
           (28.0, 65.0, "k"),                     # gap 27-28 in the ACS
           (150.0, 205.0, "k"),                   # gap 65-150 straddles
           (300.0, 301.0, "k")]                   # gap 205-300 straddles
    gaps = spans.idle_gaps(ops)
    assert gaps == [(3.0, 25.0), (27.0, 28.0), (65.0, 150.0),
                    (205.0, 300.0)]
    idle = spans.split_idle(gaps, spans.segments(SPANS))
    want = {"decoder.decode": 2 + 20 + 5 + 10,
            "decoder.reset": 5, "decoder.update": 10,
            "ops.rotated_acs": 5 + 1, "ops.chainback": 5,
            "decoder.chainback": 10, "decoder.update(x)": 30,
            spans.CALLER: 50 + 50}
    assert idle == pytest.approx({k: v / 1e6 for k, v in want.items()},
                                 rel=1e-12)
    total = sum(b - a for a, b in gaps) / 1e6
    assert sum(idle.values()) == pytest.approx(total, rel=1e-12)


def test_gap_under_no_span_is_the_callers():
    idle = spans.split_idle([(400.0, 500.0)], spans.segments(SPANS))
    assert idle == {spans.CALLER: pytest.approx(100e-6)}
    assert spans.split_idle([(1.0, 2.0)], []) == \
        {spans.CALLER: pytest.approx(1e-6)}


def test_per_call_self_times():
    calls = spans.per_call(SPANS, trace.self_ns(SPANS))
    dec = calls["decoder.decode"]
    assert dec["total"] == [100e-6, 50e-6]
    assert dec["self"]["decoder.update"] == [20e-6, 30e-6]
    assert dec["self"]["ops.rotated_acs"] == [10e-6, 0.0]
    assert dec["self"]["decoder.chainback"] == [20e-6, 0.0]
    assert dec["self"]["decoder.decode"] == [35e-6, 20e-6]


def _window():
    calls = spans.per_call(SPANS, trace.self_ns(SPANS))
    push = [_span("streaming.push", 1, None, 1, 0, 300_000),
            _span("streaming.push", 2, None, 2, 400_000, 500_000)]
    sp = [_span("sp.decode_stream_sp", 1, None, 1, 0, 9_000_000),
          _span("sp.exchange", 2, 1, 1, 0, 1_000_000, "tile_shape"),
          _span("host_read.sp.tile_shape", 3, 2, 1, 100_000, 900_000)]
    calls.update(spans.per_call(push, trace.self_ns(push)))
    calls.update(spans.per_call(sp, trace.self_ns(sp)))
    return {"per_call": calls, "idle_s": 4.0, "idle_in_program_s": 1.0}


def test_readers_on_a_window():
    rec = {"spans": [_window()]}
    got = {name: _reader(name)(rec) for name in NEW}
    assert got == pytest.approx({
        "decoder.update.self_ms": 0.025, "decoder.chainback.self_ms": 0.01,
        "ops.launch_ms": 0.01, "push.host_ms": 0.2,
        "sp.host_read_ms": 0.8, "idle.in_program_share.batch": 0.25,
        "idle.in_program_share.stream": 0.25,
        "idle.in_program_share.sp": 0.25})
    second = _window()
    second["idle_in_program_s"] = 3.0
    assert _reader("idle.in_program_share.sp")(
        {"spans": [_window(), second]}) == 0.75


@pytest.mark.parametrize("rec", [{}, {"spans": None}, {"spans": []},
                                 {"trace": {"calls": 1, "window_s": 1.0}}],
                         ids=["untraced", "none", "empty", "not-run.py"])
def test_readers_without_a_window_read_nothing(rec):
    assert sys.argv[0] != "run.py"
    for name in NEW:
        assert _reader(name)(dict(rec)) is None, name


def test_new_metrics_are_entries():
    layer = {m["name"]: m for m in BENCH["per_layer"]}
    assert NEW <= set(layer)
    for name in NEW:
        assert layer[name]["source"] == "program_span"
        assert len(layer[name]["workloads"]) == 1


@pytest.mark.cuda
def test_span_window_on_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run on the card only")
    bench = tiny_tree(tmp_path)
    cell = harness.find_cell("voyager-batch", bench)
    run = harness.Run(cell, 77, 0.5, True, "cuda", 0.0)
    mod = harness.load_module(bench / "traffic" / "batch_decode.py")
    dec, pool, _, shape = mod._setup(run)
    nbits = shape["data_bits"]
    out = spans.span_window(lambda: dec.decode(pool[0], nbits),
                            lambda s: {"calls": mod._loop(dec, pool, nbits,
                                                          0.2)})
    assert out["calls"] > 0 and out["idle_s"] > 0
    assert sum(out["idle_by_span"].values()) == \
        pytest.approx(out["idle_s"], rel=1e-9)
    counts = out["counters"]
    assert counts["launches.rotated_acs"] == out["calls"]
    assert counts["launches.chainback"] == out["calls"]
    dc = out["device_counts"]
    assert sum(v for k, v in dc.items() if "rotated_acs" in k) == \
        out["calls"]


@pytest.mark.parametrize("cell", ["voyager-batch", "voyager-stream",
                                  "voyager-sp4"])
def test_cell_windows_rehearse_on_the_cpu(cell, tmp_path, monkeypatch):
    """Each cell's span window at a tiny size on the CPU (the plain
    versions, CPU activity, no device operation): the spans of every
    call, and for the time-tiled cell a fleet of 4 gloo ranks."""
    monkeypatch.setattr(spans, "SPAN_WINDOW_S", 0.2)
    bench = tiny_tree(tmp_path)
    run = harness.Run(harness.find_cell(cell, bench), 12_345_678_901, 0.2,
                      True, "cpu", 0.0)
    root = {"voyager-batch": "decoder.decode",
            "voyager-stream": "streaming.push",
            "voyager-sp4": "sp.decode_stream_sp"}[cell]
    if cell == "voyager-sp4":
        windows = spans._fleet(run)
        assert len(windows) == 4
    else:
        windows = [{"voyager-batch": spans._batch,
                    "voyager-stream": spans._stream}[cell](run)]
    for w in windows:
        calls = w["per_call"][root]
        assert w["calls"] == len(calls["total"]) > 0
        assert w["idle_s"] == 0 and w["idle_by_span"] == {}
    if cell == "voyager-sp4":
        assert all(w["counters"]["host_reads.sp.tile_shape"] == w["calls"]
                   for w in windows)
