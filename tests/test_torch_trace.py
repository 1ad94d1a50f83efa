"""The port's span-and-counter recorder (``viterbidecodercpp_torch.trace``):
the recorder alone, the span trees of a decode, a push and a time-SP call
on the CPU (the SP call in a fleet of 4 gloo ranks, ``launch.spawn_fleet``,
that run this file as a script), the host-read counters, and the clock
against ``torch.profiler``'s."""

import argparse
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import viterbidecodercpp_torch as pt  # noqa: E402
from viterbidecodercpp_torch import trace  # noqa: E402

WORLD = 4
SP_CALLS = 2


def _sp_inputs(world):
    """(spec, (1, T', R) int32 stream, T, data bits) of a clean
    tail-terminated Voyager stream padded to a multiple of ``world``."""
    from viterbidecodercpp_torch.ops import encoder, torch_core

    code = pt.get_code("Voyager")
    config = pt.get_decode_config(pt.DecodeType.SOFT16, code.R)
    spec = torch_core.make_static_spec(code, config)
    nbits = 128 * world
    T = nbits + code.K - 1
    data = torch.as_tensor(np.random.RandomState(3).randint(
        0, 2, (1, nbits)).astype(np.uint8))
    arr = torch.zeros((1, -(-T // world) * world, code.R), dtype=torch.int32)
    arr[:, :T] = encoder.encode_symbols(code, data, config.soft_decision_high,
                                        config.soft_decision_low)
    return spec, arr, T


def _record(spans):
    return [[s.name, s.detail, s.id, s.parent, s.call] for s in spans]


# -- the ranks ---------------------------------------------------------------

def _rank_main(rank: int, init_method: str, out: str) -> None:
    import torch.distributed as dist

    from viterbidecodercpp_torch.parallel import block_sp, launch
    from viterbidecodercpp_torch.parallel.mesh import make_mesh

    launch.initialize(init_method, WORLD, rank, device="cpu")
    mesh = make_mesh((WORLD,), ("time",), "cpu")
    spec, arr, T = _sp_inputs(WORLD)
    tile = launch.local_block(arr, mesh, (None, "time", None))

    def call(timings=None):
        return block_sp.decode_stream_sp(spec, mesh, tile, overlap=64,
                                         total_rows=T, device="cpu",
                                         timings=timings)

    trace.drain()
    trace.reset_counters()
    call()
    off = len(trace.drain())
    trace.enable()
    for _ in range(SP_CALLS):
        call()
    timings = {}
    call(timings)
    trace.disable()
    result = {"off": off, "spans": _record(trace.drain()),
              "counters": trace.counters(), "timings": timings}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    _rank_main(a.rank, a.init_method, a.out)
    sys.exit(0)


# -- the tests ---------------------------------------------------------------

@pytest.fixture(autouse=True)
def clean():
    """Each test starts and leaves the recorder off and empty."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _voyager(**kw):
    return pt.ViterbiDecoder(pt.get_code("Voyager"), "SOFT8", device="cpu",
                             **kw)


def _frames(B=2, nbits=64, seed=5):
    from viterbidecodercpp_torch.ops import encoder

    code = pt.get_code("Voyager")
    config = pt.get_decode_config(pt.DecodeType.SOFT8, code.R)
    data = torch.as_tensor(np.random.RandomState(seed).randint(
        0, 2, (B, nbits)).astype(np.uint8))
    syms = encoder.encode_symbols(code, data, config.soft_decision_high,
                                  config.soft_decision_low)
    return syms.reshape(B, -1), data


def _tree(spans):
    """{name: [parent name, ...]} and the set of call ids."""
    by_id = {s.id: s for s in spans}
    parents = {}
    for s in spans:
        parents.setdefault(s.name, []).append(
            by_id[s.parent].name if s.parent is not None else None)
    return parents, {s.call for s in spans}


def test_nesting_parents_and_call_ids():
    trace.enable()
    with trace.span("a") as a:
        with trace.span("b", "x") as b:
            with trace.span("c") as c:
                pass
        with trace.span("d") as d:
            pass
    with trace.span("e") as e:
        pass
    spans = trace.drain()
    assert [s.name for s in spans] == ["a", "b", "c", "d", "e"]
    assert [s.id for s in spans] == [a.id, b.id, c.id, d.id, e.id]
    assert spans[1] == ("b", "x", b.id, a.id, a.id, b.start_ns, b.end_ns)
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == \
        (None, a.id, b.id, a.id, None)
    assert {a.call, b.call, c.call, d.call} == {a.id} and e.call == e.id
    assert b.detail == "x" and a.detail is None
    assert all(s.start_ns <= s.end_ns for s in spans)
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns \
        <= d.start_ns <= d.end_ns <= a.end_ns <= e.start_ns
    assert trace.drain() == []


def test_self_time_arithmetic():
    spans = [trace.Record(name, None, sid, parent, 1, t0, t1)
             for name, sid, parent, t0, t1 in (("root", 1, None, 0, 100),
                                               ("x", 2, 1, 10, 40),
                                               ("y", 3, 2, 15, 20),
                                               ("z", 4, 1, 50, 90))]
    assert trace.self_ns(spans) == {1: 30, 2: 25, 3: 5, 4: 40}


def test_counters_and_host_reads_always_count():
    trace.reset_counters()
    trace.count("launches.k")
    trace.count("launches.k", 2)
    with trace.host_read("site"):
        pass
    assert trace.counters() == {"launches.k": 3, "host_reads.site": 1}
    trace.enable()
    with trace.host_read("site"):
        pass
    assert trace.counters()["host_reads.site"] == 2
    assert [s.name for s in trace.drain()] == ["host_read.site"]
    trace.reset_counters()
    assert trace.counters() == {}


def test_off_is_one_shared_no_op():
    off = trace.span("a")
    assert trace.span("b", "x") is off
    assert trace.timed_span("c", None, None, "c", "cpu") is off
    with off as entered:
        assert entered is off
    syms, _ = _frames()
    _voyager().decode(syms, 64)
    sd = pt.StreamingDecoder(pt.get_code("Voyager"), "SOFT8", window=32,
                             chunk=8, device="cpu")
    sd.push(sd.reset(2), syms[:, :16])
    assert trace.drain() == []


def test_decode_span_tree():
    syms, data = _frames()
    dec = _voyager()
    trace.enable()
    bits, _, _ = dec.decode(syms, 64)
    trace.disable()
    assert torch.equal(bits, data)
    spans = trace.drain()
    parents, calls = _tree(spans)
    assert parents == {"decoder.decode": [None],
                       "decoder.reset": ["decoder.decode"],
                       "decoder.update": ["decoder.decode"],
                       "ops.rotated_acs": ["decoder.update"],
                       "decoder.chainback": ["decoder.decode"],
                       "ops.chainback": ["decoder.chainback"]}
    assert calls == {spans[0].id}
    # a bare update or chainback is a root of its own
    trace.enable()
    state = dec.update(dec.reset(2), syms)
    dec.chainback(state, 64)
    trace.disable()
    parents, calls = _tree(trace.drain())
    assert parents["decoder.update"] == [None]
    assert parents["decoder.chainback"] == [None]
    assert len(calls) == 3


def test_push_span_tree():
    syms, _ = _frames(B=3, nbits=64)
    sd = pt.StreamingDecoder(pt.get_code("Voyager"), "SOFT8", window=32,
                             chunk=8, device="cpu")
    state = sd.reset(3)
    trace.enable()
    for j in range(2):
        state, _, _ = sd.push(state, syms[:, 16 * j:16 * (j + 1)])
    trace.disable()
    spans = trace.drain()
    parents, calls = _tree(spans)
    assert parents == {"streaming.push": [None, None],
                       "ops.rotated_acs": ["streaming.push"] * 2,
                       "ops.chainback": ["streaming.push"] * 2}
    assert len(calls) == 2


def test_host_read_counters_of_decoder_and_stream(tmp_path):
    syms, _ = _frames()
    dec = _voyager(traceback_length=256)
    trace.reset_counters()
    state = dec.update(dec.reset(2), syms)
    assert trace.counters().get("host_reads.decoder.cursor", 0) == 0
    state.save(str(tmp_path / "state.npz"))
    loaded = pt.DecoderState.load(str(tmp_path / "state.npz"), "cpu")
    trace.enable()
    dec.update(loaded, syms)
    trace.disable()
    assert trace.counters()["host_reads.decoder.cursor"] == 1
    reads = [s for s in trace.drain()
             if s.name == "host_read.decoder.cursor"]
    assert len(reads) == 1 and reads[0].parent is not None

    sd = pt.StreamingDecoder(pt.get_code("Voyager"), "SOFT8", window=32,
                             chunk=8, device="cpu")
    st = sd.reset(2)
    st, _, _ = sd.push(st, syms[:, :16])
    assert "host_reads.streaming.rows_seen" not in trace.counters()
    st.host_rows = None
    sd.push(st, syms[:, 16:32])
    assert trace.counters()["host_reads.streaming.rows_seen"] == 1


def test_timed_span_adds_seconds_and_a_span():
    timings = {}
    with trace.timed_span("t", "s", timings, "key", "cpu"):
        time.sleep(0.002)
    assert timings["key"] >= 0.002 and trace.drain() == []
    trace.enable()
    with trace.timed_span("t", "s", timings, "key", "cpu"):
        pass
    spans = trace.drain()
    assert [(s.name, s.detail) for s in spans] == [("t", "s")]


def test_clock_matches_the_profiler():
    """A span's ends, mapped onto a CPU profile by the trace's start, and
    the profiler's own event for a record_function inside it agree within
    1 ms (the closest of three tries: a busy host may deschedule the
    thread between the two)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def apart_us() -> float:
        trace.enable()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("outer") as sp:
                with record_function("inner"):
                    torch.ones(100_000).sum()
        trace.disable()
        start_ns = prof.profiler.kineto_results.trace_start_ns()
        ev = [e for e in prof.events() if e.name == "inner"]
        assert len(ev) == 1
        lo = (sp.start_ns - start_ns) / 1e3
        hi = (sp.end_ns - start_ns) / 1e3
        return max(abs(ev[0].time_range.start - lo),
                   abs(ev[0].time_range.end - hi))

    assert min(apart_us() for _ in range(3)) < 1000


@pytest.fixture(scope="module")
def sp_fleet(tmp_path_factory):
    from viterbidecodercpp_torch.parallel import launch

    out = tmp_path_factory.mktemp("trace_fleet")
    me = os.path.abspath(__file__)
    launch.spawn_fleet(
        lambda r, init: [sys.executable, me, "--rank", str(r),
                         "--init-method", init, "--out", str(out)],
        WORLD, timeout=300)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def test_sp_span_tree(sp_fleet):
    for rank in sp_fleet:
        assert rank["off"] == 0
        spans = rank["spans"]
        roots = [s for s in spans if s[3] is None]
        assert [s[0] for s in roots] == ["sp.decode_stream_sp"] * \
            (SP_CALLS + 1)
        for root in roots:
            kids = [(s[0], s[1]) for s in spans if s[3] == root[2]]
            assert kids == [("sp.exchange", "tile_shape"),
                            ("sp.exchange", "halo_syms"),
                            ("sp.tile", "acs"),
                            ("sp.exchange", "halo_dec"),
                            ("sp.tile", "walk"),
                            ("sp.exchange", "diagnostic")]
            assert all(s[4] == root[2] for s in spans if s[3] == root[2])
        reads = [s for s in spans if s[0] == "host_read.sp.tile_shape"]
        assert len(reads) == SP_CALLS + 1
        by_id = {s[2]: s for s in spans}
        assert all(by_id[s[3]][:2] == ["sp.exchange", "tile_shape"]
                   for s in reads)


def test_sp_host_read_once_a_call(sp_fleet):
    for rank in sp_fleet:
        # the untraced call, the traced ones and the timed one
        assert rank["counters"]["host_reads.sp.tile_shape"] == SP_CALLS + 2


def test_sp_timings_still_time(sp_fleet):
    for rank in sp_fleet:
        assert set(rank["timings"]) == {"exchange", "tile"}
        assert all(v > 0 for v in rank["timings"].values())
