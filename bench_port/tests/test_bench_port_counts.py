"""The frozen roofline arithmetic against counts worked by hand, and each
metric reader on a record made by hand."""

import pytest

from bench_port_tiny import ROOT
from bench_port import harness
from bench_port.counts import bounds, roofline

INT, HBM = 132 * 64 * 1.98e9, 3.35e12


def test_acs_bound_by_hand():
    # S=4, B=2, T=3, R=2, W=1: 2*3*(4*8 + 2*4) = 240 operations; metrics
    # in and out 2*4*2, symbols 2*3*2, words 3*1*2, acc 2: 36 int32
    ms, by = bounds.acs_bound(4, 2, 3, 2, 1)
    assert ms == pytest.approx(max(240 / INT, 144 / HBM) * 1e3)
    assert by == "bytes"
    # Cassini's call: operations dominate
    ms, by = bounds.acs_bound(16384, 512, 2062, 6, 512)
    assert by == "operations"
    assert ms == pytest.approx(512 * 2062 * (16384 * 8 + 6 * 64) / INT * 1e3)


def test_walk_bound_by_hand():
    # 5 rows, 2 frames, 5 bits out, one int32 a row: 4*5*2 + 4*5 + 4*2
    # + 5*2 = 78 bytes, 5*2*8 = 80 operations
    ms, by = bounds.walk_bound(5, 2, 5, 1)
    assert ms == pytest.approx(max(80 / INT, 78 / HBM) * 1e3)
    assert by == "bytes"


def test_roofline_share():
    rec = {"trace": {"kernels": {
        "void rotated_acs_warp<6>(int const*, int*)": [10, 0.004],
        "void chainback_tiled<2>(int const*)": [10, 0.001]}}}
    share = roofline.share(rec, r"\brotated_acs_(warp|kernel)\b", 0.08)
    assert share == pytest.approx(100 * 10 * 0.08e-3 / 0.004)
    assert roofline.share(rec, r"\bplane_acs_kernel\b", 1.0) is None
    assert roofline.share({}, r"x", 1.0) is None


def reader(name):
    return harness.load_module(ROOT / "bench_port" / "metrics"
                               / f"{name}.py").read


SHAPE = {"S": 64, "B": 4, "T": 10, "R": 2, "W": 2, "data_bits": 4}
TRACE = {"idle_share": 0.25, "calls": 4, "device_events": 60,
         "kernels": {"void rotated_acs_warp<6>(int)": [4, 0.002],
                     "void chainback_tiled<2>(int)": [4, 0.001],
                     "void plane_acs_kernel<512>(int)": [2, 0.05],
                     "void plane_walk_kernel<4>(int)": [2, 0.01]}}


@pytest.mark.parametrize("name, rec, want", [
    ("setup_s", {"setup_s": 3.5}, 3.5),
    ("decode_symbols_per_s", {"symbols": 100, "window_s": 4.0}, 25.0),
    ("sp_decode_symbols_per_s", {"symbols": 100, "window_s": 2.0}, 50.0),
    ("push_p95_ms", {"push_latency_s": [i / 1e3 for i in range(101)]}, 95.0),
    ("decoder.enqueue_ms", {"enqueue_s": [1e-3, 3e-3, 2e-3]}, 2.0),
    ("device_idle_share.batch", {"trace": TRACE}, 0.25),
    ("device_idle_share.stream", {"trace": TRACE}, 0.25),
    ("device_idle_share.sp", {"trace": TRACE}, 0.25),
    ("push.kernels", {"trace": TRACE}, 15.0),
    ("sp.tile_ms", {"sp_timings": [[{"tile": 1e-3, "exchange": 5e-3}] * 3,
                                   [{"tile": 2e-3, "exchange": 1e-3}] * 3]},
     2.0),
    ("sp.exchange_ms", {"sp_timings": [[{"tile": 1e-3, "exchange": 5e-3}],
                                       [{"tile": 2e-3, "exchange": 1e-3}]]},
     5.0),
    ("rotated_acs_roofline", {"trace": TRACE, "shape": SHAPE},
     100 * 4 * bounds.acs_bound(64, 4, 10, 2, 2)[0] / 1e3 / 0.002),
    ("chainback_roofline", {"trace": TRACE, "shape": SHAPE},
     100 * 4 * bounds.walk_bound(10, 4, 10, 1)[0] / 1e3 / 0.001),
    ("plane_acs_roofline", {"trace": TRACE, "shape": SHAPE},
     100 * 2 * bounds.acs_bound(64, 4, 10, 2, 2)[0] / 1e3 / 0.05),
    ("plane_walk_roofline", {"trace": TRACE, "shape": SHAPE},
     100 * 2 * bounds.walk_bound(10, 4, 10, 0)[0] / 1e3 / 0.01),
])
def test_reader(name, rec, want):
    assert reader(name)(rec) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "decode_symbols_per_s", "push_p95_ms", "decoder.enqueue_ms",
    "device_idle_share.batch", "push.kernels", "sp.tile_ms",
    "rotated_acs_roofline", "plane_walk_roofline"])
def test_reader_finds_nothing(name):
    """A reader with nothing to read returns None, never 0."""
    assert reader(name)({"shape": SHAPE}) is None
