"""The route (ops/route.py) and the kernels' launch helper (ops/_build.py).

``route_for`` decides once what the decoder, the streamer and the
time-parallel call run on: each case holds it, for a registry code, a
backend and a device (a card compared by value: nothing here touches
one), to the rule by state count S = 2^(K-1) written out afresh.  The
launch helper runs on the CPU with a stand-in ctypes function in place of
a kernel's launcher, and stand-ins for the card's device and stream.
"""

import contextlib
import ctypes
import functools
import types

import pytest
import torch

import viterbidecodercpp_torch as pt
from viterbidecodercpp_torch import trace
from viterbidecodercpp_torch.ops import _build, torch_core
from viterbidecodercpp_torch.ops.route import route_for

CODES = [c.name for c in pt.COMMON_CODES]
BACKENDS = ["auto", "rotated", "plane", "lane", "torch"]
DEVICES = ["cpu", "cuda"]


def _spec(code):
    return torch_core.make_static_spec(
        code, pt.get_decode_config(pt.DecodeType.SOFT16, code.R))


def _big(K):
    return pt.CodeSpec(f"K={K}", K, ((1 << (K - 1)) | 0o12345,
                                     (1 << (K - 1)) | 0o7651))


def _kernel_class(S):
    if S <= 32:
        return "lane"
    return "rotated" if S <= 4096 else "plane"


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", CODES)
def test_route_for_picks_what_the_callers_picked(name, backend, device):
    code = pt.get_code(name)
    spec = _spec(code)
    cls = _kernel_class(spec.S)
    if backend not in ("auto", "torch", cls):
        with pytest.raises(ValueError, match=f"the {backend} backend covers"):
            route_for(spec, device, backend)
        return
    want = cls if backend == "auto" else backend
    n = code.K - 1
    rows = 3 * n + 1
    for plain in (False, True):
        r = route_for(spec, torch.device(device), backend, plain)
        assert r.name == want and r.plain is plain
        assert r.slot_order is (want in ("rotated", "plane"))
        # every registry code lies below the cooperative plane ACS (K >= 20)
        assert r.graphable is (device == "cuda" and not plain
                               and want != "torch")
        if want == "plane":
            assert r.time_axis == 1
            # a checkpoint's buffer rounds up to the time block, 2 (K-1)
            assert r.buffer_rows(rows) == 4 * n
            assert r.rows_shape(5, rows) == (5, rows, spec.S // 4096, 128)
            assert r.capacity(4 * n, rows) == rows
        else:
            assert r.time_axis == 0
            assert r.buffer_rows(rows) == rows
            assert r.rows_shape(5, rows) == (rows, spec.W, 5)
            assert r.capacity(rows + 9, rows) == rows + 9
    lo, hi = spec.soft_low, spec.soft_high
    got = r.clamp(torch.tensor([[-1000, lo - 1, 0, hi + 1, 1000]]))
    assert got.dtype == torch.int32
    assert got.tolist() == [[lo, lo, 0, hi, hi]]


@pytest.mark.parametrize("K,graphable", [(18, True), (20, False)])
def test_a_card_graphs_the_plane_route_below_the_cooperative_acs(K,
                                                                 graphable):
    spec = _spec(_big(K))
    r = route_for(spec, "cuda")
    assert r.name == "plane" and r.graphable is graphable
    assert not route_for(spec, "cpu").graphable
    assert not route_for(spec, "cuda", plain=True).graphable


def test_route_for_refuses_a_device_other_than_a_card_or_the_cpu():
    with pytest.raises(ValueError, match="unsupported device meta"):
        route_for(_spec(pt.get_code("Voyager")), "meta")


# -- the launch helper -------------------------------------------------------

PARAMS = (ctypes.c_int, ctypes.c_void_p)
STREAM = 0x5EED
CARD = torch.device("cuda", 0)


@pytest.fixture
def stand_in(monkeypatch):
    """``vdt_stand_in`` of a library ``stand_in``: a ctypes function that
    returns its first argument as the CUDA error.  The card's device
    context and current stream are stand-ins too, and ``kernel`` starts
    with a cache of its own."""
    calls, loads = [], []

    def body(err, stream):
        calls.append((err, stream))
        return err

    class Lib:
        vdt_stand_in = ctypes.CFUNCTYPE(ctypes.c_int, *PARAMS)(body)

    def load(name):
        loads.append(name)
        return Lib

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "kernel", functools.lru_cache(maxsize=None)(
        _build.kernel.__wrapped__))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: types.SimpleNamespace(
                            cuda_stream=STREAM))
    return types.SimpleNamespace(fn=Lib.vdt_stand_in, calls=calls,
                                 loads=loads)


def test_a_launcher_is_bound_once(stand_in):
    fn = _build.kernel("stand_in", "vdt_stand_in", PARAMS)
    assert fn is stand_in.fn
    assert fn.restype is ctypes.c_int and tuple(fn.argtypes) == PARAMS
    assert _build.kernel("stand_in", "vdt_stand_in", PARAMS) is fn
    assert stand_in.loads == ["stand_in"]


@pytest.mark.parametrize("launches", [1, 3])
def test_a_launch_passes_the_stream_last_and_counts_once(stand_in,
                                                         launches):
    fn = _build.kernel("stand_in", "vdt_stand_in", PARAMS)
    before = trace.counters().get("launches.stand_in", 0)
    for _ in range(launches):
        _build.launch(fn, "stand_in", CARD, 0)
    assert stand_in.calls == [(0, STREAM)] * launches
    assert trace.counters()["launches.stand_in"] == before + launches


@pytest.mark.parametrize("err", [1, 700])
def test_a_launch_error_raises_naming_the_kernel(stand_in, err):
    fn = _build.kernel("stand_in", "vdt_stand_in", PARAMS)
    before = trace.counters().get("launches.stand_in", 0)
    with pytest.raises(RuntimeError, match=f"^stand_in kernel launch failed: "
                                           f"CUDA error {err}$"):
        _build.launch(fn, "stand_in", CARD, err)
    assert stand_in.calls == [(err, STREAM)]
    assert trace.counters().get("launches.stand_in", 0) == before


def test_the_kernels_take_contiguous_int32_only():
    ok = torch.zeros(4, 2, dtype=torch.int32)
    _build.check_cuda(a=ok, b=None)
    for bad in (ok.to(torch.int64), ok.t()):
        with pytest.raises(ValueError, match="^x must be contiguous int32"):
            _build.check_cuda(a=ok, x=bad)
