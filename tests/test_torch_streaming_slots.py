"""The streamer's slots and its CUDA-graph push (streaming.py).

A push consumes its state and updates the stream's slot in place; on a
card's kernel routes every push after a slot's first replays one CUDA
graph.  On the CPU the bookkeeping runs with the eager body standing in
for the replay (``_stand_in``), against a decoder that never captures; on the card (tests marked ``cuda``, in a file that imports no
jax: ``VITERBI_TEST_TPU=1 python -m pytest -m cuda
tests/test_torch_streaming_slots.py``) the graph path is held bit for
bit to ``plain=True`` on every route that captures, and its launch
counters to the profiler's kernels.
"""

import copy
import functools
import threading
import time

import numpy as np
import pytest
import torch

import viterbidecodercpp_torch as pt
from viterbidecodercpp_torch import trace
from viterbidecodercpp_torch.streaming import StreamingDecoder, StreamingState

# name, mode, B, window, chunk (chunks that are not multiples of K-1)
ROUTES = {
    "rotated": ("Voyager", "SOFT8", 3, 36, 9),
    "lane": ("Basic K=5 R=1/2", "SOFT16", 5, 32, 8),
    "plane": ("Cassini", "SOFT16", 2, 24, 8),
}
PUSHES = 6


def _code(name):
    if name.startswith("K="):
        K = int(name[2:])
        return pt.CodeSpec(name, K, ((1 << (K - 1)) | 0o12345,
                                     (1 << (K - 1)) | 0o7651))
    return pt.get_code(name)


def _decoder(route, device="cpu", plain=False, code=None, **kw):
    name, mode, B, window, chunk = ROUTES[route] if code is None else code
    sd = StreamingDecoder(_code(name), mode, window=window, chunk=chunk,
                          device=device, plain=plain, **kw)
    return sd, B


def _stand_in(sd, graphed=True):
    """Take the graph path on a CPU decoder, with the eager body standing
    in for the capture's replays."""
    def capture(slot, src):
        return sd._body(slot, src), tuple(functools.partial(sd._body, slot, r)
                                          for r in (0, 1))
    assert not sd._graphed
    sd._graphed = graphed
    sd._capture = capture
    return sd


def _blocks(sd, B, n, seed, device="cpu"):
    """Random soft symbols, some past the soft range (the push clamps)."""
    rng = np.random.RandomState(seed)
    lo, hi = sd.spec.soft_low, sd.spec.soft_high
    return [torch.as_tensor(rng.randint(lo - 3, hi + 4,
                                        (B, sd.chunk * sd.code.R))
                            .astype(np.int32), device=device)
            for _ in range(n)]


def _start(sd, B, blocks):
    """The tensors of a stream pushed through ``blocks`` on a decoder of
    its own, cloned (a state built by hand from them)."""
    st = sd.reset(B, starting_state=1)
    for blk in blocks:
        st, _, _ = sd.push(st, blk)
    return st.metrics.clone(), st.history.clone(), st.rows_seen.clone()


def _schedule(sd, B, blocks_a, blocks_b, start_b):
    """Stream a from ``reset`` over ``blocks_a``, reset again halfway;
    stream b, interleaved with it, from a state built by hand from
    ``start_b``.  Returns every push's (bits, valid) and the final
    states."""
    a = sd.reset(B)
    b = StreamingState(*start_b)
    out = []
    for i, (xa, xb) in enumerate(zip(blocks_a, blocks_b)):
        if i == len(blocks_a) // 2:
            a = sd.reset(B)
        a, bits, valid = sd.push(a, xa)
        out.append((bits, valid))
        b, bits, valid = sd.push(b, xb)
        out.append((bits, valid))
    return out, a, b


def _same(got, want):
    out, a, b = got
    out_w, a_w, b_w = want
    for i, ((bits, valid), (bits_w, valid_w)) in enumerate(zip(out, out_w)):
        assert valid is valid_w, i
        assert bits.shape == bits_w.shape and bits.dtype == torch.uint8
        assert torch.equal(bits.cpu(), bits_w.cpu()), f"push {i}"
    for st, st_w in ((a, a_w), (b, b_w)):
        for f in ("metrics", "history", "rows_seen"):
            assert torch.equal(getattr(st, f).cpu(), getattr(st_w, f).cpu()), f
        assert st.host_rows == st_w.host_rows


def _run_both(graphed, want, device="cpu", seed=0):
    """The schedule on ``graphed`` and on ``want`` (a decoder that does not
    capture), on the same symbols; returns the graphed run's counters."""
    sd, B = graphed
    blocks_a = _blocks(sd, B, PUSHES, seed, device)
    blocks_b = _blocks(sd, B, PUSHES, seed + 1, device)
    start = _start(want, B, _blocks(sd, B, 3, seed + 2, device))
    trace.reset_counters()
    got = _schedule(sd, B, blocks_a, blocks_b, start)
    counts = trace.counters()
    _same(got, _schedule(want, B, blocks_a, blocks_b, start))
    return counts


def _graph_counts(counts):
    return [counts.get("streaming." + k, 0)
            for k in ("graph_captures", "eager_pushes", "graph_replays")]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_stand_in_replays_equal_the_eager_push(route):
    """The slots' bookkeeping with the eager body standing in for the
    replay: two streams (one reset halfway, one from a state built by
    hand) take two slots, capture once each, and push exactly as a
    decoder that never captures."""
    sd, B = _decoder(route)
    _stand_in(sd)
    counts = _run_both((sd, B), _decoder(route)[0])
    assert _graph_counts(counts) == [2, 2, 2 * PUSHES - 2]


def test_eager_routes_count_eager_pushes():
    sd, B = _decoder("rotated", backend="torch")
    assert sd.backend == "torch"
    counts = _run_both((sd, B), _decoder("rotated", backend="torch")[0])
    assert _graph_counts(counts) == [0, 2 * PUSHES, 0]


@pytest.mark.parametrize("graphed", [False, True])
def test_a_pushed_state_is_consumed(graphed):
    sd, B = _decoder("rotated")
    _stand_in(sd, graphed)
    blk = _blocks(sd, B, 1, 3)[0]
    st0 = sd.reset(B)
    st1, _, _ = sd.push(st0, blk)
    twin = copy.copy(st1)
    st2, _, _ = sd.push(st1, blk)
    # the shapes are checked first, then the state
    with pytest.raises(ValueError, match="chunk"):
        sd.push(st1, blk[:, :-1])
    with pytest.raises(ValueError, match="frames"):
        sd.push(st1, blk[:1])
    for spent in (st0, st1, twin):
        with pytest.raises(ValueError, match="consumed"):
            sd.push(spent, blk)
    other, _ = _decoder("rotated")
    with pytest.raises(ValueError, match="another StreamingDecoder"):
        other.push(st2, blk)
    # the returned state goes on
    _, _, valid = sd.push(st2, blk)
    assert valid is False


def test_slots_are_recycled_and_kept_apart():
    sd, B = _decoder("lane")
    _stand_in(sd)
    blk = _blocks(sd, B, 1, 4)[0]
    trace.reset_counters()
    ptrs = set()
    for _ in range(4):
        st, _, _ = sd.push(sd.reset(B), blk)
        ptrs.add(st.metrics.data_ptr())
        del st
    # the last state's slot returns as it goes; one capture served all
    assert len(ptrs) == 1 and len(sd._free[B]) == 1
    assert _graph_counts(trace.counters()) == [1, 1, 3]
    a, _, _ = sd.push(sd.reset(B), blk)
    b, _, _ = sd.push(sd.reset(B), blk)
    assert a.metrics.data_ptr() != b.metrics.data_ptr()
    assert not sd._free[B]
    a2, _, _ = sd.push(a, blk)
    del a
    assert not sd._free[B], "a consumed state outlived by its successor"
    del a2, b
    # one free slot is kept a batch size; the other goes
    assert len(sd._free[B]) == 1
    # another batch size takes a slot of its own
    st, _, _ = sd.push(sd.reset(B + 1), _blocks(sd, B + 1, 1, 5)[0])
    assert st.metrics.shape == (sd.spec.S, B + 1)
    assert len(sd._free[B]) == 1


def test_a_state_built_by_hand_is_copied_in():
    sd, B = _decoder("plane")
    blocks = _blocks(sd, B, 3, 6)
    start = _start(sd, B, blocks[:2])
    hand = StreamingState(*start)
    st, bits, valid = sd.push(hand, blocks[2])
    # its tensors are the caller's: read, never written
    for x, y in zip((hand.metrics, hand.history, hand.rows_seen), start):
        assert torch.equal(x, y) and x is y
    assert st.metrics is not hand.metrics and st.host_rows == 3 * sd.chunk
    with pytest.raises(ValueError, match="consumed"):
        sd.push(hand, blocks[2])
    with pytest.raises(ValueError, match="state's tensors"):
        sd.push(StreamingState(start[0], start[1][:, 1:], start[2]),
                blocks[2])


def test_the_graph_engages_by_device_plain_and_route():
    k20 = ("K=20", "SOFT16", 2, 16, 8)
    cases = [("rotated", {}, "cuda", True), ("lane", {}, "cuda", True),
             ("plane", {}, "cuda", True), ("rotated", {}, "cpu", False),
             ("lane", {"plain": True}, "cuda", False),
             ("rotated", {"backend": "torch"}, "cuda", False)]
    for route, kw, device, want in cases:
        sd, _ = _decoder(route, device=device, **kw)
        assert sd._graphed is want, (route, kw, device)
    for code, want in ((("K=18",) + k20[1:], True), (k20, False)):
        sd, _ = _decoder("plane", device="cuda", code=code)
        assert sd.backend == "plane" and sd._graphed is want, code


def test_held_counts_move_to_the_replays():
    trace.reset_counters()
    trace.count("launches.k")
    with trace.held() as counts:
        trace.count("launches.k", 2)
        trace.count("launches.j")
    assert counts == {"launches.k": 2, "launches.j": 1}
    assert trace.counters() == {"launches.k": 1}
    trace.add(counts)
    trace.add(counts)
    assert trace.counters() == {"launches.k": 5, "launches.j": 2}
    # another thread's counts during a hold are its own
    with trace.held() as counts:
        worker = threading.Thread(target=trace.count, args=("launches.j",))
        worker.start()
        worker.join()
        trace.count("launches.k")
    assert counts == {"launches.k": 1}
    assert trace.counters() == {"launches.k": 5, "launches.j": 3}


def test_a_push_shifts_the_ring_into_the_slots_other_ring():
    sd, B = _decoder("rotated")
    _stand_in(sd)
    blk = _blocks(sd, B, 1, 7)[0]
    st = sd.reset(B)
    rings = []
    for _ in range(4):
        st, _, _ = sd.push(st, blk)
        rings.append(st.history.data_ptr())
    assert rings[0] == rings[2] != rings[1] == rings[3]


# -- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph replays the kernels, "
                    "which have no CPU mode")
    return torch.device("cuda")


CARD_ROUTES = {
    "rotated": ("Voyager", "SOFT8", 64, 72, 9),
    "lane": ("Basic K=5 R=1/2", "SOFT16", 100, 64, 16),
    "plane": ("Cassini", "SOFT16", 3, 56, 8),
    "plane-cluster": ("K=18", "SOFT16", 2, 48, 16),
    "plane-global": ("K=20", "SOFT16", 2, 40, 8),
}


def _launch_check(sd, B, blocks):
    """Each launch counter's increase over pushes of a stream against the
    profiler's kernels of that name."""
    from torch.profiler import ProfilerActivity, profile

    st, _, _ = sd.push(sd.reset(B), blocks[0])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the profiler can miss its window's first kernels: count from
        # after a kernel of no counted name, once the card is idle
        torch.ones(1, device=st.metrics.device).add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        before = trace.counters()
        for blk in blocks:
            st, _, _ = sd.push(st, blk)
        torch.cuda.synchronize()
    after = trace.counters()
    names = [e.name for e in prof.events()
             if e.device_type != torch.autograd.DeviceType.CPU]
    grown = {k[len("launches."):]: v - before.get(k, 0)
             for k, v in after.items()
             if k.startswith("launches.") and v != before.get(k, 0)}
    assert grown, "no launch counted"
    return {k: [n, sum(k in name for name in names)]
            for k, n in grown.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(CARD_ROUTES))
def test_graph_push_equals_plain_on_card(route, card):
    code = CARD_ROUTES[route]
    graphed = _decoder(None, device=card, code=code)
    plain, _ = _decoder(None, device=card, code=code, plain=True)
    sd, B = graphed
    assert sd._graphed is (route != "plane-global")
    counts = _run_both(graphed, plain, device=card, seed=11)
    if sd._graphed:
        assert _graph_counts(counts) == [2, 2, 2 * PUSHES - 2]
    else:
        assert _graph_counts(counts) == [0, 2 * PUSHES, 0]
    checks = _launch_check(sd, B, _blocks(sd, B, 4, 12, card))
    for k, (n, events) in checks.items():
        assert n == events, (k, checks)
