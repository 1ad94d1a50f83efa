"""LTE's tail-biting code on the port: the encoder and the rate matching
against transcriptions of 3GPP TS 36.212 (5.1.3.1, 5.1.4.2), and
``ViterbiDecoder.decode_tailbiting`` against the plain reference
(``tests/tailbiting_reference.py``) bit for bit, metric and
renormalisation total included, on every route.

The file imports no jax; its card test (marked ``cuda``) runs on the
chip with ``VITERBI_TEST_TPU=1 python -m pytest -m cuda
tests/test_torch_tailbiting.py``.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import tailbiting_reference as ref  # noqa: E402

import viterbidecodercpp_torch as pt  # noqa: E402
from viterbidecodercpp_torch import ratematch, trace  # noqa: E402
from viterbidecodercpp_torch.ops import chainback, encoder  # noqa: E402
from viterbidecodercpp_torch.ops import torch_core  # noqa: E402

LTE = pt.CodeSpec("LTE TBCC", 7, (109, 79, 87))
# the cell's frames: DCI formats 0/1A, 1, 2A, 2 and their 16-bit CRC
SIZES = (44, 55, 64, 67)
LEVELS = (1, 2, 4, 8)
CCE_BITS = 72


def _bits(n, L, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2, (n, L), generator=g, dtype=torch.uint8)


@pytest.mark.parametrize("L", SIZES)
def test_encoder_is_36212(L):
    data = _bits(16, L, L)
    assert torch.equal(encoder.encode_bits_tailbiting(LTE, data).long(),
                       ref.encode(data))


def test_encoder_ends_where_it_starts():
    """The register starts from the frame's last K-1 bits: a frame
    rotated by one step encodes to the code words rotated alike."""
    data = _bits(4, 44, 1)
    y = encoder.encode_bits_tailbiting(LTE, data)
    z = encoder.encode_bits_tailbiting(LTE, torch.roll(data, 1, dims=1))
    assert torch.equal(torch.roll(y, 1, dims=1), z)
    with pytest.raises(ValueError, match="L >= K-1"):
        encoder.encode_bits_tailbiting(LTE, data[:, :5])


def test_registry_lte_tuple_is_the_mirror_image():
    """The registry's LTE tuple (91, 117, 121) is 36.212's 133, 165, 171
    read with the opposite bit order: bit-reversed it is this code's G
    in another order, and as it stands it encodes another code."""
    reg = pt.get_code("LTE").G
    rev = tuple(int(format(g, "07b")[::-1], 2) for g in reg)
    assert sorted(rev) == sorted(LTE.G) and rev != LTE.G
    data = _bits(4, 44, 2)
    assert not torch.equal(
        encoder.encode_bits_tailbiting(pt.CodeSpec("x", 7, reg), data).long(),
        ref.encode(data))


@pytest.mark.parametrize("L", SIZES)
@pytest.mark.parametrize("AL", LEVELS)
def test_rate_matching_is_36212(L, AL):
    E = AL * CCE_BITS
    idx = ratematch.index_map(L, E)
    assert idx.tolist() == ref.rate_match_positions(L, E)
    coded = ref.encode(_bits(8, L, L + AL))
    assert torch.equal(ratematch.match(coded, E), ref.match(coded, E))
    g = torch.Generator().manual_seed(E + L)
    soft = torch.randint(-127, 128, (8, E), generator=g, dtype=torch.int16)
    got = ratematch.dematch(soft, L, low=-127, high=127)
    assert got.dtype == torch.int32
    assert torch.equal(got, ref.dematch(soft, L, -127, 127))
    # copies a position: summed, then clamped; never sent: 0
    copies = np.bincount(idx, minlength=3 * L)
    sums = torch.zeros(8, 3 * L, dtype=torch.int64).index_add_(
        1, torch.tensor(idx), soft.long())
    assert torch.equal(got.long(), sums.clamp(-127, 127))
    assert (got[:, copies == 0] == 0).all()
    assert copies.max() - copies.min() <= 1
    assert (copies == 0).any() == (E < 3 * L)


def test_dematch_into_rows_of_a_batch():
    L, E = 44, 144
    soft = torch.randint(-200, 200, (3, 5, E), dtype=torch.int32)
    buf = torch.full((20, 3 * L), 99, dtype=torch.int32)
    out = buf[4:19].view(3, 5, 3 * L)
    ratematch.dematch(soft, L, low=-127, high=127, out=out)
    assert torch.equal(buf[4:19], ref.dematch(soft.reshape(15, E), L, -127,
                                              127))
    assert (buf[:4] == 99).all() and (buf[19:] == 99).all()
    with pytest.raises(ValueError, match="contiguous int32"):
        ratematch.dematch(soft, L, low=-127, high=127,
                          out=buf[:15].to(torch.int64))


# backend, K, G, decode type, arith, L: every route, both arithmetics,
# renormalisation (SOFT8 at any L; SOFT16, whose threshold is 61725,
# past ~300 steps on random symbols)
ROUTES = [
    ("rotated", 7, LTE.G, "SOFT16", "saturating", 67),
    ("rotated", 7, LTE.G, "SOFT16", "saturating", 120),
    ("rotated", 7, LTE.G, "SOFT16", "wrapping", 44),
    ("rotated", 7, LTE.G, "SOFT8", "saturating", 55),
    ("rotated", 9, (0o753, 0o561, 0o711), "SOFT16", "saturating", 20),
    ("lane", 5, (19, 27, 29), "SOFT16", "saturating", 30),
    ("lane", 3, (7, 5, 5), "SOFT8", "wrapping", 12),
    ("plane", 14, (8193 + 2 + 64, 8193 + 128 + 4096), "SOFT16",
     "saturating", 13),
    ("torch", 7, LTE.G, "SOFT16", "saturating", 64),
    ("torch", 7, LTE.G, "HARD8", "wrapping", 21),
]


def _route_case(backend, K, G, dt, arith, L, B=5, seed=0, device="cpu"):
    code = pt.CodeSpec("t", K, G)
    cfg = pt.get_decode_config(pt.DecodeType(dt), len(G), arith=arith)
    dec = pt.ViterbiDecoder(code, cfg, backend=backend, device=device)
    g = torch.Generator().manual_seed(K * 1000 + L + seed)
    hi = cfg.soft_decision_high
    syms = torch.randint(-hi - 2, hi + 3, (B, L * len(G)), generator=g)
    return dec, syms, ref.trellis(K, G, dt, arith)


@pytest.mark.parametrize("backend, K, G, dt, arith, L", ROUTES,
                         ids=[f"{r[0]}-K{r[1]}-{r[3]}-{r[4]}" for r in ROUTES])
def test_decode_equals_reference(backend, K, G, dt, arith, L):
    dec, syms, tr = _route_case(backend, K, G, dt, arith, L)
    assert dec.backend == backend
    bits, metric, acc = dec.decode_tailbiting(syms, L)
    want = ref.decode(tr, syms.reshape(len(syms), L, len(G)))
    assert bits.shape == (len(syms), L) and bits.dtype == torch.uint8
    assert torch.equal(bits, want[0])
    assert torch.equal(metric.long(), want[1])
    assert torch.equal(acc.long(), want[2])
    if (dt, L) in (("SOFT16", 120), ("SOFT8", 55)):
        assert (acc > 0).all()        # the case renormalises


@pytest.mark.parametrize("L", SIZES)
@pytest.mark.parametrize("AL", LEVELS)
def test_round_trip(L, AL):
    """Noise-free: encode, match to E = 72 AL, dematch, decode returns the
    data, punctured (AL 1 at L > 24) or repeated."""
    data = _bits(6, L, 7 * L + AL)
    sent = ratematch.match(encoder.encode_bits_tailbiting(LTE, data),
                           AL * CCE_BITS)
    soft = torch.where(sent == 1, 127, -127).to(torch.int16)
    syms = ratematch.dematch(soft, L, low=-127, high=127)
    dec = pt.ViterbiDecoder(LTE, "SOFT16", device="cpu")
    bits, metric, _ = dec.decode_tailbiting(syms, L)
    assert torch.equal(bits, data)
    # every sent symbol agrees with the path; each punctured one costs
    # 127 whichever bit it stood for
    unsent = int((np.bincount(ratematch.index_map(L, AL * CCE_BITS),
                              minlength=3 * L) == 0).sum())
    assert (metric == 127 * unsent * 3).all()


def test_walk_span_is_a_slice_of_the_whole_walk():
    """chainback's span of data bits is that slice of the whole walk from
    the history's last row, given rotations or on the one-shot
    schedule."""
    spec = torch_core.make_static_spec(
        LTE, pt.get_decode_config(pt.DecodeType.SOFT16, 3))
    g = torch.Generator().manual_seed(3)
    packed = torch.randint(-2**31, 2**31 - 1, (40, spec.W, 4), generator=g,
                           dtype=torch.int32)
    start = torch.tensor([0, 5, 63, 17], dtype=torch.int32)
    rots = (torch.arange(40, dtype=torch.int32) * 7) % 6
    for slot_order, r in ((False, None), (True, rots), (True, None)):
        kw = {"slot_order": slot_order, "rots": r}
        whole = chainback.walk_rows(spec, packed, start, **kw)
        part = chainback.chainback(spec, packed, start, 34, first_bit=9,
                                   n_bits=20, **kw)
        assert torch.equal(part, whole[15:35].t())
        rest = chainback.chainback(spec, packed, start, 34, first_bit=9,
                                   **kw)
        assert torch.equal(rest, whole[15:].t())
    with pytest.raises(ValueError, match="lie outside"):
        chainback.chainback(spec, packed, start, 34, first_bit=20,
                            n_bits=20)


def test_decode_refuses_bad_shapes():
    dec = pt.ViterbiDecoder(LTE, "SOFT16", device="cpu")
    with pytest.raises(ValueError, match=r"\(B, 132\)"):
        dec.decode_tailbiting(torch.zeros(2, 131, dtype=torch.int32), 44)
    with pytest.raises(ValueError, match="total_bits >= K-1"):
        dec.decode_tailbiting(torch.zeros(2, 15, dtype=torch.int32), 5)


def test_spans_and_counters():
    dec = pt.ViterbiDecoder(LTE, "SOFT16", device="cpu")
    soft = torch.randint(-127, 128, (3, 144), dtype=torch.int16)
    before = trace.counters()
    trace.drain()
    trace.enable()
    try:
        syms = ratematch.dematch(soft, 44, low=-127, high=127)
        dec.decode_tailbiting(syms, 44)
    finally:
        trace.disable()
    spans = trace.drain()
    names = [s.name for s in spans]
    assert names[:2] == ["ratematch.dematch", "decoder.tailbiting"]
    root = spans[1]
    kids = [s.name for s in spans if s.parent == root.id]
    assert kids == ["decoder.update", "decoder.chainback"]
    after = trace.counters()
    assert after.get("tailbiting.frames", 0) - \
        before.get("tailbiting.frames", 0) == 3
    assert after.get("tailbiting.rows", 0) - \
        before.get("tailbiting.rows", 0) == 3 * 132


def test_frozen_copy_agrees():
    """``bench_port/reference/tailbiting.py``, the benchmark's judge,
    gives this reference's answers."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "bench_port",
                        "reference", "tailbiting.py")
    spec = importlib.util.spec_from_file_location("frozen_tailbiting", path)
    frozen = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = frozen
    spec.loader.exec_module(frozen)
    data = _bits(3, 55, 9)
    assert torch.equal(frozen.encode(data), ref.encode(data))
    assert frozen.rate_match_positions(55, 288) == \
        ref.rate_match_positions(55, 288)
    soft = torch.randint(-300, 300, (3, 72), dtype=torch.int32)
    syms = frozen.dematch(soft, 55, -127, 127)
    assert torch.equal(syms, ref.dematch(soft, 55, -127, 127))
    for width in (None, 8):
        a = frozen.decode(frozen.trellis(7, LTE.G, "SOFT16",
                                         metric_bits=width),
                          syms.reshape(3, 55, 3))
        b = ref.decode(ref.trellis(7, LTE.G, "SOFT16", metric_bits=width),
                       syms.reshape(3, 55, 3))
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_card_equals_plain_route():
    """On the card: the kernels' circular decode of one of the blind
    decoding cell's calls (every candidate of a few subframes at L=67)
    equals the plain route's on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run on the card only")
    g = torch.Generator().manual_seed(20)
    soft = torch.randint(-127, 128, (157 * 4, 8 * CCE_BITS), generator=g,
                         dtype=torch.int16)
    syms = ratematch.dematch(soft, 67, low=-127, high=127)
    want = pt.ViterbiDecoder(LTE, "SOFT16", device="cpu") \
        .decode_tailbiting(syms, 67)
    cuda = ratematch.dematch(soft.cuda(), 67, low=-127, high=127)
    assert torch.equal(cuda.cpu(), syms)
    got = pt.ViterbiDecoder(LTE, "SOFT16", device="cuda") \
        .decode_tailbiting(cuda, 67)
    assert all(torch.equal(x.cpu(), y) for x, y in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("backend, K, G, dt, arith, L",
                         [r for r in ROUTES if r[0] != "torch"],
                         ids=[f"{r[0]}-K{r[1]}-{r[3]}-{r[4]}" for r in ROUTES
                              if r[0] != "torch"])
def test_card_route_equals_reference(backend, K, G, dt, arith, L):
    """On the card: each route's kernels give the reference's circular
    decode, at the CPU test's cases."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run on the card only")
    dec, syms, tr = _route_case(backend, K, G, dt, arith, L, device="cuda")
    assert dec.backend == backend
    got = dec.decode_tailbiting(syms.cuda(), L)
    want = ref.decode(tr, syms.reshape(len(syms), L, len(G)))
    assert all(torch.equal(x.cpu().long(), y.long())
               for x, y in zip(got, want))


@pytest.mark.cuda
def test_card_launch_counters_equal_profiler_kernels():
    """On the card: the launch counters' increase over circular decodes
    of the cell's four sizes equals the profiler's kernels of each name,
    and the circular decode's counters count its frames and rows."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run on the card only")
    import time

    from torch.profiler import ProfilerActivity, profile
    dec = pt.ViterbiDecoder(LTE, "SOFT16", device="cuda")
    soft = torch.randint(-127, 128, (157, 4 * CCE_BITS), dtype=torch.int16,
                         device="cuda")
    syms = {L: ratematch.dematch(soft, L, low=-127, high=127) for L in SIZES}
    for L in SIZES:
        dec.decode_tailbiting(syms[L], L)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the profiler can miss its window's first kernels: count from
        # after a kernel of no counted name, once the card is idle
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        before = trace.counters()
        for L in SIZES:
            dec.decode_tailbiting(syms[L], L)
        torch.cuda.synchronize()
        time.sleep(0.05)
    after = trace.counters()
    names = [e.name for e in prof.events()
             if e.device_type != torch.autograd.DeviceType.CPU]
    for kernel in ("rotated_acs", "chainback"):
        key = "launches." + kernel
        assert after[key] - before.get(key, 0) == len(SIZES)
        assert sum(kernel in n for n in names) == len(SIZES), names
    assert after["tailbiting.frames"] - before.get("tailbiting.frames", 0) \
        == 157 * len(SIZES)
    assert after["tailbiting.rows"] - before.get("tailbiting.rows", 0) \
        == 157 * 3 * sum(SIZES)
