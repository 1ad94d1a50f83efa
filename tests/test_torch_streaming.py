"""The port's StreamingDecoder against the JAX package's, route by route.

On the CPU the port runs the plain versions of its kernels; the JAX side
runs StreamingDecoder(backend="pallas") (its Pallas kernels in interpret
mode) or backend="xla".  Every push's committed bits and ``valid`` are
compared, and the final metrics; the decision ring too wherever both
sides keep one layout: slot-order rows on the rotated route and the JAX
rotated kernel, state-order rows on the lane route and the JAX lane
kernel, state-order rows on the torch route and the JAX xla scan, the
(B, window, W/128, 128) plane ring on the plane route and the JAX plane
kernel.  Chunks that are not multiples of K-1 exercise the per-push
restart of the ACS schedule and the static ring rotations.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import viterbidecodercpp_torch as pt
import viterbidecodercpp_tpu as vt
from viterbidecodercpp_torch.ops import encoder
from viterbidecodercpp_torch.streaming import StreamingDecoder
from viterbidecodercpp_torch.utils import testsig
from viterbidecodercpp_tpu.streaming import StreamingDecoder as JaxStreaming


def _eq(got, want):
    if isinstance(got, torch.Tensor):
        got = got.cpu().numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


def _blocks(code, mode, B, chunk, n_push, seed, spread=1):
    """Random soft symbols per push, some past the soft range (the
    streamer clamps them)."""
    cfg = pt.get_decode_config(pt.DecodeType(mode), code.R)
    rng = np.random.RandomState(seed)
    return [rng.randint(cfg.soft_decision_low - spread,
                        cfg.soft_decision_high + spread + 1,
                        (B, chunk * code.R)).astype(np.int32)
            for _ in range(n_push)]


def _compare(name, mode, window, chunk, backend, jax_backends, blocks,
             ring_backend=None):
    """Push ``blocks`` through the port and each JAX streamer; returns the
    final port state."""
    sd = StreamingDecoder(pt.get_code(name), mode, window=window,
                          chunk=chunk, device="cpu")
    assert sd.backend == backend
    jsds = {b: JaxStreaming(vt.get_code(name), mode, window=window,
                            chunk=chunk, backend=b) for b in jax_backends}
    B = blocks[0].shape[0]
    st = sd.reset(B)
    jst = {b: j.reset(B) for b, j in jsds.items()}
    for blk in blocks:
        st, bits, valid = sd.push(st, blk)
        assert isinstance(valid, bool)
        assert bits.dtype == torch.uint8 and bits.shape == (B, chunk)
        for b, j in jsds.items():
            jst[b], jbits, jvalid = j.push(jst[b], jnp.asarray(blk))
            assert valid == bool(jvalid)
            _eq(bits, jbits)
    for b in jsds:
        _eq(st.metrics, jst[b].metrics)
        _eq(st.rows_seen, jst[b].rows_seen)
    if ring_backend is not None:
        _eq(st.history, jst[ring_backend].history)
    return st


def test_rotated_route_matches_jax_pallas_and_xla():
    name, mode, window, chunk = "Voyager", "SOFT8", 72, 9   # chunk % 6 != 0
    blocks = _blocks(vt.get_code(name), mode, 2, chunk, 16, seed=8)
    st = _compare(name, mode, window, chunk, "rotated", ("pallas", "xla"),
                  blocks, ring_backend="pallas")
    assert st.history.shape == (window, 2, 2)


def test_lane_route_matches_jax_pallas():
    name, mode, window, chunk = "Basic K=5 R=1/2", "SOFT16", 64, 16
    blocks = _blocks(vt.get_code(name), mode, 3, chunk, 9, seed=4)
    st = _compare(name, mode, window, chunk, "lane", ("pallas",), blocks,
                  ring_backend="pallas")
    assert st.history.shape == (window, 1, 3)


def test_torch_route_matches_jax_xla():
    name, mode, window, chunk = "Voyager", "HARD8", 40, 10   # chunk % 6 != 0
    code = pt.get_code(name)
    sd = StreamingDecoder(code, mode, window=window, chunk=chunk,
                          backend="torch", device="cpu")
    jsd = JaxStreaming(vt.get_code(name), mode, window=window, chunk=chunk,
                       backend="xla")
    st, jst = sd.reset(2), jsd.reset(2)
    for blk in _blocks(code, mode, 2, chunk, 7, seed=2):
        st, bits, valid = sd.push(st, blk)
        jst, jbits, jvalid = jsd.push(jst, jnp.asarray(blk))
        assert valid == bool(jvalid)
        _eq(bits, jbits)
    for f in ("metrics", "history", "rows_seen"):
        _eq(getattr(st, f), getattr(jst, f))


def test_plane_route_matches_jax_xla_and_plane_ring():
    """Cassini (chunk % 14 != 0): bits, valid and metrics against the
    JAX xla streamer over the whole stream; the plane ring against the
    JAX plane kernel's over its first two pushes (interpret mode is
    slow)."""
    name, mode, window, chunk = "Cassini", "SOFT16", 56, 8
    code = vt.get_code(name)
    blocks = _blocks(code, mode, 1, chunk, 9, seed=7, spread=3)
    st = _compare(name, mode, window, chunk, "plane", ("xla",), blocks)
    assert st.history.shape == (1, window, 4, 128)
    sd = StreamingDecoder(pt.get_code(name), mode, window=window,
                          chunk=chunk, device="cpu")
    jsd = JaxStreaming(code, mode, window=window, chunk=chunk,
                       backend="pallas")
    assert jsd._plane
    s, js = sd.reset(1), jsd.reset(1)
    for blk in blocks[:2]:
        s, bits, _ = sd.push(s, blk)
        js, jbits, _ = jsd.push(js, jnp.asarray(blk))
        _eq(bits, jbits)
    for f in ("metrics", "history", "rows_seen"):
        _eq(getattr(s, f), getattr(js, f))


def test_argmin_ties_take_the_first_minimum():
    """Zero symbols carry no information, so many states tie for the
    best metric; the walk must start from the first of them, as
    jnp.argmin does."""
    name, mode, window, chunk = "Basic K=3 R=1/2", "SOFT16", 16, 4
    code = pt.get_code(name)
    sd = StreamingDecoder(code, mode, window=window, chunk=chunk, device="cpu")
    jsd = JaxStreaming(vt.get_code(name), mode, window=window, chunk=chunk,
                       backend="xla")
    st, jst = sd.reset(2, starting_state=1), jsd.reset(2, starting_state=1)
    rng = np.random.RandomState(3)
    ties = 0
    for i in range(8):
        blk = np.zeros((2, chunk * code.R), np.int32)
        if i % 3 == 2:
            blk[0] = rng.randint(-127, 128, chunk * code.R)
        st, bits, valid = sd.push(st, blk)
        jst, jbits, jvalid = jsd.push(jst, jnp.asarray(blk))
        assert valid == bool(jvalid)
        _eq(bits, jbits)
        m = st.metrics
        ties += int(((m == m.min(dim=0).values).sum(dim=0) > 1).sum())
    _eq(st.metrics, jst.metrics)
    assert ties > 0, "the stream never tied: the test does not test ties"


def test_priming_and_errors():
    code = pt.get_code("Basic K=5 R=1/2")
    sd = StreamingDecoder(code, "HARD8", window=64, chunk=16, device="cpu")
    state = sd.reset(1)
    primed = []
    for _ in range(6):
        state, _, valid = sd.push(state, np.zeros((1, 16 * code.R), np.int32))
        primed.append(valid)
    assert primed == [False, False, False, True, True, True]
    assert state.host_rows == 96
    # a state without the host mirror reads the row count once
    loaded = pt.StreamingState(state.metrics, state.history,
                               state.rows_seen)
    _, _, valid = sd.push(loaded, np.zeros((1, 16 * code.R), np.int32))
    assert valid is True
    with pytest.raises(ValueError, match="chunk"):
        sd.push(state, np.zeros((1, 8), np.int32))
    with pytest.raises(ValueError, match="frames"):
        sd.push(state, np.zeros((2, 16 * code.R), np.int32))
    with pytest.raises(ValueError, match="multiple of chunk"):
        StreamingDecoder(code, "HARD8", window=60, chunk=16, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        StreamingDecoder(code, "HARD8", window=64, chunk=16, backend="xla",
                         device="cpu")
    with pytest.raises(ValueError, match="rotated backend"):
        StreamingDecoder(code, "HARD8", window=64, chunk=16,
                         backend="rotated", device="cpu")
    k18 = pt.CodeSpec("K=18", 18, ((1 << 17) | 0o12345, (1 << 17) | 0o7651))
    with pytest.raises(NotImplementedError, match="S <= 65536"):
        StreamingDecoder(k18, "SOFT8", window=64, chunk=16, device="cuda")
    assert StreamingDecoder(k18, "SOFT8", window=64,
                            chunk=16, device="cpu").backend == "torch"
    for name, route in (("Basic K=3 R=1/2", "lane"), ("Voyager", "rotated"),
                        ("Cassini", "plane")):
        assert StreamingDecoder(pt.get_code(name), "SOFT8", window=64,
                                chunk=16, device="cuda").backend == route


def test_noisy_stream_equals_the_exact_decode():
    """An AWGN stream (utils/testsig.py, fixed seed) at a generous window
    commits the exact decode's bits, except at the frame's end: the exact
    decode ends in state 0 (the tail), the stream from its best state."""
    code = pt.get_code("Voyager")
    B, N, window, chunk, end = 4, 256, 96, 32, 48
    T = N + code.K - 1
    cfg = pt.get_decode_config(pt.DecodeType.SOFT16, code.R)
    gen = torch.Generator().manual_seed(12)
    data = torch.randint(0, 2, (B, N), generator=gen, dtype=torch.uint8)
    syms = testsig.awgn_quantize(testsig.modulate_encode(code, data), gen,
                                 2.0, code.R, cfg)
    exact, _, _ = pt.ViterbiDecoder(code, cfg, device="cpu").decode(
        syms.reshape(B, -1), N)
    assert int(testsig.count_bit_errors(exact, data)) > 0, "not noisy"
    n_push = -(-(T + window + chunk) // chunk)
    stream = torch.zeros((B, n_push * chunk, code.R), dtype=torch.int32)
    stream[:, :T] = syms
    stream = stream.reshape(B, -1)
    sd = StreamingDecoder(code, cfg, window=window, chunk=chunk, device="cpu")
    st, out = sd.reset(B), []
    step = chunk * code.R
    for i in range(n_push):
        st, bits, valid = sd.push(st, stream[:, i * step:(i + 1) * step])
        if valid:
            out.append(bits)
    got = torch.cat(out, dim=1)[:, code.K - 1:code.K - 1 + N]
    assert torch.equal(got[:, :N - end], exact[:, :N - end])


def test_clean_stream_equals_the_data():
    code = pt.get_code("Basic K=5 R=1/2")
    B, N, window, chunk = 2, 96, 64, 16
    rng = np.random.RandomState(1)
    data = torch.as_tensor(rng.randint(0, 2, (B, N)).astype(np.uint8))
    syms = encoder.encode_symbols(code, data, 127, -127)
    T = syms.shape[1]
    n_push = -(-(T + window + chunk) // chunk)
    stream = torch.zeros((B, n_push * chunk, code.R), dtype=torch.int32)
    stream[:, :T] = syms
    stream = stream.reshape(B, -1)
    sd = StreamingDecoder(code, "SOFT16", window=window, chunk=chunk,
                          device="cpu")
    st, out = sd.reset(B), []
    step = chunk * code.R
    for i in range(n_push):
        st, bits, valid = sd.push(st, stream[:, i * step:(i + 1) * step])
        if valid:
            out.append(bits)
    got = torch.cat(out, dim=1)[:, code.K - 1:code.K - 1 + N]
    assert torch.equal(got, data)
