"""The port's ViterbiDecoder end to end against the JAX package's.

On the CPU the port runs the plain versions of its kernels; the JAX side
runs ViterbiDecoder(backend="pallas") (the rotated Pallas kernel and the
slot-order walk, interpret mode off-TPU) and backend="xla".  Everything
is integer, so every comparison is exact: decoded bits, final metrics,
renorm accumulators, slot-order decision rows and row_rots.  Checkpoints
cross between the packages mid-stream in both directions.
"""

import inspect

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import viterbidecodercpp_torch as pt
import viterbidecodercpp_tpu as vt
from viterbidecodercpp_torch.ops import encoder
from viterbidecodercpp_tpu.ops import encoder as jax_encoder

ROTATED = [("Voyager", "SOFT8"), ("LTE", "SOFT16"), ("DAB Radio", "HARD8"),
           ("CDMA IS-95A", "SOFT8"), ("CDMA 2000", "SOFT16")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _syms(code, mode, B, T, seed, spread=2):
    """Random soft symbols, some past the soft range (the decoder
    clamps them)."""
    cfg = pt.get_decode_config(pt.DecodeType(mode), code.R)
    rng = np.random.RandomState(seed)
    return rng.randint(cfg.soft_decision_low - spread,
                       cfg.soft_decision_high + spread + 1,
                       (B, T * code.R)).astype(np.int32)


def _eq(got, want):
    if isinstance(got, torch.Tensor):
        got = got.cpu().numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


def _jax_state_from_port(state):
    return vt.DecoderState(**{k: jnp.asarray(v)
                              for k, v in state.to_numpy().items()})


def _port_state_from_jax(state):
    fields = ("metrics", "decisions", "accumulated_error", "bit_cursor",
              "row_rots")
    return pt.DecoderState.from_numpy(
        {f: np.asarray(getattr(state, f)) for f in fields
         if getattr(state, f) is not None}, device="cpu")


@pytest.mark.parametrize("name,mode", ROTATED)
def test_decode_matches_jax_pallas_and_xla(name, mode):
    code = pt.get_code(name)
    dec = pt.ViterbiDecoder(code, mode, device="cpu")
    assert dec.backend == "rotated"
    jp = vt.ViterbiDecoder(vt.get_code(name), mode, backend="pallas")
    jx = vt.ViterbiDecoder(vt.get_code(name), mode, backend="xla")
    assert jp._rotated
    B, T = 2, 3 * (code.K - 1) + 5
    syms = _syms(code, mode, B, T, seed=len(name))
    total_bits = T - (code.K - 1)
    bits, err, acc = dec.decode(syms, total_bits)
    assert bits.dtype == torch.uint8 and bits.shape == (B, total_bits)
    for jdec in (jp, jx):
        jb, je, ja = jdec.decode(syms, total_bits)
        _eq(bits, jb)
        _eq(err, je)
        _eq(acc, ja)


@pytest.mark.parametrize("name,cuts", [("CDMA IS-95A", (13, 21, 50)),
                                       ("Voyager", (5, 6, 33, 50))])
def test_ragged_updates_match_jax_rows_and_rots(name, cuts):
    """Chunk boundaries off the n-multiple grid: each chunk restarts the
    rotation schedule, row_rots records (i+1) mod n per chunk row, and
    the slot-order rows are the JAX kernel's, word for word."""
    code = pt.get_code(name)
    dec = pt.ViterbiDecoder(code, "SOFT8", traceback_length=50, device="cpu")
    jdec = vt.ViterbiDecoder(vt.get_code(name), "SOFT8", backend="pallas",
                             traceback_length=50)
    B, T = 2, 50
    syms = _syms(code, "SOFT8", B, T, seed=3)
    s, js = dec.reset(B), jdec.reset(B)
    lo, R = 0, code.R
    for hi in cuts:
        s = dec.update(s, syms[:, lo * R:hi * R])
        js = jdec.update(js, syms[:, lo * R:hi * R])
        lo = hi
    for f in ("metrics", "decisions", "accumulated_error", "bit_cursor",
              "row_rots"):
        _eq(getattr(s, f), getattr(js, f))
    total_bits = T - (code.K - 1)
    _eq(dec.chainback(s, total_bits), jdec.chainback(js, total_bits))
    for end in (0, 7, code.num_states + 3):        # get_error's % S wrap
        _eq(dec.get_error(s, end), jdec.get_error(js, end))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages_via_npz(tmp_path, direction):
    name, mode = "CDMA 2000", "SOFT8"
    code = pt.get_code(name)
    dec = pt.ViterbiDecoder(code, mode, traceback_length=40, device="cpu")
    jdec = vt.ViterbiDecoder(vt.get_code(name), mode, backend="pallas",
                             traceback_length=40)
    B, T1, T = 2, 17, 40
    syms = _syms(code, mode, B, T, seed=5)
    R, total_bits = code.R, T - (code.K - 1)
    f = tmp_path / "state.npz"
    if direction == "jax_to_port":
        jdec.update(jdec.reset(B), syms[:, :T1 * R]).save(f)
        s = dec.update(pt.DecoderState.load(f, device="cpu"), syms[:, T1 * R:])
        bits = dec.chainback(s, total_bits)
    else:
        dec.update(dec.reset(B), syms[:, :T1 * R]).save(f)
        with np.load(f) as z:
            assert sorted(z.files) == sorted(
                ["metrics", "decisions", "accumulated_error", "bit_cursor",
                 "row_rots"])
        js = jdec.update(vt.DecoderState.load(f), syms[:, T1 * R:])
        bits = jdec.chainback(js, total_bits)
    want, _, _ = vt.ViterbiDecoder(vt.get_code(name), mode,
                                   backend="xla").decode(syms, total_bits)
    _eq(bits, want)


def test_checkpoint_crosses_packages_via_numpy_dicts():
    name, mode = "LTE", "HARD8"
    code = pt.get_code(name)
    dec = pt.ViterbiDecoder(code, mode, traceback_length=45, device="cpu")
    jdec = vt.ViterbiDecoder(vt.get_code(name), mode, backend="pallas",
                             traceback_length=45)
    B, T = 2, 45
    syms = _syms(code, mode, B, T, seed=8)
    R, total_bits = code.R, T - (code.K - 1)
    # JAX -> port -> JAX -> port, one ragged chunk in each
    js = jdec.update(jdec.reset(B), syms[:, :11 * R])
    s = dec.update(_port_state_from_jax(js), syms[:, 11 * R:23 * R])
    js = jdec.update(_jax_state_from_port(s), syms[:, 23 * R:30 * R])
    s = dec.update(_port_state_from_jax(js), syms[:, 30 * R:])
    one = dec.decode(syms, total_bits)
    _eq(dec.chainback(s, total_bits), one[0])
    _eq(dec.get_error(s), one[1])
    _eq(s.accumulated_error, one[2])
    back = pt.DecoderState.from_numpy(s.to_numpy(), device="cpu")
    for f in ("metrics", "decisions", "accumulated_error", "bit_cursor",
              "row_rots"):
        assert torch.equal(getattr(back, f), getattr(s, f))


def test_capacity_and_argument_errors():
    code = pt.get_code("Voyager")
    dec = pt.ViterbiDecoder(code, "SOFT8", traceback_length=10, device="cpu")
    s = dec.reset(1)
    s = dec.update(s, np.zeros((1, 12 * code.R), np.int32))
    with pytest.raises(ValueError, match="overflow"):
        dec.update(s, np.zeros((1, 5 * code.R), np.int32))
    with pytest.raises(ValueError, match="multiple of R"):
        dec.update(s, np.zeros((1, 3), np.int32))
    with pytest.raises(ValueError, match="traceback_length"):
        dec.chainback(s, 11)
    with pytest.raises(ValueError, match="truncated"):
        dec.chainback(s, 4, mode="truncated")
    with pytest.raises(ValueError, match="unknown chainback mode"):
        dec.chainback(s, 4, mode="fast")
    # a loaded state has no host cursor: the capacity check reads it
    loaded = pt.DecoderState.from_numpy(s.to_numpy(), device="cpu")
    assert loaded.host_cursor is None
    with pytest.raises(ValueError, match="overflow"):
        dec.update(loaded, np.zeros((1, 5 * code.R), np.int32))
    with pytest.raises(ValueError, match="unknown backend"):
        pt.ViterbiDecoder(code, "SOFT8", backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="rotated backend"):
        pt.ViterbiDecoder(pt.get_code("Basic K=5 R=1/2"), "SOFT8",
                          backend="rotated", device="cpu")


def test_entry_points_default_to_the_card():
    """The decoder, the stream and a loaded state run on the card unless
    the caller names the CPU.  Construction allocates nothing, so no card
    is touched; without one, the first allocation raises (no fallback)."""
    code = pt.get_code("Voyager")
    dec = pt.ViterbiDecoder(code, "SOFT8")
    assert dec.device == torch.device("cuda")
    sd = pt.StreamingDecoder(code, "SOFT8", window=64, chunk=16)
    assert sd.device == torch.device("cuda")
    for fn in (pt.ViterbiDecoder.__init__, pt.StreamingDecoder.__init__,
               pt.DecoderState.from_numpy, pt.DecoderState.load):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            dec.reset(2)
        with pytest.raises((RuntimeError, AssertionError)):
            sd.reset(2)
        with pytest.raises((RuntimeError, AssertionError)):
            pt.DecoderState.from_numpy(
                pt.ViterbiDecoder(code, "SOFT8", traceback_length=4,
                                  device="cpu").reset(2).to_numpy())


def test_cuda_device_outside_the_class_raises_not_implemented():
    """No CUDA kernel for S > 65536 (a frame's metrics exceed the shared
    memory of a cluster of two blocks): the decoder refuses at
    construction instead of running a plain version on the card, which
    stays for the CPU.  S < 64 takes the lane kernel and Cassini
    (S = 16384) the plane kernels.  No card is touched."""
    assert pt.ViterbiDecoder(pt.get_code("Basic K=3 R=1/2"), "SOFT8",
                             device="cuda").backend == "lane"
    k18 = pt.CodeSpec("K=18", 18, ((1 << 17) | 0o12345, (1 << 17) | 0o7651))
    with pytest.raises(NotImplementedError, match="S <= 65536"):
        pt.ViterbiDecoder(k18, "SOFT8", device="cuda")
    assert pt.ViterbiDecoder(k18, "SOFT8", device="cpu").backend == "torch"
    assert pt.ViterbiDecoder(pt.get_code("Cassini"), "SOFT8",
                             device="cuda").backend == "plane"
    assert pt.ViterbiDecoder(pt.get_code("Voyager"), "SOFT8",
                             device="cuda").backend == "rotated"


@pytest.mark.parametrize("K,route", [(5, "lane"), (7, "rotated"),
                                     (15, "plane")])
def test_rate_above_16_is_refused_on_cuda_at_construction(K, route):
    """The kernels take R <= 16: on a CUDA device a rate-1/17 code is
    refused when the decoder or the stream is built, naming
    backend="torch", for "auto" and for its named kernel backend; the
    CPU and backend="torch" construct.  No card is touched."""
    rng = np.random.RandomState(K)
    code = pt.CodeSpec(f"K={K} R=1/17", K, tuple(
        int(rng.randint(0, 1 << K)) | 1 | (1 << (K - 1)) for _ in range(17)))
    for backend in ("auto", route):
        with pytest.raises(NotImplementedError, match='backend="torch"'):
            pt.ViterbiDecoder(code, "SOFT8", backend=backend, device="cuda")
        with pytest.raises(NotImplementedError, match='backend="torch"'):
            pt.StreamingDecoder(code, "SOFT8", window=64, chunk=16,
                                backend=backend, device="cuda")
    assert pt.ViterbiDecoder(code, "SOFT8", device="cpu").backend == route
    assert pt.StreamingDecoder(code, "SOFT8", window=64, chunk=16,
                               device="cpu").backend == route
    assert pt.ViterbiDecoder(code, "SOFT8", backend="torch",
                             device="cuda").backend == "torch"


@pytest.mark.parametrize("name,mode", [("Basic K=5 R=1/2", "SOFT16"),
                                       ("Basic K=3 R=1/2", "HARD8")])
def test_small_codes_use_the_plain_scan_on_the_cpu(name, mode):
    """S < 64 takes the lane backend, whose kernel's plain version (the
    state-order scan) serves CPU tensors."""
    code = pt.get_code(name)
    dec = pt.ViterbiDecoder(code, mode, device="cpu")
    assert dec.backend == "lane"
    B, T = 2, 30
    syms = _syms(code, mode, B, T, seed=1)
    total_bits = T - (code.K - 1)
    got = dec.decode(syms, total_bits)
    want = vt.ViterbiDecoder(vt.get_code(name), mode,
                             backend="xla").decode(syms, total_bits)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("name", ["Voyager", "CDMA 2000"])
def test_noisy_frames_decode_exactly(name):
    """The product working: encode with the port's encoder (checked
    against the JAX encoder), add mild noise, decode exactly."""
    code = pt.get_code(name)
    rng = np.random.RandomState(21)
    B, nbytes = 3, 16
    data = rng.randint(0, 256, (B, nbytes)).astype(np.uint8)
    bits = encoder.bytes_to_bits(torch.as_tensor(data))
    syms = encoder.encode_symbols(code, bits, 127, -127)
    jbits = jax_encoder.bytes_to_bits_jax(jnp.asarray(data))
    _eq(syms, jax_encoder.encode_symbols_jax(vt.get_code(name), jbits,
                                              127, -127, True))
    _eq(encoder.bits_to_bytes(bits), data)
    noisy = np.clip(syms.numpy() + rng.randint(-60, 61, syms.shape),
                    -127, 127).reshape(B, -1)
    dec = pt.ViterbiDecoder(code, "SOFT16", device="cpu")
    out, _, _ = dec.decode(noisy, nbytes * 8)
    _eq(encoder.bits_to_bytes(out), data)
    s = dec.update(dec.reset(B), noisy)
    _eq(dec.chainback_bytes(s, nbytes * 8), data)


def test_decode_grows_traceback_length_stickily():
    code = pt.get_code("Voyager")
    dec = pt.ViterbiDecoder(code, "SOFT8", traceback_length=4, device="cpu")
    syms = _syms(code, "SOFT8", 1, 26, seed=2)
    dec.decode(syms, 20)
    assert dec.traceback_length == 20
    assert dec.decision_rows == 20 + code.K - 1
    dec.decode(syms[:, :16 * code.R], 10)
    assert dec.traceback_length == 20
    assert dec.reset(1).decisions.shape == (26, 2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name,mode", [("Voyager", "SOFT8"),
                                       ("CDMA IS-95A", "HARD8")])
def test_cuda_decode_matches_cpu(cuda_device, name, mode):
    code = pt.get_code(name)
    B, T = 64, 200
    syms = _syms(code, mode, B, T, seed=4)
    total_bits = T - (code.K - 1)
    cpu = pt.ViterbiDecoder(code, mode, device="cpu").decode(syms, total_bits)
    gpu = pt.ViterbiDecoder(code, mode, device=cuda_device).decode(
        torch.as_tensor(syms, device=cuda_device), total_bits)
    for g, c in zip(gpu, cpu):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), c)
