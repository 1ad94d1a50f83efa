"""The port's ViterbiDecoder on the plane backend (Cassini, K=15) against
the JAX package's.

On the CPU the port runs the plain versions of the plane kernels; the
JAX side runs ViterbiDecoder(backend="pallas") (the plane Pallas kernels,
interpret mode off-TPU) and backend="xla".  Exact equality everywhere:
decoded bits, final metrics, renorm accumulators, the (B, rows, W/128,
128) decision buffer up to the cursor, and row_rots.  Checkpoints cross
between the packages mid-stream in both directions, including one
written before row_rots existed; mode="truncated" equals the JAX
truncated walk on the same buffer and the exact walk on a noisy encoded
frame.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import viterbidecodercpp_torch as pt
import viterbidecodercpp_tpu as vt
from viterbidecodercpp_torch.ops import encoder, plane

NAME = "Cassini"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _syms(code, mode, B, T, seed, spread=2):
    cfg = pt.get_decode_config(pt.DecodeType(mode), code.R)
    rng = np.random.RandomState(seed)
    return rng.randint(cfg.soft_decision_low - spread,
                       cfg.soft_decision_high + spread + 1,
                       (B, T * code.R)).astype(np.int32)


def _eq(got, want):
    if isinstance(got, torch.Tensor):
        got = got.cpu().numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


def _decoders(mode="SOFT16", traceback_length=0, **cfg):
    code = pt.get_code(NAME)
    tcfg = pt.get_decode_config(pt.DecodeType(mode), code.R, **cfg)
    jcfg = vt.get_decode_config(vt.DecodeType(mode), code.R, **cfg)
    dec = pt.ViterbiDecoder(code, tcfg, traceback_length=traceback_length,
                            device="cpu")
    jdec = vt.ViterbiDecoder(vt.get_code(NAME), jcfg, backend="pallas",
                             traceback_length=traceback_length)
    assert dec.backend == "plane" and jdec._plane
    return code, dec, jdec


@pytest.mark.parametrize("mode,arith", [("SOFT16", "saturating"),
                                        ("HARD8", "wrapping")])
def test_decode_matches_jax_pallas_and_xla(mode, arith):
    code, dec, jdec = _decoders(mode, arith=arith)
    jx = vt.ViterbiDecoder(vt.get_code(NAME), jdec.config, backend="xla")
    B, T = 2, 31
    syms = _syms(code, mode, B, T, seed=len(mode))
    total_bits = T - (code.K - 1)
    bits, err, acc = dec.decode(syms, total_bits, end_state=5)
    assert bits.dtype == torch.uint8 and bits.shape == (B, total_bits)
    for j in (jdec, jx):
        jb, je, ja = j.decode(syms, total_bits, end_state=5)
        _eq(bits, jb)
        _eq(err, je)
        _eq(acc, ja)


def test_ragged_updates_match_jax_rows_and_rots():
    """Chunks of 9, 14 and 15 steps: each restarts the rotation schedule;
    the buffer rows up to the cursor, row_rots, metrics and acc equal
    the JAX decoder's, and so do the exact and truncated chainbacks."""
    code, dec, jdec = _decoders("SOFT8", traceback_length=24)
    B, T, R = 2, 38, code.R
    syms = _syms(code, "SOFT8", B, T, seed=3)
    s, js = dec.reset(B), jdec.reset(B)
    assert tuple(s.decisions.shape) == tuple(js.decisions.shape) == \
        (B, 56, 4, 128)
    assert tuple(s.row_rots.shape) == tuple(js.row_rots.shape) == (56,)
    lo = 0
    for hi in (9, 23, 38):
        s = dec.update(s, syms[:, lo * R:hi * R])
        js = jdec.update(js, syms[:, lo * R:hi * R])
        lo = hi
    for f in ("metrics", "accumulated_error", "bit_cursor", "row_rots"):
        _eq(getattr(s, f), getattr(js, f))
    _eq(s.decisions[:, :T], np.asarray(js.decisions)[:, :T])
    _eq(dec.chainback(s, 24), jdec.chainback(js, 24))
    for blk, ov in ((16, 8), (8, 24)):
        _eq(dec.chainback(s, 24, mode="truncated", block=blk, overlap=ov),
            jdec.chainback(js, 24, mode="truncated", block=blk, overlap=ov))
    for end in (0, 7, code.num_states + 3):        # get_error's % S wrap
        _eq(dec.get_error(s, end), jdec.get_error(js, end))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages_via_npz(tmp_path, direction):
    code, dec, jdec = _decoders("HARD8", traceback_length=20)
    B, T1, T = 2, 11, 34
    syms = _syms(code, "HARD8", B, T, seed=5)
    R, total_bits = code.R, T - (code.K - 1)
    f = tmp_path / "state.npz"
    if direction == "jax_to_port":
        jdec.update(jdec.reset(B), syms[:, :T1 * R]).save(f)
        s = dec.update(pt.DecoderState.load(f, device="cpu"), syms[:, T1 * R:])
        assert s.decisions.shape == (B, 56, 4, 128)
        bits = dec.chainback(s, total_bits)
    else:
        dec.update(dec.reset(B), syms[:, :T1 * R]).save(f)
        with np.load(f) as z:
            assert sorted(z.files) == sorted(
                ["metrics", "decisions", "accumulated_error", "bit_cursor",
                 "row_rots"])
            assert z["decisions"].shape == (B, 56, 4, 128)
        js = jdec.update(vt.DecoderState.load(f), syms[:, T1 * R:])
        bits = jdec.chainback(js, total_bits)
    want, _, _ = vt.ViterbiDecoder(vt.get_code(NAME), "HARD8",
                                   backend="xla").decode(syms, total_bits)
    _eq(bits, want)


def test_checkpoint_without_row_rots():
    """A plane checkpoint written before row_rots existed: its rows follow
    the one-shot schedule (row + 1) mod n.  chainback walks that schedule
    when row_rots is None, and update synthesises it before recording
    its own chunk's rotations."""
    code, dec, _ = _decoders("SOFT16", traceback_length=24)
    B, T, R = 1, 38, code.R
    syms = _syms(code, "SOFT16", B, T, seed=9)
    want, _, _ = dec.decode(syms, 24)

    def strip(state):
        return pt.DecoderState(metrics=state.metrics,
                               decisions=state.decisions,
                               accumulated_error=state.accumulated_error,
                               bit_cursor=state.bit_cursor, row_rots=None)

    full = strip(dec.update(dec.reset(B), syms))
    _eq(dec.chainback(full, 24), want)
    # a cut at a multiple of n, where the old global rows equal a fresh
    # chunk's; the loaded state has no host cursor either
    old = strip(dec.update(dec.reset(B), syms[:, :14 * R]))
    old = pt.DecoderState.from_numpy(old.to_numpy(), device="cpu")
    assert old.row_rots is None and old.host_cursor is None
    s = dec.update(old, syms[:, 14 * R:])
    np.testing.assert_array_equal(
        s.row_rots.numpy()[:T],
        np.r_[np.arange(1, 15) % 14, np.arange(1, 25) % 14])
    _eq(dec.chainback(s, 24), want)


def test_truncated_equals_exact_on_a_noisy_frame():
    """Real encoded frames with mild noise: survivors merge within the
    overlap, so every tile's committed bits equal the exact walk's, and
    both recover the data; the JAX truncated walk on the same buffer
    agrees bit for bit."""
    code = pt.get_code(NAME)
    rng = np.random.RandomState(11)
    B, total_bits = 2, 288
    T = total_bits + code.K - 1
    dec = pt.ViterbiDecoder(code, "SOFT16", traceback_length=total_bits,
                            device="cpu")
    data = rng.randint(0, 2, (B, total_bits)).astype(np.uint8)
    clean = encoder.encode_symbols(code, torch.as_tensor(data), 100, -100)
    noisy = np.clip(clean.numpy().reshape(B, -1)
                    + rng.normal(0, 20, (B, T * code.R)), -127,
                    127).astype(np.int32)
    s = dec.reset(B)
    cut = 130 * code.R                 # chunked: row_rots reach the walk
    s = dec.update(s, noisy[:, :cut])
    s = dec.update(s, noisy[:, cut:])
    exact = dec.chainback(s, total_bits)
    _eq(exact, data)
    trunc = dec.chainback(s, total_bits, mode="truncated", block=64,
                          overlap=96)
    assert torch.equal(trunc, exact)
    assert torch.equal(dec.chainback(s, total_bits, mode="truncated"), exact)
    js = vt.DecoderState(**{k: jnp.asarray(v)
                            for k, v in s.to_numpy().items()})
    jdec = vt.ViterbiDecoder(vt.get_code(NAME), "SOFT16", backend="pallas",
                             traceback_length=total_bits)
    _eq(trunc, jdec.chainback(js, total_bits, mode="truncated", block=64,
                              overlap=96))


def test_capacity_and_argument_errors():
    code, dec, _ = _decoders("SOFT8", traceback_length=10)
    s = dec.reset(1)
    assert s.decisions.shape == (1, 28, 4, 128)   # 24 rows -> 2 x 14
    s = dec.update(s, np.zeros((1, 20 * code.R), np.int32))
    with pytest.raises(ValueError, match="overflow"):
        dec.update(s, np.zeros((1, 5 * code.R), np.int32))
    loaded = pt.DecoderState.from_numpy(s.to_numpy(), device="cpu")
    with pytest.raises(ValueError, match="overflow"):
        dec.update(loaded, np.zeros((1, 5 * code.R), np.int32))
    with pytest.raises(ValueError, match="traceback_length"):
        dec.chainback(s, 11, mode="truncated")
    with pytest.raises(ValueError, match="multiples of 8"):
        dec.chainback(s, 4, mode="truncated", block=12)
    with pytest.raises(ValueError, match="plane backend covers"):
        pt.ViterbiDecoder(pt.get_code("Voyager"), "SOFT8", backend="plane",
                          device="cpu")
    rotated = pt.ViterbiDecoder(pt.get_code("Voyager"), "SOFT8",
                                traceback_length=4, device="cpu")
    with pytest.raises(ValueError, match="truncated"):
        rotated.chainback(rotated.reset(1), 4, mode="truncated")


@pytest.mark.cuda
def test_cuda_decoder_matches_cpu(cuda_device):
    code = pt.get_code(NAME)
    B, T = 24, 160
    syms = _syms(code, "SOFT16", B, T, seed=4)
    total_bits = T - (code.K - 1)
    cpu = pt.ViterbiDecoder(code, "SOFT16", device="cpu")
    gpu = pt.ViterbiDecoder(code, "SOFT16", device=cuda_device)
    assert gpu.backend == "plane"
    for g, c in zip(gpu.decode(torch.as_tensor(syms, device=cuda_device),
                               total_bits), cpu.decode(syms, total_bits)):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), c)
    s = gpu.update(gpu.reset(B), torch.as_tensor(syms, device=cuda_device))
    c = cpu.update(cpu.reset(B), syms)
    assert torch.equal(s.decisions[:, :T].cpu(), c.decisions[:, :T])
    for blk, ov in ((64, 96), (512, 128)):
        assert torch.equal(
            gpu.chainback(s, total_bits, mode="truncated", block=blk,
                          overlap=ov).cpu(),
            cpu.chainback(c, total_bits, mode="truncated", block=blk,
                          overlap=ov))
    assert plane.LAUNCHES["plane_acs"] > 0
