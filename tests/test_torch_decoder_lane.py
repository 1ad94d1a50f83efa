"""The port's ViterbiDecoder on the lane class (S <= 32) against the JAX
package's ViterbiDecoder(backend="pallas"), whose lane kernel runs in
interpret mode here.

Both keep state-order decision rows (rows, W, B) with no row_rots, so the
carries are compared field for field and checkpoints cross between the
packages mid-stream in both directions; ``update`` writes its rows into
the carry's buffer in place.  Everything is integer: every comparison is
exact.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import viterbidecodercpp_torch as pt
import viterbidecodercpp_tpu as vt
from viterbidecodercpp_torch.ops import encoder

FIELDS = ("metrics", "decisions", "accumulated_error", "bit_cursor")


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


def _decoders(name, mode, **kw):
    dec = pt.ViterbiDecoder(pt.get_code(name), mode, **kw, device="cpu")
    jdec = vt.ViterbiDecoder(vt.get_code(name), mode, backend="pallas", **kw)
    assert dec.backend == "lane"
    assert not (jdec._rotated or jdec._plane)
    return dec, jdec


@pytest.mark.parametrize("name,mode", [("Basic K=3 R=1/2", "SOFT16"),
                                       ("Basic K=5 R=1/2", "SOFT8"),
                                       ("Basic K=5 R=1/2", "HARD8")])
def test_decode_matches_jax_pallas(name, mode):
    dec, jdec = _decoders(name, mode)
    code = dec.code
    B, T = 3, 37
    syms = _syms(code, mode, B, T, seed=len(mode))
    total_bits = T - (code.K - 1)
    got = dec.decode(syms, total_bits)
    want = jdec.decode(syms, total_bits)
    assert got[0].dtype == torch.uint8 and got[0].shape == (B, total_bits)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("name,cuts", [("Basic K=3 R=1/2", (5, 6, 23, 40)),
                                       ("Basic K=5 R=1/2", (13, 21, 40))])
def test_ragged_updates_match_jax_rows(name, cuts):
    dec, jdec = _decoders(name, "SOFT16", traceback_length=40)
    code = dec.code
    B, T = 2, 40
    syms = _syms(code, "SOFT16", B, T, seed=3)
    s, js = dec.reset(B), jdec.reset(B)
    lo, R = 0, code.R
    for hi in cuts:
        s = dec.update(s, syms[:, lo * R:hi * R])
        js = jdec.update(js, syms[:, lo * R:hi * R])
        lo = hi
    assert s.row_rots is None and js.row_rots is None
    for f in FIELDS:
        _eq(getattr(s, f), getattr(js, f))
    total_bits = T - (code.K - 1)
    _eq(dec.chainback(s, total_bits), jdec.chainback(js, total_bits))
    for end in (0, 3, code.num_states + 1):        # get_error's % S wrap
        _eq(dec.get_error(s, end), jdec.get_error(js, end))
        _eq(dec.chainback(s, total_bits, end), jdec.chainback(js, total_bits,
                                                              end))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages_via_npz(tmp_path, direction):
    name, mode = "Basic K=5 R=1/2", "SOFT8"
    dec, jdec = _decoders(name, mode, traceback_length=36)
    code = dec.code
    B, T1, T = 2, 15, 40
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
            assert sorted(z.files) == sorted(FIELDS)
        js = jdec.update(vt.DecoderState.load(f), syms[:, T1 * R:])
        bits = jdec.chainback(js, total_bits)
    want, _, _ = vt.ViterbiDecoder(vt.get_code(name), mode,
                                   backend="xla").decode(syms, total_bits)
    _eq(bits, want)


def test_torch_backend_stays_selectable_and_agrees():
    name, mode = "Basic K=3 R=1/2", "HARD8"
    code = pt.get_code(name)
    B, T = 2, 30
    syms = _syms(code, mode, B, T, seed=9)
    plain = pt.ViterbiDecoder(code, mode, backend="torch", device="cpu")
    assert plain.backend == "torch"
    got = pt.ViterbiDecoder(code, mode, device="cpu").decode(syms, T - 2)
    for g, w in zip(got, plain.decode(syms, T - 2)):
        assert torch.equal(g, w)


def test_backend_is_lane_on_cpu_and_cuda():
    """No card is touched: routing happens at construction."""
    for name in ("Basic K=3 R=1/2", "Basic K=5 R=1/2"):
        code = pt.get_code(name)
        assert pt.ViterbiDecoder(code, "SOFT8", device="cpu").backend == "lane"
        assert pt.ViterbiDecoder(code, "SOFT8",
                                 device="cuda").backend == "lane"
    k2 = pt.CodeSpec("K=2", 2, (3, 3))
    assert pt.ViterbiDecoder(k2, "SOFT16", device="cuda").backend == "lane"
    k6 = pt.CodeSpec("K=6", 6, (0o45, 0o73))
    assert pt.ViterbiDecoder(k6, "SOFT16", device="cuda").backend == "lane"
    with pytest.raises(ValueError, match="lane backend"):
        pt.ViterbiDecoder(pt.get_code("Voyager"), "SOFT8", backend="lane",
                          device="cpu")


def test_noisy_frames_decode_exactly():
    code = pt.get_code("Basic K=5 R=1/2")
    rng = np.random.RandomState(4)
    B, N = 3, 64
    data = rng.randint(0, 2, (B, N)).astype(np.uint8)
    clean = encoder.encode_symbols(code, torch.as_tensor(data), 127, -127)
    noisy = np.clip(clean.numpy() + rng.randint(-60, 61, clean.shape),
                    -127, 127).reshape(B, -1)
    dec = pt.ViterbiDecoder(code, "SOFT16", device="cpu")
    _eq(dec.decode(noisy, N)[0], data)
    jbits, _, _ = vt.ViterbiDecoder(vt.get_code(code.name), "SOFT16",
                                    backend="pallas").decode(
                                        jnp.asarray(noisy), N)
    _eq(jbits, data)


@pytest.mark.parametrize("name,mode,cuts", [
    ("Basic K=3 R=1/2", "SOFT8", (1, 9, 33, 42)),
    ("Basic K=5 R=1/2", "HARD8", (31, 32, 44)),
])
def test_update_writes_rows_in_place(name, mode, cuts):
    """The lane route's ACS writes each chunk's rows straight into
    ``state.decisions`` (``out``): the buffer keeps its storage,
    the reset carry sees every row, and the rows match the JAX decoder's
    over ragged cuts."""
    dec, jdec = _decoders(name, mode, traceback_length=40)
    code = dec.code
    B, T = 3, cuts[-1]
    syms = _syms(code, mode, B, T, seed=len(cuts))
    s0 = dec.reset(B)
    ptr = s0.decisions.data_ptr()
    s, js = s0, jdec.reset(B)
    lo, R = 0, code.R
    for hi in cuts:
        s = dec.update(s, syms[:, lo * R:hi * R])
        js = jdec.update(js, syms[:, lo * R:hi * R])
        assert s.decisions.data_ptr() == ptr
        _eq(s.decisions[:hi], np.asarray(js.decisions)[:hi])
        lo = hi
    for f in FIELDS:
        _eq(getattr(s, f), getattr(js, f))
    _eq(s0.decisions, js.decisions)
