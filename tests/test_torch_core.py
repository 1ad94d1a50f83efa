"""The port's plain state-order scan (ops/torch_core.py) against
jax_core.acs_scan / chainback_scan and the NumPy oracle.

Bit-exact on every output - final metrics, packed ViterbiDecisionBits
rows and renorm accumulators - across the registry codes, random
polynomials, both arithmetic modes and out-of-range symbols (the scan
itself does not clamp; the decoder does).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import viterbidecodercpp_torch as pt
import viterbidecodercpp_tpu as vt
from viterbidecodercpp_torch.ops import torch_core
from viterbidecodercpp_tpu.ops import jax_core, numpy_ref

MODES = ["SOFT16", "SOFT8", "HARD8"]


def _spec_pair(jcode, mode, arith):
    tcode = pt.CodeSpec(jcode.name, jcode.K, jcode.G)
    jcfg = vt.get_decode_config(vt.DecodeType(mode), jcode.R, arith=arith)
    tcfg = pt.get_decode_config(pt.DecodeType(mode), tcode.R, arith=arith)
    return (jax_core.make_static_spec(jcode, jcfg),
            torch_core.make_static_spec(tcode, tcfg))


def _check_scan(js, ts, B, T, seed, spread=0):
    """Random symbols `spread` past the soft range on both sides."""
    rng = np.random.RandomState(seed)
    syms = rng.randint(js.soft_low - spread, js.soft_high + spread + 1,
                       (B, T, js.R)).astype(np.int32)
    m0 = np.array(jax_core.initial_metrics(js, B, seed))
    jm, jp, ja = jax_core.acs_scan(js, jnp.asarray(m0), jnp.asarray(syms))
    tm, tp, ta = torch_core.acs_scan(ts, torch.as_tensor(m0),
                                     torch.as_tensor(syms))
    for got, want in ((tm, jm), (tp, jp), (ta, ja)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    total_bits = T - (js.K - 1)
    for end in (0, seed % js.S):
        ends = np.full(B, end, np.int32)
        jb = jax_core.chainback_scan(js, jp, jnp.asarray(ends), total_bits)
        tb = torch_core.chainback_scan(ts, tp, torch.as_tensor(ends),
                                       total_bits)
        assert tb.dtype == torch.uint8
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("arith", ["saturating", "wrapping"])
@pytest.mark.parametrize("name", [c.name for c in vt.COMMON_CODES
                                  if c.K < 15])
def test_registry_codes_match_jax_core(name, arith):
    jcode = vt.get_code(name)
    for i, mode in enumerate(MODES):
        js, ts = _spec_pair(jcode, mode, arith)
        _check_scan(js, ts, B=3, T=2 * jcode.K + 9, seed=i,
                    spread=3 if mode != "SOFT16" else 40)


@pytest.mark.parametrize("arith", ["saturating", "wrapping"])
def test_cassini_short_scan_matches_jax_core(arith):
    js, ts = _spec_pair(vt.get_code("Cassini"), "SOFT8", arith)
    _check_scan(js, ts, B=1, T=17, seed=4, spread=2)


@pytest.mark.parametrize("K,R,seed", [(8, 3, 2), (10, 2, 4), (5, 5, 3)])
def test_random_codes_match_jax_core(K, R, seed):
    """Random valid polynomials (the tests/test_random_codes.py pattern)."""
    rng = np.random.RandomState(seed)
    G = tuple(int(rng.randint(0, 1 << K)) | 1 | (1 << (K - 1))
              for _ in range(R))
    jcode = vt.CodeSpec(f"rand K={K} R=1/{R}", K, G)
    for mode, arith in (("SOFT16", "saturating"), ("HARD8", "wrapping")):
        js, ts = _spec_pair(jcode, mode, arith)
        _check_scan(js, ts, B=2, T=3 * K, seed=seed, spread=5)


def test_scan_matches_numpy_oracle():
    code = vt.get_code("CDMA IS-95A")
    config = vt.get_decode_config(vt.DecodeType.SOFT8, code.R)
    _, ts = _spec_pair(code, "SOFT8", "saturating")
    rng = np.random.RandomState(7)
    syms = rng.randint(-3, 4, (2, 30 * code.R)).astype(np.int64)
    m0 = torch_core.initial_metrics(ts, 2)
    tm, tp, ta = torch_core.acs_scan(
        ts, m0, torch.as_tensor(syms.reshape(2, 30, code.R)))
    for f in range(2):
        om, od, oa = numpy_ref.acs_run(code, config, syms[f])
        np.testing.assert_array_equal(tm[:, f].numpy(), om)
        assert int(ta[f]) == oa
        bits = numpy_ref.traceback(code, od, 30 - (code.K - 1))
        np.testing.assert_array_equal(
            torch_core.chainback_scan(
                ts, tp, torch.zeros(2, dtype=torch.int32),
                30 - (code.K - 1))[f].numpy(), bits)


def test_pack_decisions_sign_bit_and_order():
    """Bit 31 of a word is the int32 sign bit; state s sits at bit s%32
    of word s//32 (the torch sum promotes to int64, the wrap folds it
    back)."""
    _, ts = _spec_pair(vt.get_code("Voyager"), "SOFT8", "saturating")
    ones = torch.ones((ts.H, 2), dtype=torch.int32)
    words = torch_core.pack_decisions(ts, ones, ones)
    assert words.dtype == torch.int32
    assert (words == -1).all()
    dec0 = torch.zeros((ts.H, 1), dtype=torch.int32)
    dec1 = torch.zeros((ts.H, 1), dtype=torch.int32)
    dec1[15] = 1                       # state 31 -> bit 31 of word 0
    dec0[16] = 1                       # state 32 -> bit 0 of word 1
    words = torch_core.pack_decisions(ts, dec0, dec1)
    assert words[:, 0].tolist() == [-(1 << 31), 1]
    jw = jax_core.pack_decisions(jax_core.make_static_spec(
        vt.get_code("Voyager"), vt.get_decode_config(vt.DecodeType.SOFT8, 2)),
        jnp.asarray(dec0.numpy()), jnp.asarray(dec1.numpy()))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))


def test_short_history_raises():
    _, ts = _spec_pair(vt.get_code("Voyager"), "SOFT8", "saturating")
    packed = torch.zeros((10, ts.W, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="shorter"):
        torch_core.chainback_scan(ts, packed, torch.zeros(1, dtype=torch.int32),
                                  5)


def test_spec_cache_keys_on_the_spec_object_and_args():
    """spec_cache computes once per spec object and argument tuple: an
    equal spec made anew is computed again (no field-by-field compare of
    its branch table), the same object is not, and each entry keeps its
    spec alive."""
    calls = []

    @torch_core.spec_cache
    def tag(spec, *args):
        calls.append(args)
        return (spec.K, args, len(calls))

    cfg = pt.get_decode_config(pt.DecodeType.SOFT8, 2)
    a = torch_core.make_static_spec(pt.get_code("Voyager"), cfg)
    b = torch_core.make_static_spec(pt.get_code("Voyager"), cfg)
    assert a == b and a is not b
    assert tag(a) == (7, (), 1) and tag(a) == (7, (), 1)
    assert tag(b) == (7, (), 2)
    assert tag(a, "cpu") == (7, ("cpu",), 3) and tag(a, "cpu")[2] == 3
    assert calls == [(), (), ("cpu",)]
    assert torch_core.symmetric_amplitude(a) == \
        torch_core.symmetric_amplitude(b)
