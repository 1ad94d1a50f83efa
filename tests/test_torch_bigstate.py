"""Rotated-layout big-state scan of the port (ops/bigstate.py) against the
JAX package's XLA version (viterbidecodercpp_tpu/ops/bigstate.py).

Exact equality on the i-order decision rows, the state-order final
metrics, the renorm accumulators and the decoded bits, for Cassini in
the three regimes and both arithmetic modes, at T values that are not
multiples of n = K-1, plus a random K=14 code.  The port's
ViterbiDecoder(backend="torch") routes S > 4096 decodes through
decode_big, as the JAX xla backend does.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import viterbidecodercpp_torch as pt
import viterbidecodercpp_tpu as vt
from viterbidecodercpp_torch.ops import bigstate, torch_core
from viterbidecodercpp_tpu.ops import bigstate as jbig
from viterbidecodercpp_tpu.ops import jax_core


def _spec_pair(jcode, mode, arith="saturating"):
    tcode = pt.CodeSpec(jcode.name, jcode.K, jcode.G)
    jcfg = vt.get_decode_config(vt.DecodeType(mode), jcode.R, arith=arith)
    tcfg = pt.get_decode_config(pt.DecodeType(mode), tcode.R, arith=arith)
    return (jax_core.make_static_spec(jcode, jcfg),
            torch_core.make_static_spec(tcode, tcfg))


def _inputs(js, B, T, seed, spread=0):
    rng = np.random.RandomState(seed)
    syms = rng.randint(js.soft_low - spread, js.soft_high + spread + 1,
                       (B, T, js.R)).astype(np.int32)
    m0 = np.array(jax_core.initial_metrics(js, B, seed))
    return m0, syms


def _check(js, ts, B, T, seed):
    m0, syms = _inputs(js, B, T, seed)
    ends = np.arange(B, dtype=np.int32) * 5
    total_bits = T - (js.K - 1)
    want = jbig.decode_big(js, jnp.asarray(m0), jnp.asarray(syms),
                           jnp.asarray(ends), total_bits)
    got = bigstate.decode_big(ts, torch.as_tensor(m0), torch.as_tensor(syms),
                              torch.as_tensor(ends), total_bits)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.uint8
    assert got[1].dtype == got[2].dtype == got[3].dtype == torch.int32
    return got


@pytest.mark.parametrize("mode,arith", [("SOFT16", "saturating"),
                                        ("SOFT8", "saturating"),
                                        ("HARD8", "saturating"),
                                        ("SOFT16", "wrapping"),
                                        ("SOFT8", "wrapping")])
def test_cassini_matches_jax(mode, arith):
    js, ts = _spec_pair(vt.get_code("Cassini"), mode, arith)
    # 33 = 2n + 5 steps: a partial rotation period at the end
    _check(js, ts, B=2, T=33, seed=len(mode))


def test_random_k14_code_matches_jax():
    rng = np.random.RandomState(14)
    G = tuple(int(g) | 1 | (1 << 13) for g in rng.randint(0, 1 << 14, 2))
    js, ts = _spec_pair(vt.CodeSpec("rand K=14", 14, G), "SOFT8")
    _check(js, ts, B=2, T=19, seed=4)


def test_decoder_torch_backend_decodes_through_decode_big():
    """ViterbiDecoder(backend="torch") on Cassini: decode goes through
    decode_big (as the JAX xla backend's does) and equals both the JAX
    decoder and the port's own state-order reset/update/chainback."""
    code = pt.get_code("Cassini")
    dec = pt.ViterbiDecoder(code, "SOFT8", backend="torch", device="cpu")
    assert dec.backend == "torch"
    rng = np.random.RandomState(6)
    B, T = 2, 30
    syms = rng.randint(-5, 6, (B, T * code.R)).astype(np.int32)
    total_bits = T - (code.K - 1)
    got = dec.decode(syms, total_bits, end_state=3)
    want = vt.ViterbiDecoder(vt.get_code("Cassini"), "SOFT8",
                             backend="xla").decode(syms, total_bits,
                                                   end_state=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dec.set_traceback_length(total_bits)
    s = dec.update(dec.reset(B), syms)
    assert s.decisions.shape == (T, code.num_states // 32, B)
    np.testing.assert_array_equal(dec.chainback(s, total_bits, 3).numpy(),
                                  got[0].numpy())
    np.testing.assert_array_equal(dec.get_error(s, 3).numpy(),
                                  got[1].numpy())


def test_tables_and_short_history():
    js, ts = _spec_pair(vt.get_code("Cassini"), "HARD8")
    for (tj, tb), (jj, jb) in zip(bigstate._phase_tables(ts),
                                  jbig._phase_tables(js)):
        assert tj == jj
        np.testing.assert_array_equal(tb, jb)
    for t in (0, 5, 14, 29):
        np.testing.assert_array_equal(bigstate._unrotate_perm(ts, t),
                                      jbig._unrotate_perm(js, t))
    with pytest.raises(ValueError, match="shorter"):
        bigstate.chainback_rotated(ts, torch.zeros((10, ts.W, 1),
                                                   dtype=torch.int32),
                                   torch.zeros(1, dtype=torch.int32), 2)
