"""Rotated in-place ACS of the port (ops/rotated.py) against the JAX
package's Pallas kernel, rotated_pallas.acs_rotated(interpret=True).

Bit-exact on the state-order final metrics, the packed *slot-order*
decision rows and the renorm accumulators, for the five rotated-class
registry codes and random K=10/K=11 codes, in all three regimes and both
arithmetic modes, at T values that are not multiples of n = K-1.  The
K=13 R=1/6 spec, which the JAX package routes to its lane kernel, is held
against jax_core.acs_scan instead.  The kernel-vs-plain test needs a card
(marked ``cuda``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import viterbidecodercpp_torch as pt
from viterbidecodercpp_torch import trace
import viterbidecodercpp_tpu as vt
from viterbidecodercpp_torch.ops import chainback, rotated, torch_core
from viterbidecodercpp_tpu.ops import bigstate, jax_core, rotated_pallas

ROTATED_CODES = ["Voyager", "LTE", "DAB Radio", "CDMA IS-95A", "CDMA 2000"]
MODES = ["SOFT16", "SOFT8", "HARD8"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _spec_pair(jcode, mode, arith="saturating"):
    tcode = pt.CodeSpec(jcode.name, jcode.K, jcode.G)
    jcfg = vt.get_decode_config(vt.DecodeType(mode), jcode.R, arith=arith)
    tcfg = pt.get_decode_config(pt.DecodeType(mode), tcode.R, arith=arith)
    return (jax_core.make_static_spec(jcode, jcfg),
            torch_core.make_static_spec(tcode, tcfg))


def _random_code(K, R, seed):
    rng = np.random.RandomState(seed)
    G = tuple(int(rng.randint(0, 1 << K)) | 1 | (1 << (K - 1))
              for _ in range(R))
    return vt.CodeSpec(f"rand K={K} R=1/{R}", K, G)


def _inputs(js, B, T, seed, spread=0):
    rng = np.random.RandomState(seed)
    syms = rng.randint(js.soft_low - spread, js.soft_high + spread + 1,
                       (B, T, js.R)).astype(np.int32)
    m0 = np.array(jax_core.initial_metrics(js, B, seed))
    return m0, syms


def _check_vs_pallas(js, ts, B, T, seed, spread=0):
    m0, syms = _inputs(js, B, T, seed, spread)
    want = rotated_pallas.acs_rotated(js, jnp.asarray(m0), jnp.asarray(syms),
                                      interpret=True)
    got = rotated.acs_rotated(ts, torch.as_tensor(m0), torch.as_tensor(syms))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ROTATED_CODES)
def test_registry_codes_match_pallas(name, mode):
    js, ts = _spec_pair(vt.get_code(name), mode)
    n = js.K - 1
    _check_vs_pallas(js, ts, B=2, T=3 * n + 5, seed=MODES.index(mode))


@pytest.mark.parametrize("name,mode", [("Voyager", "SOFT8"),
                                       ("LTE", "HARD8"),
                                       ("DAB Radio", "SOFT16"),
                                       ("CDMA IS-95A", "SOFT8"),
                                       ("CDMA 2000", "HARD8")])
def test_wrapping_mode_matches_pallas(name, mode):
    """Scalar-kernel semantics: masked metrics, ties to predecessor 0,
    with symbols past the soft range (the kernel does not clamp)."""
    js, ts = _spec_pair(vt.get_code(name), mode, "wrapping")
    n = js.K - 1
    _check_vs_pallas(js, ts, B=2, T=2 * n + 1, seed=5, spread=2)


@pytest.mark.parametrize("K,mode,arith", [(10, "SOFT16", "saturating"),
                                          (10, "HARD8", "wrapping"),
                                          (11, "SOFT8", "saturating"),
                                          (11, "SOFT16", "wrapping")])
def test_random_codes_match_pallas(K, mode, arith):
    js, ts = _spec_pair(_random_code(K, 2, K), mode, arith)
    _check_vs_pallas(js, ts, B=1, T=2 * (K - 1) + 3, seed=K)


def test_over_cap_k13_rate6_matches_jax_core():
    """K=13 R=1/6 (S=4096, over the TPU kernel's VMEM cap, so the JAX
    package sends it to the lane kernel): the port routes it here; hold
    bits, metrics and acc against the state-order XLA scan."""
    jcode = _random_code(13, 6, 13)
    js, ts = _spec_pair(jcode, "SOFT8")
    B, T = 2, 27
    m0, syms = _inputs(js, B, T, seed=3)
    jm, jp, ja = jax_core.acs_scan(js, jnp.asarray(m0), jnp.asarray(syms))
    tm, tp, ta = rotated.acs_rotated(ts, torch.as_tensor(m0),
                                     torch.as_tensor(syms))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    total_bits = T - (js.K - 1)
    jb = jax_core.chainback_scan(js, jp, jnp.zeros(B, jnp.int32), total_bits)
    tb = chainback.chainback(ts, tp, torch.zeros(B, dtype=torch.int32),
                             total_bits, slot_order=True)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_chained_calls_equal_one_call():
    """The schedule restarts at age 0 on every call and the metrics are
    un-rotated at both ends: ragged chunks chain to the one-shot result,
    and their rows walk back with the per-chunk rotations."""
    js, ts = _spec_pair(vt.get_code("LTE"), "SOFT8")
    n = js.K - 1
    B, T = 2, 31
    m0, syms = _inputs(js, B, T, seed=9)
    sy = torch.as_tensor(syms)
    m1, p1, a1 = rotated.acs_rotated(ts, torch.as_tensor(m0), sy)
    m, acc, rows, rots = torch.as_tensor(m0), torch.zeros(B, dtype=torch.int32), [], []
    for lo, hi in ((0, 7), (7, 20), (20, 31)):
        m, p, a = rotated.acs_rotated(ts, m, sy[:, lo:hi].contiguous())
        acc = acc + a
        rows.append(p)
        rots.append((torch.arange(hi - lo) + 1) % n)
    np.testing.assert_array_equal(m.numpy(), m1.numpy())
    np.testing.assert_array_equal(acc.numpy(), a1.numpy())
    ends = torch.zeros(B, dtype=torch.int32)
    one = chainback.chainback(ts, p1, ends, T - n, slot_order=True)
    chunked = chainback.chainback(ts, torch.cat(rows), ends, T - n,
                                  slot_order=True, rots=torch.cat(rots))
    np.testing.assert_array_equal(chunked.numpy(), one.numpy())


@pytest.mark.parametrize("name", ROTATED_CODES)
def test_slot_tables_and_taps(name):
    """The plain version's (n, R, S) slot table equals the Pallas one,
    and the tap masks the kernel computes branch values from rebuild
    spec.bt in every regime."""
    for mode in MODES:
        js, ts = _spec_pair(vt.get_code(name), mode)
        n = js.K - 1
        np.testing.assert_array_equal(
            rotated._slot_bt(ts).reshape(-1, 1), rotated_pallas._slot_bt(js))
        g = rotated._gmask(ts)
        bt = np.asarray(ts.bt)
        h = np.arange(ts.H) << 1
        for r, gr in enumerate(g):
            par = np.array([bin(int(x) & gr).count("1") & 1 for x in h])
            np.testing.assert_array_equal(
                np.where(par == 1, ts.soft_high, ts.soft_low), bt[r])
    x = np.arange(1 << 8)
    for k in (-3, 0, 2, 7):
        np.testing.assert_array_equal(rotated._rotr(x, k, 8),
                                      bigstate._rotr(x, k, 8))


@pytest.mark.parametrize("K,R", [(7, 2), (8, 5), (9, 2), (10, 4), (11, 3)])
def test_warp_patterns_rebuild_the_pallas_slot_table(K, R):
    """The warp design's branch patterns: slot l + 32k at phase phi takes
    pattern apat[phi][l] ^ cpat[phi][k], whose bit r picks the high level
    for rate r.  They rebuild the Pallas kernel's (n, R, S) slot table in
    every regime, for every n and R of the design."""
    jcode = vt.get_code("Voyager") if (K, R) == (7, 2) \
        else _random_code(K, R, K * R)
    for mode in MODES:
        js, ts = _spec_pair(jcode, mode)
        n = K - 1
        apat, cpat = rotated._warp_patterns(ts)
        assert apat.shape == (n, 32) and cpat.shape == (n, ts.S // 32)
        slots = np.arange(ts.S)
        pat = apat[:, slots & 31] ^ cpat[:, slots >> 5]         # (n, S)
        bits = (pat[:, None, :] >> np.arange(R)[None, :, None]) & 1
        table = np.where(bits == 1, ts.soft_high, ts.soft_low)  # (n, R, S)
        np.testing.assert_array_equal(table.reshape(-1, 1),
                                      rotated_pallas._slot_bt(js))


def test_rows_go_into_out():
    """``out=`` receives the decision rows in place (the decoder passes a
    slice of its buffer) and is returned as ``packed``; a wrong buffer
    raises."""
    js, ts = _spec_pair(vt.get_code("CDMA 2000"), "SOFT8")
    m0, syms = _inputs(js, 2, 13, seed=4)
    m0, syms = torch.as_tensor(m0), torch.as_tensor(syms)
    want = rotated.acs_rotated(ts, m0, syms)
    buf = torch.full((20, ts.W, 2), -1, dtype=torch.int32)
    got = rotated.acs_rotated(ts, m0, syms, out=buf[3:16])
    assert got[1].data_ptr() == buf[3:16].data_ptr()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (buf[:3] == -1).all() and (buf[16:] == -1).all()
    with pytest.raises(ValueError, match="out must be"):
        rotated.acs_rotated(ts, m0, syms, out=buf[3:15])


def test_kernel_design_follows_the_register_budget():
    """One warp per frame while a lane holds at most 32 metrics (S <= 1024,
    K <= 11) and a step's branch patterns fit the warp's lanes (R <= 5);
    one block per frame for S = 2048 and 4096 and for R > 5."""
    assert [rotated.kernel_design(1 << n, 2) for n in range(6, 13)] == \
        ["warp"] * 5 + ["block"] * 2
    assert [rotated.kernel_design(64, R) for R in (1, 5, 6, 16)] == \
        ["warp", "warp", "block", "block"]
    for name in ROTATED_CODES:                  # every registry code: warp
        code = vt.get_code(name)
        assert rotated.kernel_design(1 << (code.K - 1), code.R) == "warp"
    for S in (32, 8192):
        with pytest.raises(ValueError, match="64 <= S"):
            rotated.kernel_design(S, 2)


def test_bad_inputs_raise():
    _, small = _spec_pair(vt.get_code("Basic K=5 R=1/2"), "SOFT8")
    with pytest.raises(ValueError, match="64 <= S"):
        rotated.acs_rotated(small, torch_core.initial_metrics(small, 1),
                            torch.zeros((1, 4, 2), dtype=torch.int32))
    _, ts = _spec_pair(vt.get_code("Voyager"), "SOFT8")
    m0 = torch_core.initial_metrics(ts, 2)
    with pytest.raises(ValueError, match="symbols must be"):
        rotated.acs_rotated(ts, m0, torch.zeros((2, 4, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="metrics must be"):
        rotated.acs_rotated(ts, m0[:32], torch.zeros((2, 4, 2),
                                                     dtype=torch.int32))
    bad = ts._replace(bt=((3,) * ts.H, (-3,) * ts.H))
    with pytest.raises(ValueError, match="parity table"):
        rotated._gmask(bad)


@pytest.mark.cuda
@pytest.mark.parametrize("name,mode,arith", [("Voyager", "SOFT8", "saturating"),
                                             ("CDMA 2000", "HARD8", "wrapping")])
def test_cuda_kernel_matches_plain(cuda_device, name, mode, arith):
    _, ts = _spec_pair(vt.get_code(name), mode, arith)
    m0, syms = _inputs(ts, 64, 301, seed=1)
    m0 = torch.as_tensor(m0, device=cuda_device)
    sy = torch.as_tensor(syms, device=cuda_device)
    before = trace.counters().get("launches.rotated_acs", 0)
    got = rotated.acs_rotated(ts, m0, sy)
    torch.cuda.synchronize()
    assert trace.counters()["launches.rotated_acs"] == before + 1
    want = rotated.acs_rotated_ref(ts, m0, sy)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
