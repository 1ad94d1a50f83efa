"""Lane ACS of the port (ops/lane.py) against the JAX package's lane
kernel, acs_pallas.acs_pallas(interpret=True).

Bit-exact on the state-order final metrics, the packed decision rows
(ViterbiDecisionBits state order, W = 1) and the renorm accumulators, for
Basic K=3, Basic K=5 and random K=2, K=4 and K=6 codes with R = 2..5, in
all three regimes and both arithmetic modes, from off-reset metrics.  The
JAX kernel's default branch metric is exact only for symbols in the soft
range, so out-of-range symbols are held against jax_core.acs_scan.  The
wrapper's cached branch patterns rebuild the JAX spec's branch table, and
an ``out`` slice of a larger buffer is written and nothing else.  The
kernel-vs-plain tests need a card (marked ``cuda``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import viterbidecodercpp_torch as pt
import viterbidecodercpp_tpu as vt
from viterbidecodercpp_torch.ops import chainback, lane, torch_core
from viterbidecodercpp_tpu.ops import acs_pallas, jax_core

MODES = ["SOFT16", "SOFT8", "HARD8"]
ARITHS = ["saturating", "wrapping"]


def _random_code(K, R, seed):
    rng = np.random.RandomState(seed)
    G = tuple(int(rng.randint(0, 1 << K)) | 1 | (1 << (K - 1))
              for _ in range(R))
    return vt.CodeSpec(f"rand K={K} R=1/{R}", K, G)


CODES = [vt.get_code("Basic K=3 R=1/2"), vt.get_code("Basic K=5 R=1/2"),
         _random_code(2, 3, 2), _random_code(4, 5, 4), _random_code(6, 4, 6)]


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


def _inputs(spec, B, T, seed, spread=0):
    """Symbols (``spread`` past the soft range) and off-reset metrics, so
    every state carries a live metric."""
    rng = np.random.RandomState(seed)
    syms = rng.randint(spec.soft_low - spread, spec.soft_high + spread + 1,
                       (B, T, spec.R)).astype(np.int32)
    m0 = np.array(jax_core.initial_metrics(spec, B, seed % spec.S))
    m0 = np.minimum(m0, rng.randint(0, spec.metric_max + 1, m0.shape)
                    ).astype(np.int32)
    return m0, syms


def _eq(got, want):
    if isinstance(got, torch.Tensor):
        got = got.cpu().numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arith", ARITHS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("code", CODES, ids=lambda c: c.name)
def test_acs_lane_matches_jax_lane_kernel(code, mode, arith):
    js, ts = _spec_pair(code, mode, arith)
    B, T = 3, 41
    m0, syms = _inputs(js, B, T, seed=code.K * 7 + len(mode))
    want = acs_pallas.acs_pallas(js, jnp.asarray(m0), jnp.asarray(syms),
                                 interpret=True)
    for fn in (lane.acs_lane, lane.acs_lane_ref):
        got = fn(ts, torch.as_tensor(m0), torch.as_tensor(syms))
        assert got[1].shape == (T, 1, B) and got[1].dtype == torch.int32
        for g, w in zip(got, want):
            _eq(g, w)
        if ts.S < 32:
            assert bool(((got[1] >> ts.S) == 0).all()), "bits >= S set"


@pytest.mark.parametrize("name,mode,arith", [
    ("Basic K=3 R=1/2", "HARD8", "wrapping"),
    ("Basic K=5 R=1/2", "SOFT8", "saturating"),
    ("rand K=6 R=1/4", "SOFT16", "wrapping"),
])
def test_out_of_range_symbols_match_the_scan(name, mode, arith):
    """Past the soft range the lane ACS keeps the abs-diff branch metric
    of jax_core.acs_scan (the TPU kernel's default shortcut does not)."""
    code = next(c for c in CODES if c.name == name)
    js, ts = _spec_pair(code, mode, arith)
    m0, syms = _inputs(js, 2, 37, seed=11, spread=5)
    want = jax_core.acs_scan(js, jnp.asarray(m0), jnp.asarray(syms))
    got = lane.acs_lane(ts, torch.as_tensor(m0), torch.as_tensor(syms))
    for g, w in zip(got, want):
        _eq(g, w)


def test_state_order_walk_on_lane_rows_matches_jax():
    code = vt.get_code("Basic K=5 R=1/2")
    js, ts = _spec_pair(code, "SOFT16")
    m0, syms = _inputs(js, 3, 40, seed=5)
    _, packed, _ = lane.acs_lane(ts, torch.as_tensor(m0),
                                 torch.as_tensor(syms))
    ends = np.array([0, 5, 15], np.int32)
    want = jax_core.chainback_scan(js, jnp.asarray(packed.numpy()),
                                   jnp.asarray(ends), 36)
    _eq(chainback.chainback(ts, packed, torch.as_tensor(ends), 36), want)


def test_explicit_errors():
    _, voy = _spec_pair(vt.get_code("Voyager"), "SOFT8")
    _, ts = _spec_pair(vt.get_code("Basic K=3 R=1/2"), "SOFT8")
    assert lane.supports(ts) and not lane.supports(voy)
    m = torch.zeros((ts.S, 2), dtype=torch.int32)
    s = torch.zeros((2, 5, ts.R), dtype=torch.int32)
    with pytest.raises(ValueError, match="rotated kernel"):
        lane.acs_lane(voy, torch.zeros((voy.S, 2), dtype=torch.int32), s)
    with pytest.raises(ValueError, match="rotated kernel"):
        lane.acs_lane_ref(voy, torch.zeros((voy.S, 2), dtype=torch.int32), s)
    with pytest.raises(ValueError, match="metrics must be"):
        lane.acs_lane(ts, m[:3], s)
    with pytest.raises(ValueError, match="symbols must be"):
        lane.acs_lane(ts, m, s[:, :, :1])
    with pytest.raises(ValueError, match="symbols must be"):
        lane.acs_lane(ts, m, s[:1])
    with pytest.raises(ValueError, match="unsupported device"):
        lane.acs_lane(ts, m.to("meta"), s.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("arith", ARITHS)
@pytest.mark.parametrize("code", CODES, ids=lambda c: c.name)
def test_cuda_kernel_matches_plain(cuda_device, code, arith):
    _, ts = _spec_pair(code, "SOFT8", arith)
    m0, syms = _inputs(ts, 100, 301, seed=3, spread=2)
    m0 = torch.as_tensor(m0, device=cuda_device)
    syms = torch.as_tensor(syms, device=cuda_device)
    got = lane.acs_lane(ts, m0, syms)
    want = lane.acs_lane_ref(ts, m0, syms)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
    wide = pt.CodeSpec("R=17", code.K, (code.G[0],) * 17)
    ws = torch_core.make_static_spec(
        wide, pt.get_decode_config(pt.DecodeType.SOFT8, 17))
    with pytest.raises(ValueError, match="R <= 16"):
        lane.acs_lane(ws, m0, torch.zeros((100, 4, 17), dtype=torch.int32,
                                          device=cuda_device))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("K", [2, 3, 4, 5, 6])
def test_cached_patterns_give_the_branch_metric(K, mode):
    """The kernel's metric of state s, sum_r |(bit r of pattern ? high :
    low) - sym[r]|, equals sum_r |bt[r][s >> 1] - sym[r]| of the JAX spec,
    for every rate 1/2 .. 1/16 and symbols past the soft range."""
    rng = np.random.RandomState(K * 31 + len(mode))
    for R in range(2, 17):
        for arith in ARITHS:
            js, ts = _spec_pair(_random_code(K, R, K * 100 + R), mode, arith)
            pat = lane._lane_patterns(ts)
            assert pat is lane._lane_patterns(ts)           # made once
            assert pat.shape == (ts.S,) and pat.dtype == np.int32
            assert ((pat >> R) == 0).all()
            bt = np.asarray(js.bt, dtype=np.int64)            # (R, H)
            syms = rng.randint(ts.soft_low - 9, ts.soft_high + 10, (7, R))
            bits = (pat[:, None] >> np.arange(R)) & 1          # (S, R)
            level = np.where(bits == 1, ts.soft_high, ts.soft_low)
            got = np.abs(level[None] - syms[:, None]).sum(-1)  # (7, S)
            h = np.arange(ts.S) >> 1
            want = np.abs(bt[:, h].T[None] - syms[:, None]).sum(-1)
            np.testing.assert_array_equal(got, want)


def test_patterns_refuse_a_third_table_value():
    _, ts = _spec_pair(vt.get_code("Basic K=5 R=1/2"), "SOFT8")
    odd = ts._replace(bt=((ts.soft_high, 0) * (ts.H // 2), ts.bt[1]))
    with pytest.raises(ValueError, match="soft levels"):
        lane._lane_patterns(odd)


@pytest.mark.parametrize("fn", [lane.acs_lane, lane.acs_lane_ref],
                         ids=["acs_lane", "acs_lane_ref"])
@pytest.mark.parametrize("name,mode,arith,row0", [
    ("Basic K=5 R=1/2", "SOFT16", "saturating", 4),
    ("Basic K=3 R=1/2", "HARD8", "wrapping", 0),
])
def test_out_row0_writes_only_its_rows(fn, name, mode, arith, row0):
    """``out`` as a decoder passes it: the slice [row0, row0 + T) of a
    larger row buffer, which alone is written."""
    code = next(c for c in CODES if c.name == name)
    js, ts = _spec_pair(code, mode, arith)
    B, T = 3, 35
    m0, syms = _inputs(js, B, T, seed=row0 + 17)
    want = acs_pallas.acs_pallas(js, jnp.asarray(m0), jnp.asarray(syms),
                                 interpret=True)
    buf = torch.full((T + row0 + 6, 1, B), -5, dtype=torch.int32)
    got = fn(ts, torch.as_tensor(m0), torch.as_tensor(syms),
             out=buf[row0:row0 + T])
    assert got[1].data_ptr() == buf[row0].data_ptr()
    assert got[1].shape == (T, 1, B)
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(buf[row0:row0 + T], want[1])
    assert bool((buf[:row0] == -5).all()) and bool((buf[row0 + T:] == -5)
                                                   .all())


def test_out_row0_errors():
    _, ts = _spec_pair(vt.get_code("Basic K=3 R=1/2"), "SOFT8")
    m = torch.zeros((ts.S, 2), dtype=torch.int32)
    s = torch.zeros((2, 5, ts.R), dtype=torch.int32)
    buf = torch.zeros((8, 1, 2), dtype=torch.int32)
    for fn in (lane.acs_lane, lane.acs_lane_ref):
        with pytest.raises(ValueError, match="out must be"):
            fn(ts, m, s, out=buf)                     # 8 rows for T=5
        with pytest.raises(ValueError, match="out must be"):
            fn(ts, m, s, out=buf[:4])
        with pytest.raises(ValueError, match="out must be"):
            fn(ts, m, s, out=buf[:5, :, :1])
        with pytest.raises(ValueError, match="out must be"):
            fn(ts, m, s, out=buf[:5].to(torch.int64))
        with pytest.raises(ValueError, match="out must be"):
            fn(ts, m, s, out=torch.zeros((2, 1, 5),
                                         dtype=torch.int32).transpose(0, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("K,R", [(2, 16), (5, 9), (6, 16)])
def test_cuda_kernel_generic_rates(cuda_device, K, R):
    """R > 5: a metric per lane from the run-time rate loop; K=2 R=16 has
    the smallest symbol tile (2 steps)."""
    for mode in MODES:
        for arith in ARITHS:
            _, ts = _spec_pair(_random_code(K, R, K + R), mode, arith)
            for B, T in ((1, 33), (100, 301)):
                m0, syms = _inputs(ts, B, T, seed=B + T, spread=2)
                m0 = torch.as_tensor(m0, device=cuda_device)
                syms = torch.as_tensor(syms, device=cuda_device)
                buf = torch.full((T + 3, 1, B), -5, dtype=torch.int32,
                                 device=cuda_device)
                got = lane.acs_lane(ts, m0, syms, out=buf[2:2 + T])
                want = lane.acs_lane_ref(ts, m0, syms)
                for g, w in zip(got, want):
                    assert torch.equal(g, w)
                assert bool((buf[:2] == -5).all())
                assert bool((buf[2 + T:] == -5).all())
