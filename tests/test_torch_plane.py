"""Plane ACS of the port (ops/plane.py) against the JAX package's Pallas
kernel, bigstate_pallas.acs_plane_pallas(interpret=True).

Bit-exact on the state-order final metrics, the packed (B, T, WRr, 128)
slot-order decision words in the JAX plane bit order, and the renorm
accumulators: Cassini in the three regimes, wrapping arithmetic, a random
K=14 code (n * WRr = 26 word rows per step), and out-of-range symbols at
phase0 != 0 and T < n, and a random K=18 code (the kernel's cluster of
four blocks on the card).  Random K=16..21 codes (one block, clusters of
two, four and eight blocks, and the global-metric kernel on the card)
are held against jax_core.acs_scan instead (bits through the plane walk,
metrics, acc).  Each interpret-mode call takes seconds, so every one is
compared against several port outputs.  The CUDA kernel's branch-pattern tables
are held against the Pallas kernel's branch planes in numpy.  The
kernel-vs-plain tests need a card (marked ``cuda``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import viterbidecodercpp_torch as pt
from viterbidecodercpp_torch import trace
import viterbidecodercpp_tpu as vt
from viterbidecodercpp_torch.ops import plane, rotated, torch_core
from viterbidecodercpp_tpu.ops import bigstate_pallas, jax_core


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
    """Symbols (B, T, R) and metrics off the reset state, so every slot
    carries a live metric from the first step."""
    rng = np.random.RandomState(seed)
    syms = rng.randint(js.soft_low - spread, js.soft_high + spread + 1,
                       (B, T, js.R)).astype(np.int32)
    m0 = np.minimum(np.array(jax_core.initial_metrics(js, B, seed)),
                    rng.randint(0, js.metric_max + 1, (js.S, B)))
    return m0.astype(np.int32), syms


def _check_vs_pallas(js, ts, B, T, seed, spread=0, phase0=0):
    m0, syms = _inputs(js, B, T, seed, spread)
    want = bigstate_pallas.acs_plane_pallas(
        js, jnp.asarray(m0), jnp.asarray(syms), phase0=phase0,
        interpret=True)
    got = plane.acs_plane(ts, torch.as_tensor(m0), torch.as_tensor(syms),
                          phase0=phase0)
    assert got[1].shape == (B, T, ts.S // 4096, 128)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the rows written into a larger buffer at an offset are the same
    buf = torch.full((B, T + 9, ts.S // 4096, 128), -7, dtype=torch.int32)
    m, rows, acc = plane.acs_plane_ref(
        ts, torch.as_tensor(m0), torch.as_tensor(syms), phase0=phase0,
        out=buf, row0=4)
    assert torch.equal(rows, got[1]) and torch.equal(buf[:, 4:T + 4], got[1])
    assert (buf[:, :4] == -7).all() and (buf[:, T + 4:] == -7).all()
    assert torch.equal(m, got[0]) and torch.equal(acc, got[2])
    return m0, syms, got


@pytest.mark.parametrize("mode,arith", [("SOFT16", "saturating"),
                                        ("SOFT8", "saturating"),
                                        ("HARD8", "saturating"),
                                        ("SOFT16", "wrapping")])
def test_cassini_matches_pallas(mode, arith):
    js, ts = _spec_pair(vt.get_code("Cassini"), mode, arith)
    # 33 = 2n + 5 steps: past the JAX kernel's 28-step time block
    _check_vs_pallas(js, ts, B=2, T=33, seed=len(mode) + len(arith))


def test_random_k18_code_matches_pallas():
    """K=18 (a cluster of four blocks on the card), wrapping, over 2n+3
    steps from phase0 = 3: the plane words equal the JAX plane kernel's."""
    js, ts = _spec_pair(_random_code(18, 2, 18), "SOFT16", "wrapping")
    _check_vs_pallas(js, ts, B=2, T=37, seed=4, phase0=3)


def test_random_k14_code_matches_pallas():
    """K=14: WRr = 2, so a step's decisions are 26 word rows of the
    chunk slab - the odd slab height the JAX kernel once gated out."""
    js, ts = _spec_pair(_random_code(14, 2, 14), "SOFT8", "wrapping")
    _check_vs_pallas(js, ts, B=3, T=31, seed=2)


def test_out_of_range_symbols_phase0_and_short_call_match_pallas():
    """Symbols past [-A, A] are clamped as the JAX wrapper does; phase0
    != 0 enters mid-schedule; T < n ends inside the first period."""
    js, ts = _spec_pair(vt.get_code("Cassini"), "SOFT8")
    m0, syms, got = _check_vs_pallas(js, ts, B=2, T=11, seed=3, spread=4,
                                     phase0=5)
    assert np.abs(syms).max() > 3
    clamped = plane.acs_plane(ts, torch.as_tensor(m0),
                              torch.as_tensor(np.clip(syms, -3, 3)),
                              phase0=5)
    for g, c in zip(got, clamped):
        assert torch.equal(g, c)


@pytest.mark.parametrize("K", [16, 17, 18, 19, 20, 21])
def test_random_k16_k17_codes_match_jax_core(K):
    """K=16 (one 1024-thread block per frame on the card), K=17, 18 and
    19 (clusters of two, four and eight) and K=20, 21 (the global-metric
    kernel): metrics and acc equal the state-order XLA scan, and the
    plane rows walk back to its bits.  Past K=17 over 2n+3 steps from
    random metrics near metric_max, so the renorm gate fires and
    subtracts a frame minimum that lies in any slot."""
    js, ts = _spec_pair(_random_code(K, 2, K), "SOFT16")
    B, T = 2, (24 if K <= 17 else 2 * (K - 1) + 3)
    m0, syms = _inputs(js, B, T, seed=5)
    if K >= 18:
        m0 = (js.metric_max - np.random.RandomState(K).randint(
            0, 4 * js.max_error + 1, m0.shape)).astype(np.int32)
    jm, jp, ja = jax_core.acs_scan(js, jnp.asarray(m0), jnp.asarray(syms))
    tm, tp, ta = plane.acs_plane(ts, torch.as_tensor(m0),
                                 torch.as_tensor(syms))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    if K >= 18:
        assert (ta != 0).all()
    total_bits = T - (js.K - 1)
    ends = np.array([0, 12345], np.int32)
    jb = jax_core.chainback_scan(js, jp, jnp.asarray(ends), total_bits)
    tb = plane.chainback_plane(ts, tp, torch.as_tensor(ends), total_bits)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_chained_calls_equal_one_call():
    """Metrics are state order at both ends, so chunks chain to the
    one-shot result (decode_big_plane's); each chunk's rows walk back
    with its own rotations, and phase0 = age keeps the one global
    schedule."""
    _, ts = _spec_pair(vt.get_code("Cassini"), "HARD8")
    n = ts.K - 1
    B, T = 2, 30
    m0, syms = _inputs(ts, B, T, seed=7)
    sy = torch.as_tensor(syms)
    m1, p1, a1 = plane.acs_plane(ts, torch.as_tensor(m0), sy)
    buf = torch.empty((B, T, ts.S // 4096, 128), dtype=torch.int32)
    glob = torch.empty_like(buf)
    m, mg = torch.as_tensor(m0), torch.as_tensor(m0)
    acc = torch.zeros(B, dtype=torch.int32)
    rots = torch.empty(T, dtype=torch.int32)
    for lo, hi in ((0, 9), (9, 23), (23, 30)):
        chunk = sy[:, lo:hi].contiguous()
        m, _, a = plane.acs_plane(ts, m, chunk, out=buf, row0=lo)
        mg, _, _ = plane.acs_plane(ts, mg, chunk, out=glob, row0=lo,
                                   phase0=lo)
        acc = acc + a
        rots[lo:hi] = (torch.arange(hi - lo) + 1) % n
    assert torch.equal(m, m1) and torch.equal(mg, m1)
    assert torch.equal(acc, a1) and torch.equal(glob, p1)
    ends = torch.zeros(B, dtype=torch.int32)
    one, m2, p2, a2 = plane.decode_big_plane(ts, torch.as_tensor(m0), sy,
                                             ends, T - n)
    assert torch.equal(m2, m1) and torch.equal(p2, p1) and torch.equal(a2, a1)
    assert torch.equal(plane.chainback_plane(ts, p1, ends, T - n), one)
    assert torch.equal(plane.chainback_plane(ts, buf, ends, T - n,
                                             rots=rots), one)


def test_supports_gate_and_bounds():
    """supports() is the JAX gate, with no upper bound; the CUDA ACS
    kernel is chosen by K alone: the cluster kernel up to K=19, the
    global-metric kernel above."""
    for name, want in (("Cassini", True), ("CDMA 2000", False),
                       ("Voyager", False)):
        js, ts = _spec_pair(vt.get_code(name), "SOFT8")
        assert plane.supports(ts) is want
        assert bigstate_pallas.supports(js) is want
        assert plane.time_block_rows(ts) == \
            bigstate_pallas.time_block_rows(js)
    for K, kernel in ((14, "plane_acs"), (17, "plane_acs"),
                      (18, "plane_acs"), (19, "plane_acs"),
                      (20, "plane_acs_global"), (21, "plane_acs_global"),
                      (24, "plane_acs_global")):
        js, ts = _spec_pair(_random_code(K, 2, K), "SOFT8")
        assert plane.supports(ts) and bigstate_pallas.supports(js)
        assert plane.acs_kernel(ts) == kernel
    assert plane.MAX_CLUSTER_STATES == 1 << 18
    assert set(plane.KERNELS) == {"plane_acs", "plane_acs_global",
                                  "plane_walk", "plane_walk_trunc"}


def test_bad_inputs_raise():
    _, ts = _spec_pair(vt.get_code("Cassini"), "SOFT8")
    m0 = torch_core.initial_metrics(ts, 2)
    sy = torch.zeros((2, 4, ts.R), dtype=torch.int32)
    with pytest.raises(ValueError, match="symbols must be"):
        plane.acs_plane(ts, m0, sy[:, :, :2])
    with pytest.raises(ValueError, match="metrics must be"):
        plane.acs_plane(ts, m0[:100], sy)
    with pytest.raises(ValueError, match="do not fit"):
        plane.acs_plane(ts, m0, sy, out=torch.zeros((2, 5, 4, 128),
                                                    dtype=torch.int32),
                        row0=2)
    with pytest.raises(ValueError, match="out must be"):
        plane.acs_plane(ts, m0, sy, out=torch.zeros((2, 5, 2, 128),
                                                    dtype=torch.int32))
    with pytest.raises(ValueError, match="row0 needs"):
        plane.acs_plane(ts, m0, sy, row0=1)
    # below the class (S <= 4096); above it there is no bound
    _, small = _spec_pair(vt.get_code("Voyager"), "SOFT8")
    with pytest.raises(ValueError, match="plane class covers S > 4096"):
        plane.acs_plane_ref(small, torch_core.initial_metrics(small, 1),
                            torch.zeros((1, 2, 2), dtype=torch.int32))
    # the kernel's taps rebuild the whole branch table at K=15 R=6
    g = rotated._gmask(ts)
    assert len(g) == ts.R and all((x & 1) == 0 for x in g)


def _slot_patterns(ts):
    """(n, S) branch pattern of every slot as the kernel forms it: the
    thread part of q = (wr << 12) | (k << 7) | lane, computed per step,
    xor the register part kpat[phi][k] from ``_plane_patterns``."""
    n = ts.K - 1
    q = np.arange(ts.S)
    tb = ((q >> 12) << 12) | (q & 127)
    kpat = plane._plane_patterns(ts)
    assert kpat.shape == (n, 32) and kpat.dtype == np.int32
    out = np.zeros((n, ts.S), np.int64)
    for phi in range(n):
        dist = 1 << (n - 1 - phi)
        tpat = rotated._branch_pattern(ts, rotated._rotr(tb & ~dist, -phi, n))
        out[phi] = tpat ^ kpat[phi][(q >> 7) & 31]
    return out


@pytest.mark.parametrize("K,R", [(15, 6), (14, 2), (16, 2), (17, 2),
                                 (14, 11), (16, 9), (17, 12)])
def test_plane_patterns_rebuild_the_pallas_branch_planes(K, R):
    """The kernel's branch patterns (thread part xor ``_plane_patterns``)
    pick high or low on each rate exactly as the Pallas kernel's
    per-phase, per-slot branch planes do, in every regime: Cassini and
    random codes at each n of the class, at R=2 and at R above 8 (two
    pattern tables)."""
    jcode = vt.get_code("Cassini") if (K, R) == (15, 6) \
        else _random_code(K, R, K * R)
    for mode in ("SOFT16", "SOFT8", "HARD8"):
        js, ts = _spec_pair(jcode, mode)
        pat = _slot_patterns(ts)                                  # (n, S)
        bits = (pat[:, None, :] >> np.arange(R)[None, :, None]) & 1
        table = np.where(bits == 1, ts.soft_high, ts.soft_low)   # (n, R, S)
        want = bigstate_pallas._phase_bt_planes(js, signs=False)
        np.testing.assert_array_equal(table, want.reshape(table.shape))


@pytest.mark.parametrize("K,R", [(15, 6), (14, 16)])
def test_step_tables_give_each_slot_its_branch_metric(K, R):
    """A step's branch-metric tables as the kernel builds them - groups of
    up to 8 rates, entry e of group g the sum over its rates of
    |high - sym| (bit set) or |low - sym| - summed over the groups at a
    slot's pattern give the plain version's per-slot metric, for symbols
    anywhere in int32's small range."""
    jcode = vt.get_code("Cassini") if (K, R) == (15, 6) \
        else _random_code(K, R, 3)
    _, ts = _spec_pair(jcode, "SOFT16")
    pat = _slot_patterns(ts)
    slot_bt = rotated._slot_bt(ts)                                # (n, R, S)
    rng = np.random.RandomState(K)
    groups = -(-R // 8)
    for phi in range(ts.K - 1):
        sym = rng.randint(-300, 301, R)
        dl, dh = np.abs(ts.soft_low - sym), np.abs(ts.soft_high - sym)
        e = np.arange(256)
        bm = np.zeros(ts.S, np.int64)
        for g in range(groups):
            rates = range(8 * g, min(8 * g + 8, R))
            tab = sum(np.where((e >> (r - 8 * g)) & 1, dh[r], dl[r])
                      for r in rates)
            bm += tab[(pat[phi] >> (8 * g)) & 255]
        np.testing.assert_array_equal(
            bm, np.abs(slot_bt[phi] - sym[:, None]).sum(axis=0))


@pytest.mark.cuda
@pytest.mark.parametrize("K,R,mode,arith", [(15, 6, "SOFT16", "saturating"),
                                            (14, 2, "HARD8", "wrapping"),
                                            (16, 2, "SOFT8", "saturating"),
                                            (17, 2, "SOFT16", "wrapping"),
                                            (15, 8, "SOFT16", "wrapping"),
                                            (14, 11, "HARD8", "saturating"),
                                            (17, 6, "SOFT16", "saturating"),
                                            (18, 2, "SOFT16", "saturating"),
                                            (19, 6, "SOFT8", "wrapping"),
                                            (20, 2, "HARD8", "saturating"),
                                            (21, 6, "SOFT16", "wrapping")])
def test_cuda_kernel_matches_plain(cuda_device, K, R, mode, arith):
    jcode = vt.get_code("Cassini") if K == 15 else _random_code(K, R, K)
    _, ts = _spec_pair(jcode, mode, arith)
    m0, syms = _inputs(ts, 20, 61, seed=1, spread=3)
    m0 = torch.as_tensor(m0, device=cuda_device)
    sy = torch.as_tensor(syms, device=cuda_device)
    kernel = plane.acs_kernel(ts)
    before = trace.counters().get("launches." + kernel, 0)
    for phase0 in (0, 3):
        got = plane.acs_plane(ts, m0, sy, phase0=phase0)
        torch.cuda.synchronize()
        want = plane.acs_plane_ref(ts, m0, sy, phase0=phase0)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # one kernel a call on both routes (the global one is persistent)
    assert trace.counters()["launches." + kernel] == before + 2
