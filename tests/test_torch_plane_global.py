"""The global-metric plane ACS (csrc/plane_acs_global.cu, K >= 20 on the
card): one persistent kernel a call over ``global_grid``'s blocks.

On the CPU, ``plane._global_steps`` - the kernel's schedule in plain
torch: its grid, each block's run of tiles, the deferred renorm and its
three rotating cells - runs at K=14 and 15 with tiles of S/8 slots, so a
frame has several tiles and blocks take one tile, several tiles of one
frame, or tiles of two frames.  It is held, tolerance 0 (metrics, packed
words, acc), against ``acs_plane_ref`` over both arithmetic modes, B in
{1, 3}, T in {1, n-1, 2n+3} from the reset metrics and from metrics near
metric_max (the renorm gate fires from the first step), at phase0 != 0,
and against the JAX package's Pallas kernel
(``bigstate_pallas.acs_plane_pallas(interpret=True)``) at B=3, T=2n+3.
The grid planner is checked below, at and above the resident blocks and
with none.  The kernel-vs-plain tests need a card (marked ``cuda``).
"""

import contextlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import viterbidecodercpp_torch as pt
from viterbidecodercpp_torch import trace
import viterbidecodercpp_tpu as vt
from viterbidecodercpp_torch.ops import plane, torch_core
from viterbidecodercpp_tpu.ops import bigstate_pallas, jax_core


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _code(K, seed):
    if K == 15:
        return vt.get_code("Cassini")
    rng = np.random.RandomState(seed)
    G = tuple(int(rng.randint(0, 1 << K)) | 1 | (1 << (K - 1))
              for _ in range(2))
    return vt.CodeSpec(f"rand K={K} R=1/2", K, G)


def _specs(jcode, mode, arith):
    tcode = pt.CodeSpec(jcode.name, jcode.K, jcode.G)
    jcfg = vt.get_decode_config(vt.DecodeType(mode), jcode.R, arith=arith)
    tcfg = pt.get_decode_config(pt.DecodeType(mode), tcode.R, arith=arith)
    return (jax_core.make_static_spec(jcode, jcfg),
            torch_core.make_static_spec(tcode, tcfg))


def _inputs(ts, B, T, start, seed):
    """Symbols past the soft range, and the reset metrics or random ones
    within 4 max_error of metric_max."""
    rng = np.random.RandomState(seed)
    syms = rng.randint(ts.soft_low - 2, ts.soft_high + 3,
                       (B, T, ts.R)).astype(np.int32)
    if start == "reset":
        m0 = torch_core.initial_metrics(ts, B, 0).numpy()
    else:
        m0 = (ts.metric_max - rng.randint(0, 4 * ts.max_error + 1,
                                          (ts.S, B))).astype(np.int32)
    return m0, syms


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("start", ["reset", "near max"])
@pytest.mark.parametrize("Tn", [0, 1, 2])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("arith", ["saturating", "wrapping"])
@pytest.mark.parametrize("K", [14, 15])
def test_global_schedule_matches_plain(K, arith, B, Tn, start):
    """The kernel's schedule equals the plain version at the grids the
    planner gives for 1000, 3 and 2 resident blocks at 8 tiles a frame
    (taken in turn over the cases): a tile a block, several tiles of a
    frame a block, and at B=3 blocks whose tiles span two frames."""
    mode = ("SOFT16", "SOFT8", "HARD8")[(K + B + Tn) % 3]
    _, ts = _specs(_code(K, K), mode, arith)
    n = K - 1
    T = (1, n - 1, 2 * n + 3)[Tn]
    m0, syms = _inputs(ts, B, T, start, seed=K * 100 + B * 10 + Tn)
    m0, syms = torch.as_tensor(m0), torch.as_tensor(syms)
    phase0 = (T + 2) % n or 1
    want = plane.acs_plane_ref(ts, m0, syms, phase0=phase0)
    resident = (1000, 3, 2)[(B + Tn + (start == "reset")) % 3]
    got = plane._global_steps(ts, m0, syms, phase0=phase0,
                              resident=resident, tile=ts.S // 8)
    _equal(got, want)
    if start == "near max" and arith == "saturating":
        assert (want[2] != 0).all()      # the gate fired


@pytest.mark.parametrize("K,arith,start", [(14, "saturating", "near max"),
                                           (14, "wrapping", "reset"),
                                           (15, "saturating", "reset"),
                                           (15, "wrapping", "near max")])
def test_global_schedule_matches_pallas(K, arith, start):
    """B=3 over 2n+3 steps from phase0 = 5: the schedule's metrics, words
    and acc equal the JAX plane kernel's, with blocks of one tile and with
    blocks over two frames' tiles."""
    js, ts = _specs(_code(K, K + 1), "SOFT16", arith)
    B, T = 3, 2 * (K - 1) + 3
    m0, syms = _inputs(ts, B, T, start, seed=K)
    want = bigstate_pallas.acs_plane_pallas(
        js, jnp.asarray(m0), jnp.asarray(syms), phase0=5, interpret=True)
    for resident in (1000, 2):
        got = plane._global_steps(ts, torch.as_tensor(m0),
                                  torch.as_tensor(syms), phase0=5,
                                  resident=resident, tile=ts.S // 8)
        _equal(got, want)


@pytest.mark.parametrize("S,B,resident,want", [
    (1 << 19, 4, 1056, (256, 1)),      # K=20 B=4: below the resident
    (1 << 19, 4, 256, (256, 1)),       # equal
    (1 << 22, 3, 1056, (768, 2)),      # K=23 B=3: two tiles a block
    (1 << 20, 4, 100, (64, 8)),        # eight tiles of one frame a block
    (1 << 19, 1000, 528, (500, 128)),  # a block over two frames
    (1 << 19, 3, 2, (2, 128)),         # a ragged last block
])
def test_global_grid(S, B, resident, want):
    grid, per = plane.global_grid(S, B, resident)
    assert (grid, per) == want
    tiles = (S // plane.GLOBAL_TILE) * B
    tpf = S // plane.GLOBAL_TILE
    assert grid <= resident and grid * per >= tiles > (grid - 1) * per
    assert per & (per - 1) == 0
    if per <= tpf:                     # every block within one frame
        assert tpf % per == 0


def test_global_grid_raises_without_resident_blocks():
    with pytest.raises(RuntimeError, match="holds no block"):
        plane.global_grid(1 << 19, 4, 0)


def test_occupancy_check_prints_caches_and_raises(monkeypatch, capsys):
    """Before a configuration's first launch the wrapper queries the
    resident blocks, prints them with the grid and tiles a block, keeps
    them for later calls, and raises when the card holds none."""
    import ctypes

    from viterbidecodercpp_torch.ops import _build

    answer = {"per_sm": 8}

    class Lib:
        @staticmethod
        def vdt_plane_acs_global_resident(R, sat, per_sm, sms):
            ctypes.cast(per_sm, ctypes.POINTER(ctypes.c_int))[0] = \
                answer["per_sm"]
            ctypes.cast(sms, ctypes.POINTER(ctypes.c_int))[0] = 132
            return 0

    monkeypatch.setattr(_build, "load", lambda name: Lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(plane, "RESIDENT_BLOCKS", {})
    _, ts = _specs(_code(20, 20), "SOFT16", "saturating")
    dev = torch.device("cuda", 0)
    assert plane._check_global(ts, dev, 4) == (256, 1)
    err = capsys.readouterr().err
    assert "8 blocks an SM x 132 SMs = 1056 resident" in err
    assert "256 tiles, grid 256, 1 tiles a block" in err
    assert plane.RESIDENT_BLOCKS == {(0, 20, 2, True): 1056}
    assert plane._check_global(ts, dev, 40) == (640, 4)
    assert capsys.readouterr().err == ""
    answer["per_sm"] = 0
    _, wrap = _specs(_code(20, 20), "SOFT16", "wrapping")
    with pytest.raises(RuntimeError, match="holds no block"):
        plane._check_global(wrap, dev, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("K,R,B,T,arith", [(20, 2, 1, 1, "saturating"),
                                           (23, 2, 3, 5, "wrapping"),
                                           (23, 6, 3, 4, "saturating")])
def test_cuda_global_kernel_one_launch_a_call(cuda_device, K, R, B, T,
                                              arith):
    """One cooperative launch a call, equal to the plain version: K=20
    B=1 T=1, and K=23 B=3 (1536 tiles: more than the card's resident
    blocks, so each block steps several tiles) from near metric_max."""
    jcode = vt.CodeSpec(f"K={K}", K, tuple(
        int(g) for g in np.random.RandomState(K).randint(
            0, 1 << K, R) | 1 | (1 << (K - 1))))
    _, ts = _specs(jcode, "SOFT16", arith)
    m0, syms = _inputs(ts, B, T, "near max" if K > 20 else "reset", seed=K)
    m0 = torch.as_tensor(m0, device=cuda_device)
    sy = torch.as_tensor(syms, device=cuda_device)
    assert plane.acs_kernel(ts) == "plane_acs_global"
    before = trace.counters().get("launches.plane_acs_global", 0)
    got = plane.acs_plane(ts, m0, sy, phase0=K - 3)
    torch.cuda.synchronize()
    assert trace.counters()["launches.plane_acs_global"] == before + 1
    want = plane.acs_plane_ref(ts, m0, sy, phase0=K - 3)
    _equal([g.cpu() for g in got], [w.cpu() for w in want])
    resident = plane.RESIDENT_BLOCKS[(m0.device.index, K, R,
                                      arith == "saturating")]
    grid, per = plane.global_grid(ts.S, B, resident)
    assert grid <= resident
    if K == 23:
        assert per > 1


def test_variants_tool_edits_apply_and_it_needs_a_card():
    """tools/torch_global_variants.py's edits all apply to the kernel's
    source (each once, each a different source), and without a card the
    tool exits 1 naming the card."""
    import importlib.util
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    path = root / "tools" / "torch_global_variants.py"
    spec = importlib.util.spec_from_file_location("torch_global_variants",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (root / "viterbidecodercpp_torch" / "csrc"
           / "plane_acs_global.cu").read_text()
    srcs = tool.variants(src)
    assert set(srcs) == {"this", "strided", "g4", "no_slots", "no_barrier"}
    assert srcs["this"] == src and len(set(srcs.values())) == len(srcs)
    with pytest.raises(SystemExit, match="does not apply"):
        tool.variants(src.replace("grid.sync();", "grid.sync(); "))
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, str(path)], cwd=root,
                              capture_output=True, text=True,
                              env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode == 1
        assert "needs a CUDA card" in proc.stderr
