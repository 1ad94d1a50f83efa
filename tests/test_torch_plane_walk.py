"""Plane walks of the port (ops/plane.py) against the JAX package's
(bigstate_pallas, Pallas in interpret mode).

A walk is defined for any packed words, so the cases feed random int32
words (bit 31 set in half of them) in the (B, T, WRr, 128) plane
layout: the frame-major walk with streamed rotations and a valid mask
(with a row count the JAX kernel walks in 8-row slabs and one it walks
whole), the exact chainback over a buffer longer than its rows, the
time-major walk, and the block-parallel truncated walk with its cold
starts - several interior tiles, a single tile, a row count that is not
a multiple of 8 - exactly, bit for bit.  The kernels' group step (G = 5
rows a round trip, csrc/plane_walk_group.cuh) has a plain twin,
``plane._walk_groups``, held to the plain walks and to the JAX kernels.
The kernel-vs-plain test needs a card (marked ``cuda``).
"""

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


def _specs(K=15):
    if K == 15:
        jcode = vt.get_code("Cassini")
    else:
        jcode = vt.CodeSpec(f"K{K}", K, tuple(g | 1 | (1 << (K - 1))
                                              for g in (0o21675, 0o27123)))
    tcode = pt.CodeSpec(jcode.name, jcode.K, jcode.G)
    return (jax_core.make_static_spec(
                jcode, vt.get_decode_config(vt.DecodeType.SOFT16, jcode.R)),
            torch_core.make_static_spec(
                tcode, pt.get_decode_config(pt.DecodeType.SOFT16, tcode.R)))


def _words(rng, B, T, spec):
    return rng.randint(-(1 << 31), 1 << 31, (B, T, spec.S // 4096, 128),
                       dtype=np.int64).astype(np.int32)


# rows a group of the walk kernels (kGroup in csrc/plane_walk_group.cuh)
G = 5


def _edge_valid(rng, T):
    """A valid mask with zeros at every group's top row and at random."""
    valid = (rng.rand(T) > 0.3).astype(np.int32)
    valid[T - 1::-G] = 0
    return valid


def _twin(spec, packed, start, rots=None, valid=None):
    """The exact walk of every row on the group twin."""
    N = packed.shape[1]
    return plane._walk_groups(spec, packed, start[:, None],
                              torch.tensor([0]), torch.tensor([N]), rots,
                              valid, G)[:, 0]


@pytest.mark.parametrize("K,N", [(15, 24), (14, 19)])
def test_walk_plane_frames_matches_pallas(K, N):
    js, ts = _specs(K)
    n = js.K - 1
    rng = np.random.RandomState(N)
    B = 3
    packed = _words(rng, B, N, js)
    start = rng.randint(0, js.S, B).astype(np.int32)
    rots = rng.randint(0, n, N).astype(np.int32)
    valid = (rng.rand(N) > 0.3).astype(np.int32)
    want = bigstate_pallas.walk_plane_frames(
        js, jnp.asarray(packed), jnp.asarray(start), rots=jnp.asarray(rots),
        valid=jnp.asarray(valid), interpret=True)
    args = (ts, torch.as_tensor(packed), torch.as_tensor(start))
    kw = {"rots": torch.as_tensor(rots), "valid": torch.as_tensor(valid)}
    got = plane.walk_plane_frames(*args, **kw)
    assert got.dtype == torch.uint8 and got.shape == (B, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(plane.walk_plane_frames_ref(*args, **kw), got)
    assert torch.equal(_twin(*args, **kw), got)
    # the time-major walk (an XLA scan in JAX) reads the same rows
    rows = np.transpose(packed, (1, 2, 3, 0))
    tm = plane.walk_plane(ts, torch.as_tensor(rows), torch.as_tensor(start),
                          rots=rots, valid=valid)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        plane.walk_plane(ts, torch.as_tensor(rows),
                         torch.as_tensor(start)).numpy(),
        np.asarray(bigstate_pallas.walk_plane(js, jnp.asarray(rows),
                                              jnp.asarray(start))))


def test_chainback_plane_matches_pallas():
    """The port walks rows [0, total_bits + n); JAX walks the whole
    buffer with the later rows invalid: the same bits."""
    js, ts = _specs()
    n = js.K - 1
    rng = np.random.RandomState(4)
    B, total_bits, T_phys = 2, 10, 30
    packed = _words(rng, B, T_phys, js)
    ends = np.array([0, 9999], np.int32)
    rots = rng.randint(0, n, T_phys).astype(np.int32)
    for r in (None, rots):
        want = bigstate_pallas.chainback_plane(
            js, jnp.asarray(packed), jnp.asarray(ends), total_bits,
            None if r is None else jnp.asarray(r))
        got = plane.chainback_plane(
            ts, torch.as_tensor(packed), torch.as_tensor(ends), total_bits,
            None if r is None else torch.as_tensor(r))
        assert got.shape == (B, total_bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_truncated_walk_matches_pallas_with_interior_tiles():
    """block=64, overlap=96 over 297 rows: five tiles, two of them cold
    starts from state 0 whose committed bits are a truncated walk's, not
    the exact walk's - reproduced bit for bit, with streamed rots."""
    js, ts = _specs()
    n = js.K - 1
    rng = np.random.RandomState(9)
    B, total_bits, T_phys = 2, 283, 300
    packed = _words(rng, B, T_phys, js)
    ends = rng.randint(0, js.S, B).astype(np.int32)
    rots = rng.randint(0, n, T_phys).astype(np.int32)
    want = np.asarray(bigstate_pallas.chainback_plane_truncated(
        js, jnp.asarray(packed), jnp.asarray(ends), total_bits,
        jnp.asarray(rots), 64, 96))
    args = (ts, torch.as_tensor(packed), torch.as_tensor(ends), total_bits,
            torch.as_tensor(rots), 64, 96)
    got = plane.chainback_plane_truncated(*args)
    assert got.dtype == torch.uint8 and got.shape == (B, total_bits)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(plane.chainback_plane_truncated_ref(*args), got)
    assert torch.equal(plane._trunc_groups(*args, G), got)
    # random words have no survivor structure: the cold tiles differ
    exact = plane.chainback_plane(ts, *args[1:5])
    assert not torch.equal(exact, got)


@pytest.mark.parametrize("T_phys,block,overlap", [(56, 56, 8),
                                                  (37, 16, 48)])
def test_truncated_walk_single_block_and_unaligned_match_pallas(
        T_phys, block, overlap):
    """Every tile's window reaches the last row (a single block, or an
    overlap past the end), so the truncated walk is the exact one; the
    37-row buffer is not a multiple of 8 rows."""
    js, ts = _specs(14)
    rng = np.random.RandomState(T_phys)
    B, total_bits = 3, 23
    packed = _words(rng, B, T_phys, js)
    ends = rng.randint(0, js.S, B).astype(np.int32)
    want = np.asarray(bigstate_pallas.chainback_plane_truncated(
        js, jnp.asarray(packed), jnp.asarray(ends), total_bits, None,
        block, overlap))
    got = plane.chainback_plane_truncated(
        ts, torch.as_tensor(packed), torch.as_tensor(ends), total_bits,
        None, block, overlap)
    np.testing.assert_array_equal(got.numpy(), want)
    exact = plane.chainback_plane(ts, torch.as_tensor(packed),
                                  torch.as_tensor(ends), total_bits)
    assert torch.equal(got, exact)
    assert torch.equal(plane._trunc_groups(
        ts, torch.as_tensor(packed), torch.as_tensor(ends), total_bits,
        None, block, overlap, G), got)


@pytest.mark.parametrize("K", [14, 15])
@pytest.mark.parametrize("N", [1, 4, 5, 6, 24])
def test_group_twin_matches_plain_walk(K, N):
    """The group step for a chain shorter than, equal to and just past a
    group (the last group holds fewer rows), with and without rots, and
    with a valid mask whose zeros sit on group edges."""
    _, ts = _specs(K)
    n = ts.K - 1
    rng = np.random.RandomState(100 * K + N)
    B = 3
    packed = torch.as_tensor(_words(rng, B, N, ts))
    start = torch.as_tensor(rng.randint(0, ts.S, B).astype(np.int32))
    rots = torch.as_tensor(rng.randint(0, n, N).astype(np.int32))
    valid = torch.as_tensor(_edge_valid(rng, N))
    for kw in ({}, {"rots": rots}, {"rots": rots, "valid": valid},
               {"valid": valid}):
        want = plane._walk_plain(ts, packed, start, N, kw.get("rots"),
                                 kw.get("valid"))
        assert torch.equal(_twin(ts, packed, start, **kw), want), sorted(kw)


@pytest.mark.parametrize("T_phys,block,overlap,total_bits", [
    (300, 64, 96, 283), (37, 16, 48, 23), (40, 8, 0, 26)])
def test_group_twin_matches_plain_truncated_walk(T_phys, block, overlap,
                                                 total_bits):
    """The truncated walk's tiles on the group step: interior cold starts
    (64/96), an overlap past the end over 37 rows (16/48), no overlap."""
    _, ts = _specs(15)
    n = ts.K - 1
    rng = np.random.RandomState(T_phys + block)
    B = 2
    packed = torch.as_tensor(_words(rng, B, T_phys, ts))
    ends = torch.as_tensor(rng.randint(0, ts.S, B).astype(np.int32))
    rots = torch.as_tensor(rng.randint(0, n, T_phys).astype(np.int32))
    for r in (None, rots):
        want = plane.chainback_plane_truncated(ts, packed, ends, total_bits,
                                               r, block, overlap)
        assert torch.equal(plane._trunc_groups(
            ts, packed, ends, total_bits, r, block, overlap, G), want)


def test_build_key_covers_the_headers(tmp_path, monkeypatch):
    """A source's build key changes when only a header in csrc/ does, so
    an edited header rebuilds every kernel (no nvcc is run)."""
    from viterbidecodercpp_torch.ops import _build
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "walk.cu").write_text('#include "step.cuh"\n')
    header = tmp_path / "step.cuh"
    header.write_text("// step, first version\n")
    first = _build.digest("walk")
    assert _build.digest("walk") == first
    header.write_text("// step, second version\n")
    second = _build.digest("walk")
    assert second != first
    (tmp_path / "walk.cu").write_text('#include "step.cuh" // edited\n')
    assert _build.digest("walk") != second


def test_bad_walk_inputs_raise():
    js, ts = _specs()
    packed = torch.zeros((1, 30, 4, 128), dtype=torch.int32)
    ends = torch.zeros(1, dtype=torch.int32)
    for blk, ov in ((60, 8), (64, 12), (0, 8)):
        with pytest.raises(ValueError, match="multiples of 8"):
            plane.chainback_plane_truncated(ts, packed, ends, 10, None, blk,
                                            ov)
    with pytest.raises(ValueError, match="decision history"):
        plane.chainback_plane_truncated(ts, packed, ends, 17)
    with pytest.raises(ValueError, match="decision history"):
        plane.chainback_plane(ts, packed, ends, 17)
    with pytest.raises(ValueError, match="packed must be"):
        plane.walk_plane_frames(ts, packed[:, :, :2], ends)
    with pytest.raises(ValueError, match="start state"):
        plane.walk_plane_frames(ts, packed, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="rots must be"):
        plane.walk_plane_frames(ts, packed, ends,
                                rots=torch.zeros(5, dtype=torch.int32))
    # the JAX errors this mirrors
    with pytest.raises(ValueError, match="multiples of 8"):
        bigstate_pallas.chainback_plane_truncated(
            js, jnp.asarray(packed.numpy()), jnp.asarray(ends.numpy()), 10,
            None, 60, 8)
    with pytest.raises(ValueError, match="decision history"):
        bigstate_pallas.chainback_plane_truncated(
            js, jnp.asarray(packed.numpy()), jnp.asarray(ends.numpy()), 17)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [14, 15, 16, 17])
def test_cuda_walk_kernels_match_plain(cuda_device, K):
    """Both walk kernels against their plain versions: B=40, one frame and
    B=33 (a partial block of warps), chains of 1, G-1, G, G+1, 24 and 310
    rows, a valid mask with zeros on group edges, and the truncated walk's
    interior tiles (64/96), an unaligned 37-row buffer (16/48) and its
    defaults."""
    _, ts = _specs(K)
    n = ts.K - 1
    rng = np.random.RandomState(K)
    B, T_phys, total_bits = 40, 310, 290
    packed = torch.as_tensor(_words(rng, B, T_phys, ts), device=cuda_device)
    start = torch.as_tensor(rng.randint(0, ts.S, B).astype(np.int32),
                            device=cuda_device)
    rots = torch.as_tensor(rng.randint(0, n, T_phys).astype(np.int32),
                           device=cuda_device)
    valid = torch.as_tensor(_edge_valid(rng, T_phys), device=cuda_device)
    walks = trace.counters()
    calls = 0
    for Bs in (B, 1, 33):
        for N in (1, G - 1, G, G + 1, 24, T_phys):
            pk = packed[:Bs, :N].contiguous()
            st = start[:Bs].contiguous()
            for kw in ({}, {"rots": rots}, {"rots": rots, "valid": valid},
                       {"valid": valid[T_phys - N:]}):
                got = plane.walk_plane_frames(ts, pk, st, **kw)
                torch.cuda.synchronize()
                calls += 1
                assert torch.equal(got, plane.walk_plane_frames_ref(
                    ts, pk, st, **kw)), (Bs, N, sorted(kw))
    # the exact chainback walks a window of a longer buffer in place
    got = plane.chainback_plane(ts, packed, start, total_bits - 7, rots)
    torch.cuda.synchronize()
    calls += 1
    assert torch.equal(got, plane.walk_plane_frames_ref(
        ts, packed[:, :total_bits - 7 + n].contiguous(), start,
        rots=rots)[:, n:])
    trunc = 0
    for pk, st, tb, blk, ov in ((packed, start, total_bits, 64, 96),
                                (packed[:33], start[:33], total_bits, 64, 96),
                                (packed[:1, :37], start[:1], 37 - n, 16, 48),
                                (packed, start, total_bits, 512, 128)):
        pk = pk.contiguous()
        st = st.contiguous()
        for r in (None, rots):
            got = plane.chainback_plane_truncated(ts, pk, st, tb, r, blk, ov)
            torch.cuda.synchronize()
            trunc += 1
            assert torch.equal(got, plane.chainback_plane_truncated_ref(
                ts, pk, st, tb, r, blk, ov)), (pk.shape, blk, ov)
    counts = trace.counters()
    assert counts["launches.plane_walk"] == \
        walks.get("launches.plane_walk", 0) + calls
    assert counts["launches.plane_walk_trunc"] == \
        walks.get("launches.plane_walk_trunc", 0) + trunc
