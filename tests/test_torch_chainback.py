"""Traceback walk of the port (ops/chainback.py) against the JAX
package's Pallas kernel, chainback_pallas.chainback_pallas / walk_rows
(interpret=True).

The walk is defined for any packed words, so most cases feed random
int32 words (bit 31 set in half of them): state order, slot order with
the one-shot schedule, slot order with streamed per-row rotations, and
walk_rows with a per-row valid mask.  The kernel-vs-plain test needs a
card (marked ``cuda``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import viterbidecodercpp_torch as pt
import viterbidecodercpp_tpu as vt
from viterbidecodercpp_torch.ops import chainback, torch_core
from viterbidecodercpp_tpu.ops import chainback_pallas, jax_core


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _specs(name):
    jcode = vt.get_code(name)
    tcode = pt.get_code(name)
    return (jax_core.make_static_spec(
                jcode, vt.get_decode_config(vt.DecodeType.SOFT8, jcode.R)),
            torch_core.make_static_spec(
                tcode, pt.get_decode_config(pt.DecodeType.SOFT8, tcode.R)))


def _words(rng, T, W, B):
    return rng.randint(-(1 << 31), 1 << 31, (T, W, B),
                       dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("name,slot_order,streamed", [
    ("Voyager", False, False), ("Voyager", True, False),
    ("Voyager", True, True), ("CDMA IS-95A", False, False),
    ("CDMA IS-95A", True, False), ("CDMA IS-95A", True, True),
    ("Basic K=5 R=1/2", False, False)])
def test_chainback_matches_pallas(name, slot_order, streamed):
    js, ts = _specs(name)
    n = js.K - 1
    rng = np.random.RandomState(js.K)
    B, total_bits = 3, 2 * n + 5
    T = total_bits + n + 2                 # extra rows are ignored
    packed = _words(rng, T, js.W, B)
    ends = rng.randint(0, js.S, B).astype(np.int32)
    rots = rng.randint(0, n, T).astype(np.int32) if streamed else None
    want = chainback_pallas.chainback_pallas(
        js, jnp.asarray(packed), jnp.asarray(ends), total_bits,
        interpret=True, slot_order=slot_order,
        rots=None if rots is None else jnp.asarray(rots))
    got = chainback.chainback(
        ts, torch.as_tensor(packed), torch.as_tensor(ends), total_bits,
        slot_order=slot_order,
        rots=None if rots is None else torch.as_tensor(rots))
    assert got.dtype == torch.uint8 and got.shape == (B, total_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,slot_order", [("Voyager", True),
                                             ("CDMA 2000", True),
                                             ("Voyager", False)])
def test_walk_rows_with_valid_mask_matches_pallas(name, slot_order):
    js, ts = _specs(name)
    n = js.K - 1
    rng = np.random.RandomState(11)
    B, N = 2, 3 * n + 1
    packed = _words(rng, N, js.W, B)
    start = rng.randint(0, js.S, B).astype(np.int32)
    valid = (rng.rand(N) > 0.3).astype(np.int32)
    rots = rng.randint(0, n, N).astype(np.int32) if slot_order else None
    want = chainback_pallas.walk_rows(
        js, jnp.asarray(packed), jnp.asarray(start), slot_order=slot_order,
        rots=None if rots is None else jnp.asarray(rots),
        valid=jnp.asarray(valid), interpret=True)
    got = chainback.walk_rows(
        ts, torch.as_tensor(packed), torch.as_tensor(start),
        slot_order=slot_order,
        rots=None if rots is None else torch.as_tensor(rots),
        valid=torch.as_tensor(valid))
    assert got.shape == (N, B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the public wrapper and the plain version agree on the CPU
    ref = chainback.walk_rows_ref(
        ts, torch.as_tensor(packed), torch.as_tensor(start),
        slot_order=slot_order,
        rots=None if rots is None else torch.as_tensor(rots),
        valid=torch.as_tensor(valid))
    assert torch.equal(ref, got)


def test_out_of_range_end_state_reads_zero_words():
    """An end state past S (chainback passes it unmasked, as the JAX
    decoder does) selects no word in state order: the bit reads 0."""
    js, ts = _specs("Voyager")
    rng = np.random.RandomState(2)
    packed = _words(rng, 20, js.W, 2)
    ends = np.array([js.S + 5, -3], np.int32)
    want = chainback_pallas.chainback_pallas(
        js, jnp.asarray(packed), jnp.asarray(ends), 14, interpret=True)
    got = chainback.chainback(ts, torch.as_tensor(packed),
                              torch.as_tensor(ends), 14)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_walk_design_by_row_width():
    """The tiled walk takes rows of up to 8 words (the lane path's W=1,
    Voyager's 2, the CDMA codes' 8); wider rows keep the walk that loads
    the one word the state selects."""
    widths = {name: _specs(name)[1].W
              for name in ("Basic K=5 R=1/2", "Voyager", "CDMA 2000")}
    assert widths == {"Basic K=5 R=1/2": 1, "Voyager": 2, "CDMA 2000": 8}
    assert [chainback.walk_design(w) for w in (1, 2, 4, 8, 16, 32, 64, 128)] \
        == ["tiled"] * 4 + ["chain"] * 4
    with pytest.raises(ValueError, match="power of two"):
        chainback.walk_design(3)


def test_bad_walk_inputs_raise():
    _, ts = _specs("Voyager")
    packed = torch.zeros((10, ts.W, 1), dtype=torch.int32)
    ends = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="slot_order"):
        chainback.chainback(ts, packed, ends, 2,
                            rots=torch.zeros(10, dtype=torch.int32))
    with pytest.raises(ValueError, match="shorter"):
        chainback.chainback(ts, packed, ends, 5)
    with pytest.raises(ValueError, match="packed must be"):
        chainback.chainback(ts, packed[:, :1], ends, 2)
    with pytest.raises(ValueError, match="rots must be"):
        chainback.walk_rows(ts, packed, ends, slot_order=True,
                            rots=torch.zeros(4, dtype=torch.int32))
    _, big = _specs("Cassini")
    with pytest.raises(ValueError, match="S <= 4096"):
        chainback.walk_rows(big, torch.zeros((3, big.W, 1),
                                             dtype=torch.int32),
                            ends, slot_order=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Voyager", "CDMA 2000"])
def test_cuda_kernel_matches_plain(cuda_device, name):
    _, ts = _specs(name)
    n = ts.K - 1
    rng = np.random.RandomState(3)
    B, N = 96, 200
    packed = torch.as_tensor(_words(rng, N, ts.W, B), device=cuda_device)
    start = torch.as_tensor(rng.randint(0, ts.S, B).astype(np.int32),
                            device=cuda_device)
    rots = torch.as_tensor(rng.randint(0, n, N).astype(np.int32),
                           device=cuda_device)
    valid = torch.as_tensor((rng.rand(N) > 0.2).astype(np.int32),
                            device=cuda_device)
    before = chainback.LAUNCHES
    for kw in ({}, {"slot_order": True}, {"slot_order": True, "rots": rots},
               {"slot_order": True, "rots": rots, "valid": valid}):
        got = chainback.walk_rows(ts, packed, start, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, chainback.walk_rows_ref(ts, packed, start,
                                                        **kw))
    assert chainback.LAUNCHES == before + 4
