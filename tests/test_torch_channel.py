"""The BER batch's one-pass channel (ops/channel.py, utils/testsig.py
encode_awgn_quantize) against the plain chain
``testsig.awgn_quantize(testsig.modulate_encode(...))``.

Bit for bit on the int32 symbols, with the generator left in the same
state: on the CPU the route through ``testsig.encode_awgn_quantize`` and
``ber.draw_batch``, and the kernel's plain twin
``testsig.quantise(testsig.modulate_encode(...), noise, ...)`` fed as the
card's route feeds the kernel (its ``(B, T, R)`` draw and
``testsig.channel_scalars``); on the card (marked ``cuda``, skipped
without one) the CUDA kernel, at small shapes and at the BER cell's
B=16384 x 2048 bits, and its launch count a batch.  The plain
chain is the port's own, which the JAX-parity tests hold; this file does
not import the JAX package, so that its card tests run where JAX is not
installed.
"""

import numpy as np
import pytest
import torch

import viterbidecodercpp_torch as pt
from viterbidecodercpp_torch import ber, trace
from viterbidecodercpp_torch.ops import channel
from viterbidecodercpp_torch.utils import testsig

CODES = ["Voyager", "LTE", "CDMA 2000", "Cassini"]
MODES = ["SOFT8", "SOFT16", "HARD8"]
EBNOS = [0.0, 3.0, 60.0]
NS = [1, 7, 64, 2047]
B = 3
# random codes at the register's edges: K=2, a word's last bit (K=32)
RANDOM_K = [2, 3, 17, 31, 32]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _config(mode, code):
    return pt.get_decode_config(pt.DecodeType(mode), code.R)


def _random_code(K, seed=0, R=3):
    rng = np.random.RandomState(seed + K)
    G = tuple(int(rng.randint(0, 1 << K)) | 1 | (1 << (K - 1))
              for _ in range(R))
    return pt.CodeSpec(f"random K={K}", K, G)


def _bits(b, n, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed + n)
    return torch.randint(0, 2, (b, n), generator=g, dtype=torch.uint8,
                         device=device)


def _gens(seed, device="cpu"):
    return [torch.Generator(device=device).manual_seed(seed)
            for _ in range(2)]


def _plain(code, bits, gen, ebno, cfg):
    return testsig.awgn_quantize(testsig.modulate_encode(code, bits), gen,
                                 ebno, code.R, cfg)


def _plain_twin(code, bits, noise, sigma, scale, mean, low, high):
    """The kernel's plain version (ops/channel.py's contract)."""
    return testsig.quantise(testsig.modulate_encode(code, bits), noise,
                            sigma, scale, mean, low, high)


def _twin(code, bits, gen, ebno, cfg, fn=_plain_twin):
    """The twin (or the kernel) fed as the CUDA route feeds the kernel."""
    high, low = cfg.soft_decision_high, cfg.soft_decision_low
    n, k = bits.shape[1], code.K
    noise = torch.randn((bits.shape[0], n + k - 1, code.R), generator=gen,
                        dtype=torch.float32, device=bits.device)
    scalars = testsig.channel_scalars(ebno, code.R, cfg, bits.device)
    return fn(code, bits, noise, *scalars, low, high)


def _same(got, want, g_got, g_want):
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(g_got.get_state(), g_want.get_state())


@pytest.mark.parametrize("ebno", EBNOS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CODES)
def test_route_equals_plain_chain(name, mode, ebno):
    code = pt.get_code(name)
    cfg = _config(mode, code)
    for n in NS:
        g1, g2 = _gens(n)
        bits = _bits(B, n)
        _same(testsig.encode_awgn_quantize(code, bits, g1, ebno, cfg),
              _plain(code, bits, g2, ebno, cfg), g1, g2)


@pytest.mark.parametrize("ebno", EBNOS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CODES)
def test_twin_equals_plain_chain(name, mode, ebno):
    code = pt.get_code(name)
    cfg = _config(mode, code)
    for n in NS:
        g1, g2 = _gens(100 + n)
        bits = _bits(B, n)
        _same(_twin(code, bits, g1, ebno, cfg),
              _plain(code, bits, g2, ebno, cfg), g1, g2)


@pytest.mark.parametrize("K", RANDOM_K)
def test_twin_equals_plain_chain_random_codes(K):
    code = _random_code(K)
    cfg = _config("SOFT16", code)
    for n in (1, 40):
        g1, g2 = _gens(K)
        bits = _bits(5, n)
        _same(_twin(code, bits, g1, 1.5, cfg),
              _plain(code, bits, g2, 1.5, cfg), g1, g2)


def _halfway(code, bits, device):
    """Noise that puts y = (s + n) * 1 + 0 on every half-integer and its
    neighbours: the rounding's ties, both signs, past the soft range."""
    n = bits.shape[1] + code.K - 1
    vals = torch.tensor([-4.5, -3.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5,
                         -0.49999997, 0.49999997, 0.0, -0.0, 1e-30],
                        dtype=torch.float32)
    noise = vals[torch.arange(bits.shape[0] * n * code.R) % len(vals)]
    noise = noise.reshape(bits.shape[0], n, code.R).to(device)
    one = torch.ones((), dtype=torch.float32, device=device)
    return noise, one, one, torch.zeros((), dtype=torch.float32,
                                        device=device)


def _halfway_plain(code, bits, noise, sigma, scale, mean, low, high):
    """The quantiser of y = (s + n) * 1 + 0 in numpy float32, each
    operation rounded on its own: halves away from zero as the chain
    rounds them (floor(y + 0.5) above 0, ceil(y - 0.5) below), clamped."""
    half = np.float32(0.5)
    s = testsig.modulate_encode(code, bits.cpu()).numpy()
    y = s + noise.cpu().numpy()
    q = np.where(y >= 0, np.floor(y + half), np.ceil(y - half))
    assert y.dtype == q.dtype == np.float32
    return torch.as_tensor(np.clip(q, low, high).astype(np.int32),
                           device=noise.device)


def test_twin_rounds_ties_as_the_chain():
    code = pt.get_code("Voyager")
    bits = _bits(2, 33)
    args = _halfway(code, bits, "cpu") + (-3, 3)
    got = _plain_twin(code, bits, *args)
    assert torch.equal(got, _halfway_plain(code, bits, *args))


def test_draw_batch_draws_as_the_plain_chain():
    code = pt.get_code("Voyager")
    cfg = _config("SOFT8", code)
    g1, g2 = _gens(7)
    syms, tx = ber.draw_batch(code, cfg, 2.0, g1, 4, 50)
    want_tx = torch.randint(0, 2, (4, 50), generator=g2, dtype=torch.uint8)
    assert tx.dtype == torch.uint8 and torch.equal(tx, want_tx)
    assert syms.shape == (4, 50 + code.K - 1, code.R)
    _same(syms, _plain(code, want_tx, g2, 2.0, cfg), g1, g2)


def _bad_inputs():
    code = pt.get_code("Voyager")
    bits = _bits(2, 10)
    noise = torch.zeros(2, 16, 2)
    return {
        "K=33": (_random_code(33, R=2), bits, torch.zeros(2, 42, 2)),
        "noise shape": (code, bits, torch.zeros(2, 15, 2)),
        "noise dtype": (code, bits, noise.double()),
        "bits dtype": (code, bits.to(torch.int32), noise),
        "bits not contiguous": (code, _bits(10, 2).t(), noise),
        "noise misaligned": (code, bits,
                             torch.zeros(2 * 16 * 2 + 1)[1:].reshape(2, 16,
                                                                     2)),
        "empty batch": (code, bits[:0], noise[:0]),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_kernel_check_refuses(case):
    code, bits, noise = _bad_inputs()[case]
    with pytest.raises(ValueError):
        channel.kernel_check(code, bits, noise)


def test_kernel_check_takes_the_cell_layout():
    code = _random_code(32, R=2)
    channel.kernel_check(code, _bits(2, 10), torch.zeros(2, 41, 2))


# -- on the card ---------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("ebno", EBNOS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CODES)
def test_card_kernel_equals_plain_chain(cuda_device, name, mode, ebno):
    code = pt.get_code(name)
    cfg = _config(mode, code)
    for b in (B, 37):
        for n in NS:
            g1, g2 = _gens(n + b, cuda_device)
            bits = _bits(b, n, cuda_device)
            got = testsig.encode_awgn_quantize(code, bits, g1, ebno, cfg)
            torch.cuda.synchronize()
            _same(got, _plain(code, bits, g2, ebno, cfg), g1, g2)


@pytest.mark.cuda
@pytest.mark.parametrize("K", RANDOM_K)
def test_card_kernel_random_codes(cuda_device, K):
    code = _random_code(K)
    cfg = _config("SOFT16", code)
    for n in (1, 40, 301):
        g1, g2 = _gens(K + n, cuda_device)
        bits = _bits(5, n, cuda_device)
        got = _twin(code, bits, g1, 1.5, cfg, channel.encode_awgn_quantize)
        torch.cuda.synchronize()
        _same(got, _plain(code, bits, g2, 1.5, cfg), g1, g2)


@pytest.mark.cuda
def test_card_kernel_rounds_ties_as_the_chain(cuda_device):
    code = pt.get_code("Voyager")
    bits = _bits(2, 33, cuda_device)
    args = _halfway(code, bits, cuda_device) + (-3, 3)
    got = channel.encode_awgn_quantize(code, bits, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, _halfway_plain(code, bits, *args))
    assert torch.equal(got, _plain_twin(code, bits, *args))


@pytest.mark.cuda
def test_card_kernel_at_the_cell_shape(cuda_device):
    code = pt.get_code("Voyager")
    cfg = _config("SOFT8", code)
    g1, g2 = _gens(2_600_500_003, cuda_device)
    syms, tx = ber.draw_batch(code, cfg, 6.0, g1, 16384, 2048)
    torch.cuda.synchronize()
    want_tx = torch.randint(0, 2, (16384, 2048), generator=g2,
                            dtype=torch.uint8, device=cuda_device)
    assert torch.equal(tx, want_tx)
    _same(syms, _plain(code, want_tx, g2, 6.0, cfg), g1, g2)


@pytest.mark.cuda
def test_card_one_launch_a_batch(cuda_device):
    code = pt.get_code("Voyager")
    cfg = _config("SOFT8", code)
    batch, block, batches = 64, 256, 5
    gen = ber.point_generator(3, 0, cuda_device)
    before = trace.counters().get("launches.awgn_channel", 0)
    p = ber.measure_point(code, cfg, 6.0, generator=gen, block_bits=block,
                          batch=batch, max_bits=batches * batch * block,
                          max_errors=1 << 30, device=gen.device)
    torch.cuda.synchronize()
    assert p.total_bits == batches * batch * block
    assert trace.counters()["launches.awgn_channel"] - before == batches
