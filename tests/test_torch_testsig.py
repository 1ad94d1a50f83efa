"""The port's signal chain (utils/testsig.py) against the JAX package's.

The deterministic pieces are compared exactly on shared numpy inputs.
The two packages draw their noise from different generators (a
torch.Generator, a jax.random key), so the noisy pieces are compared in
distribution: the AWGN quantiser at 3 dB over 10^5 symbols, in units of
the rail (|mean difference| < 0.05, relative std difference < 2%: each
more than 6 standard errors), and the binary channel's flip rate within
4 standard deviations of its probability.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viterbidecodercpp_torch as pt
import viterbidecodercpp_tpu as vt
from viterbidecodercpp_torch.utils import testsig
from viterbidecodercpp_tpu.utils import testsig as jax_testsig


def _eq(got, want):
    if isinstance(got, torch.Tensor):
        got = got.cpu().numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("ebno,rate", [(4.0, 2), (-1.5, 6), (0.0, 3),
                                       (10.0, 4)])
def test_awgn_sigma_equals_jax(ebno, rate):
    assert testsig.awgn_sigma(ebno, rate) == jax_testsig.awgn_sigma(ebno,
                                                                    rate)
    EsNo = ebno - 10 * math.log10(rate)
    assert testsig.awgn_sigma(ebno, rate) == pytest.approx(
        math.sqrt(10 ** (-(EsNo + 3) / 10)))


def test_round_half_away_from_zero():
    x = np.array([-2.5, -1.5, -0.5, -0.49, 0.0, 0.49, 0.5, 1.5, 2.5],
                 np.float32)
    got = testsig.round_half_away(torch.as_tensor(x))
    _eq(got, [-3.0, -2.0, -1.0, 0.0, 0.0, 0.0, 1.0, 2.0, 3.0])
    _eq(got, jax_testsig.round_half_away(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["Voyager", "Basic K=3 R=1/2", "Cassini"])
@pytest.mark.parametrize("terminate", [True, False])
def test_modulate_encode_equals_jax(name, terminate):
    bits = np.random.RandomState(1).randint(0, 2, (3, 40)).astype(np.uint8)
    got = testsig.modulate_encode(pt.get_code(name), torch.as_tensor(bits),
                                  terminate)
    assert got.dtype == torch.float32
    _eq(got, jax_testsig.modulate_encode(vt.get_code(name),
                                         jnp.asarray(bits), terminate))


def test_clamp_and_count_equal_jax():
    rng = np.random.RandomState(2)
    syms = rng.randint(-200, 201, (4, 50)).astype(np.int32)
    _eq(testsig.clamp_vector(torch.as_tensor(syms), -127, 127),
        jax_testsig.clamp_vector(jnp.asarray(syms), -127, 127))
    a = rng.randint(0, 2, (4, 64)).astype(np.uint8)
    b = rng.randint(0, 2, (4, 64)).astype(np.uint8)
    got = testsig.count_bit_errors(torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(jax_testsig.count_bit_errors(jnp.asarray(a),
                                                        jnp.asarray(b)))


@pytest.mark.parametrize("mode", ["SOFT16", "SOFT8", "HARD8"])
def test_awgn_quantize_equals_jax_at_high_ebno(mode):
    """At 80 dB the noise is below a quantisation step: both packages
    land on the rails exactly, whatever their generators draw."""
    code = pt.get_code("Voyager")
    cfg = pt.get_decode_config(pt.DecodeType(mode), code.R)
    jcfg = vt.get_decode_config(vt.DecodeType(mode), code.R)
    bits = np.random.RandomState(0).randint(0, 2, (2, 32)).astype(np.uint8)
    floats = testsig.modulate_encode(code, torch.as_tensor(bits))
    got = testsig.awgn_quantize(floats, torch.Generator().manual_seed(0),
                                80.0, code.R, cfg)
    want = jax_testsig.awgn_quantize(jnp.asarray(floats.numpy()),
                                     jax.random.PRNGKey(0), 80.0, code.R,
                                     jcfg)
    assert got.dtype == torch.int32
    _eq(got, want)
    # a StaticSpec works too
    spec = pt.ViterbiDecoder(code, cfg, device="cpu").spec
    _eq(testsig.awgn_quantize(floats, torch.Generator().manual_seed(1),
                              80.0, code.R, spec), want)


def test_awgn_quantize_matches_jax_in_distribution():
    code = pt.get_code("Voyager")
    cfg = pt.get_decode_config(pt.DecodeType.SOFT16, code.R)
    jcfg = vt.get_decode_config(vt.DecodeType.SOFT16, code.R)
    n = 100_000
    signs = np.where(np.random.RandomState(3).rand(n) < 0.5, -1.0, 1.0
                     ).astype(np.float32)
    got = testsig.awgn_quantize(torch.as_tensor(signs),
                                torch.Generator().manual_seed(5), 3.0,
                                code.R, cfg).numpy() / 127.0
    want = np.asarray(jax_testsig.awgn_quantize(
        jnp.asarray(signs), jax.random.PRNGKey(5), 3.0, code.R,
        jcfg)) / 127.0
    assert abs(got.mean() - want.mean()) < 0.05
    assert abs(got.std() - want.std()) / want.std() < 0.02
    # and the noise is real: the quantiser left the rails
    assert 0.3 < np.mean(np.abs(got) < 1.0)


def test_add_noise_range():
    syms = torch.full((4, 1000), 100, dtype=torch.int32)
    noisy = testsig.add_noise(syms, torch.Generator().manual_seed(1), 30)
    d = noisy - 100
    assert noisy.dtype == torch.int32
    assert int(d.min()) == -30 and int(d.max()) == 30
    assert float(d.float().std()) > 5


def test_add_binary_noise_flip_rate():
    n, p = 20000, 0.25
    syms = torch.ones((1, n), dtype=torch.int32)
    flipped = testsig.add_binary_noise(syms, torch.Generator().manual_seed(2),
                                       p, -1, 1)
    assert set(flipped.unique().tolist()) == {-1, 1}
    rate = float((flipped == -1).float().mean())
    assert abs(rate - p) < 4 * math.sqrt(p * (1 - p) / n)
    untouched = testsig.add_binary_noise(
        syms, torch.Generator().manual_seed(2), 0.0, -1, 1)
    assert torch.equal(untouched, syms)
