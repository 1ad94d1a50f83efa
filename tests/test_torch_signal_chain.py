"""The port's signal chain against the JAX package's, exactly, on shared
numpy inputs: the byte-stream encoder, puncture masks and depuncturing
(ops/encoder.py), the puncture schedules (puncture.py), the native host
chain (utils/native.py, both packages' builds of native/sigchain.cpp),
and the DAB FIC punctured round trip through the port's decoder.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import viterbidecodercpp_torch as pt
import viterbidecodercpp_tpu as vt
from viterbidecodercpp_torch import puncture
from viterbidecodercpp_torch.ops import encoder
from viterbidecodercpp_torch.utils import native
from viterbidecodercpp_tpu import puncture as jax_puncture
from viterbidecodercpp_tpu.ops import encoder as jax_encoder
from viterbidecodercpp_tpu.utils import native as jax_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_native_lib():
    if not jax_native.ensure_built():
        pytest.fail("the JAX package's native library did not build")
    return jax_native


@pytest.mark.parametrize("name", ["Voyager", "DAB Radio", "Cassini"])
def test_byte_stream_encoder_equals_jax(name):
    data = np.random.RandomState(5).randint(0, 256, 24, dtype=np.uint8)
    se = encoder.ByteStreamEncoder(pt.get_code(name))
    je = jax_encoder.ByteStreamEncoder(vt.get_code(name))
    got = se.consume_bytes(data)
    assert got.dtype == np.uint8 and got.shape == (24, se.R)
    np.testing.assert_array_equal(got, je.consume_bytes(data))
    # reset restarts the register in both
    se.reset()
    je.reset()
    np.testing.assert_array_equal(se.consume_byte(data[3]),
                                  je.consume_byte(data[3]))


@pytest.mark.parametrize("pi,phase", [(15, 0), (7, 3), (-1, 0)])
def test_puncture_mask_and_depuncture_equal_jax(pi, phase):
    spec = pt.DAB_PI_X if pi < 0 else pt.DAB_PI_TABLE[pi]
    jspec = vt.DAB_PI_X if pi < 0 else vt.DAB_PI_TABLE[pi]
    mask = encoder.puncture_mask(spec, 96, phase)
    np.testing.assert_array_equal(mask,
                                  jax_encoder.puncture_mask(jspec, 96, phase))
    kept = np.random.RandomState(6).randint(
        -127, 128, (3, int(mask.sum()))).astype(np.int16)
    got = encoder.depuncture(torch.as_tensor(kept), mask, neutral=-5)
    assert got.dtype == torch.int32 and got.shape == (3, 96)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_encoder.depuncture(jnp.asarray(kept),
                                                       mask, -5)))
    with pytest.raises(ValueError, match="punctured symbols"):
        encoder.depuncture(torch.as_tensor(kept[:, 1:]), mask, 0)
    with pytest.raises(ValueError, match="punctured symbols"):
        jax_encoder.depuncture(jnp.asarray(kept[:, 1:]), mask, 0)


def test_puncture_schedules_equal_jax():
    code, jcode = pt.get_code("DAB Radio"), vt.get_code("DAB Radio")
    for counts in ((21, 3, 32), (2, 5, 8)):
        sched = puncture.dab_fic_schedule(code, *counts)
        jsched = jax_puncture.dab_fic_schedule(jcode, *counts)
        assert [(p.name, p.pattern, n) for p, n in sched] == \
            [(p.name, p.pattern, n) for p, n in jsched]
        mask = puncture.schedule_mask(sched)
        np.testing.assert_array_equal(mask, jax_puncture.schedule_mask(jsched))
        syms = np.arange(2 * mask.size).reshape(2, -1)
        np.testing.assert_array_equal(puncture.puncture_np(syms, mask),
                                      jax_puncture.puncture_np(syms, mask))
    assert puncture.schedule_mask([]).shape == (0,)
    with pytest.raises(ValueError, match="K=7 R=1/4"):
        puncture.dab_fic_schedule(pt.get_code("Voyager"))


@pytest.mark.parametrize("name", ["Voyager", "CDMA 2000", "Cassini"])
def test_native_host_chain_equals_jax(jax_native_lib, name):
    code = pt.get_code(name)
    data = native.random_bytes(11, 3 * 20).reshape(3, 20)
    np.testing.assert_array_equal(data, jax_native_lib.random_bytes(11, 60)
                                  .reshape(3, 20))
    enc = native.NativeEncoder(code.K, code.G)
    jenc = jax_native_lib.NativeEncoder(code.K, code.G)
    for terminate in (True, False):
        np.testing.assert_array_equal(
            enc.encode_bits(data, terminate=terminate),
            jenc.encode_bits(data, terminate=terminate))
        np.testing.assert_array_equal(
            enc.encode_soft(data, 127, -127, terminate=terminate),
            jenc.encode_soft(data, 127, -127, terminate=terminate))
    noisy = enc.encode_awgn_quantize(data, 2.5, 7, -7, seed=9)
    assert noisy.dtype == np.int16
    np.testing.assert_array_equal(
        noisy, jenc.encode_awgn_quantize(data, 2.5, 7, -7, seed=9))
    mask = pt.DAB_PI_TABLE[9].mask(noisy.size)
    kept = native.puncture(noisy, mask)
    np.testing.assert_array_equal(kept, jax_native_lib.puncture(noisy, mask))
    np.testing.assert_array_equal(native.depuncture(kept, mask, 3),
                                  jax_native_lib.depuncture(kept, mask, 3))
    # a short input pads with the neutral value in both
    np.testing.assert_array_equal(
        native.depuncture(kept[:-4], mask, 3),
        jax_native_lib.depuncture(kept[:-4], mask, 3))
    clean = enc.encode_soft(data, 7, -7)
    bits_a, bits_b = enc.encode_bits(data), jenc.encode_bits(data[::-1])
    assert native.count_bit_errors_bytes(data, data[::-1]) == \
        jax_native_lib.count_bit_errors_bytes(data, data[::-1])
    assert native.count_bit_errors_bits(bits_a, bits_b) == \
        jax_native_lib.count_bit_errors_bits(bits_a, bits_b)
    assert native.count_bit_errors_bits(noisy > 0, clean > 0) == \
        jax_native_lib.count_bit_errors_bits(noisy > 0, clean > 0) > 0
    with pytest.raises(ValueError, match="size mismatch"):
        native.count_bit_errors_bytes(data, data[:2])


def test_native_build_failure_raises_with_stderr(tmp_path, monkeypatch):
    """No silent fallback: a source g++ rejects raises, carrying g++'s
    own message."""
    bad = tmp_path / "sigchain.cpp"
    bad.write_text("int vdt_abi_version( { return 1; }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as exc:
        native.ensure_built.__wrapped__()
    assert "error" in str(exc.value)
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("mode", ["SOFT16", "SOFT8", "HARD8"])
def test_dab_fic_punctured_round_trip_cpu(mode):
    """21 x PI_16 + 3 x PI_15 + PI_X over the K=7 R=1/4 mother code,
    punctured, re-inflated with the neutral symbol and decoded by the
    port on the CPU: every data bit back (run_punctured_decoder.cpp)."""
    code = pt.CodeSpec("DAB FIC mother", 7, (109, 79, 83, 109))
    mask = puncture.schedule_mask(puncture.dab_fic_schedule(code))
    nbits = 32 * 24
    assert mask.size == (nbits + code.K - 1) * code.R
    cfg = pt.get_decode_config(pt.DecodeType(mode), code.R)
    data = torch.as_tensor(np.random.RandomState(0).randint(
        0, 256, (2, nbits // 8), dtype=np.uint8))
    bits = encoder.bytes_to_bits(data)
    full = encoder.encode_symbols(code, bits, cfg.soft_decision_high,
                                  cfg.soft_decision_low).reshape(2, -1)
    tx = puncture.puncture_np(full.numpy(), mask)
    rx = encoder.depuncture(torch.as_tensor(tx), mask, neutral=0)
    dec = pt.ViterbiDecoder(code, cfg, traceback_length=nbits, device="cpu")
    out, _, _ = dec.decode(rx, nbits)
    assert torch.equal(out, bits)
    # the same frame through the JAX package's depuncture
    np.testing.assert_array_equal(
        rx.numpy(), np.asarray(jax_encoder.depuncture(jnp.asarray(tx), mask,
                                                      0)))


def test_punctured_decoder_tool_cpu():
    proc = subprocess.run(
        [sys.executable, "tools/torch_run_punctured_decoder.py", "--cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "3/3 passed" in proc.stdout
    assert proc.stdout.count("bit errors 0/768") == 3
