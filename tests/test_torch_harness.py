"""The port's correctness harness against the JAX package, on the CPU.

``viterbidecodercpp_torch/ops/numpy_ref.py`` is a copy of the JAX
package's oracle: every public function must give the same arrays for
the 8 registry codes x SOFT16/SOFT8/HARD8 x saturating/wrapping.  The
harness tools (``tools/torch_run_simple.py``, ``torch_run_tests.py``,
``torch_run_streaming.py``, ``torch_ber_truncated_delta.py``) must pass
with ``--cpu`` at small shapes, and the truncated-delta tool's check
against the plain versions must catch a wrong kernel.  Every comparison
is exact (tolerance 0).  The measurement tools run with ``--cpu`` too:
``torch_run_benchmark.py``'s rows are read by the unmodified
``parse_benchmark.py`` and ``compare_benchmark.py``,
``torch_profile_trace.py`` writes a Chrome trace, and
``torch_ci_check.sh`` parses as a POSIX shell script.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import viterbidecodercpp_torch as pt  # noqa: E402
import viterbidecodercpp_tpu as vt  # noqa: E402
from tools import (torch_ber_truncated_delta,  # noqa: E402
                   torch_profile_trace, torch_run_benchmark,
                   torch_run_simple, torch_run_streaming, torch_run_tests)
from viterbidecodercpp_torch.ops import numpy_ref as port_ref  # noqa: E402
from viterbidecodercpp_tpu.ops import numpy_ref as jax_ref  # noqa: E402

MODES = ["SOFT16", "SOFT8", "HARD8"]
ARITHS = ["saturating", "wrapping"]
CODE_NAMES = [c.name for c in vt.COMMON_CODES]


def test_numpy_ref_public_names():
    assert port_ref.__all__ == jax_ref.__all__


@pytest.mark.parametrize("arith", ARITHS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CODE_NAMES)
def test_numpy_ref_equals_the_jax_oracle(name, mode, arith):
    """Every ``__all__`` function of the copy against the JAX module's on
    the same seeded inputs: noisy symbols, off-reset metrics, another
    start and end state."""
    pc, jc = pt.get_code(name), vt.get_code(name)
    pcfg = pt.get_decode_config(pt.DecodeType(mode), pc.R, arith=arith)
    jcfg = vt.get_decode_config(vt.DecodeType(mode), jc.R, arith=arith)
    rng = np.random.RandomState(CODE_NAMES.index(name) * 6
                                + MODES.index(mode) * 2
                                + ARITHS.index(arith))
    nbytes = 2 if pc.K >= 14 else 6
    data = rng.randint(0, 256, nbytes, dtype=np.uint8)
    bits = port_ref.bytes_to_bits(data)
    np.testing.assert_array_equal(bits, jax_ref.bytes_to_bits(data))
    np.testing.assert_array_equal(port_ref.bits_to_bytes(bits),
                                  jax_ref.bits_to_bytes(bits))
    for terminate in (True, False):
        np.testing.assert_array_equal(
            port_ref.encode_bits(pc, bits, terminate=terminate,
                                 initial_state=5),
            jax_ref.encode_bits(jc, bits, terminate=terminate,
                                initial_state=5))
    hi, lo = pcfg.soft_decision_high, pcfg.soft_decision_low
    syms = port_ref.encode_bytes(pc, data, hi, lo)
    np.testing.assert_array_equal(syms, jax_ref.encode_bytes(jc, data, hi,
                                                             lo))
    noisy = np.clip(syms + rng.randint(-hi, hi + 1, syms.shape), lo, hi)
    m0 = rng.randint(0, pcfg.renormalisation_threshold, pc.num_states)
    for kwargs in ({}, {"starting_state": 3}, {"initial_metrics": m0}):
        pm, pd, pa = port_ref.acs_run(pc, pcfg, noisy, **kwargs)
        jm, jd, ja = jax_ref.acs_run(jc, jcfg, noisy, **kwargs)
        np.testing.assert_array_equal(pm, jm)
        np.testing.assert_array_equal(pd, jd)
        assert pa == ja
    nbits = bits.size
    for end in (0, 1):
        np.testing.assert_array_equal(
            port_ref.traceback(pc, pd, nbits, end),
            jax_ref.traceback(jc, jd, nbits, end))
        pb, pe, pacc = port_ref.viterbi_decode(pc, pcfg, noisy, nbits,
                                               end_state=end)
        jb, je, jacc = jax_ref.viterbi_decode(jc, jcfg, noisy, nbits,
                                              end_state=end)
        np.testing.assert_array_equal(pb, jb)
        assert (pe, pacc) == (je, jacc)
    # the noiseless frame decodes to the data
    got, _, _ = port_ref.viterbi_decode(pc, pcfg, syms, nbits)
    np.testing.assert_array_equal(got, bits)


def test_run_tests_cpu_passes(capsys):
    """The whole matrix on the plain scan: 47 of 47, the reference's one
    skip (wrapping SOFT8 Cassini)."""
    assert torch_run_tests.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert "47/47 passed, 1 skipped" in out
    assert "FAIL" not in out
    assert out.count("SKIP") == 1 and "Cassini" in out.split("SKIP")[1]


def test_run_simple_cpu_is_exact(capsys):
    assert torch_run_simple.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert "backend=rotated" in out
    assert "bit errors: 0" in out
    assert "accumulated renorm error: 0" in out


def test_run_streaming_voyager_cpu_is_exact(capsys):
    assert torch_run_streaming.main(["--code", "voyager", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "backend=rotated: 0 bit errors" in out


def test_ber_truncated_delta_cpu(capsys):
    """Cassini on the plane route at a small size, the walk split into
    32-row tiles with a 48-row warm-up (so the truncated walk is really
    truncated), at 2 dB; the first batch held to the plain versions."""
    args = ["--cpu", "--bits", "256", "--batch", "2", "--block-bits", "128",
            "--block", "32", "--overlap", "48", "--ebno", "2.0"]
    assert torch_ber_truncated_delta.main(args) == 0
    out = capsys.readouterr().out
    for line in ("[trunc-delta] BER exact", "[trunc-delta] BER truncated",
                 "[trunc-delta] delta", "disagreement", "[trunc-delta] PASS",
                 "batch 1: plane ACS, exact and truncated walk equal to "
                 "their plain versions"):
        assert line in out
    with pytest.raises(ValueError, match="plane"):
        torch_ber_truncated_delta.measure("cpu", code="Voyager", bits=8,
                                          batch=1, block_bits=8)


def _flip_first(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x.view(-1)[0] ^= 1
    return x


@pytest.mark.parametrize("kernel,what", [
    ("acs_plane", "plane ACS metrics"),
    ("chainback_plane", "exact plane walk bits"),
    ("chainback_plane_truncated", "truncated plane walk bits")])
def test_ber_truncated_delta_plain_check_catches_a_wrong_kernel(
        monkeypatch, kernel, what):
    """A kernel wrapper that flips one value passes the statistical
    verdict but not the plain-version check."""
    from viterbidecodercpp_torch.ops import plane
    fn = getattr(plane, kernel)

    def wrong(*args, **kwargs):
        out = fn(*args, **kwargs)
        if kernel == "acs_plane":
            return (_flip_first(out[0]),) + tuple(out[1:])
        return _flip_first(out)

    monkeypatch.setattr(plane, kernel, wrong)
    with pytest.raises(torch_ber_truncated_delta.PlainMismatch, match=what):
        torch_ber_truncated_delta.measure(
            "cpu", bits=128, batch=1, block_bits=128, block=32, overlap=48,
            ebno=2.0)


def test_run_benchmark_cpu_rows_read_by_parse_and_compare(tmp_path):
    """Basic K=3 SOFT8 on the lane route's plain version and the plain
    scan, at a tiny size: the rows keep the reference schema, and the
    JAX package's parse_benchmark.py and compare_benchmark.py read them
    unmodified (exit 0, one line a row)."""
    out = tmp_path / "bench.json"
    assert torch_run_benchmark.main(["--cpu", "-c", "0", "-d", "soft8",
                                     "-B", "2", "-M", "2", "-T", "0.01",
                                     "-o", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [r["simd_type"] for r in rows] == ["LANE", "TORCH"]
    for r in rows:
        assert r["name"] == "Basic K=3 R=1/2" and r["decode_type"] == "SOFT8"
        assert (r["K"], r["R"], r["batch"], r["device"]) == (3, 2, 2, "cpu")
        assert r["total_input_bits"] == 2 * 16
        assert r["total_symbols"] == 2 * (16 + 2) * 2
        assert r["update_symbols_ns"] and r["chainback_bits_ns"]
        assert min(r["update_symbols_ns"] + r["chainback_bits_ns"]) >= 1
    for tool in ("parse_benchmark.py", "compare_benchmark.py"):
        proc = subprocess.run(
            [sys.executable, os.path.join("tools", tool), str(out)],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("Basic K=3")]
        assert len(lines) == 2 and "LANE" in lines[0] \
            and "TORCH" in lines[1]


@pytest.mark.parametrize("busy_us,window_us,share",
                         [(300.0, 1000.0, 0.7), (0.0, 5.0, 1.0),
                          (1209.2, 1000.0, None)])
def test_profile_trace_idle_share_stays_in_0_1(busy_us, window_us, share):
    """A window that counted more kernel time than it lasted (idle share
    below 0) raises instead of printing a share."""
    if share is None:
        with pytest.raises(RuntimeError, match="outside"):
            torch_profile_trace.idle_share(busy_us, window_us)
    else:
        assert torch_profile_trace.idle_share(busy_us, window_us) == \
            pytest.approx(share)


def test_profile_trace_cpu_writes_a_trace(tmp_path, capsys):
    """Two Voyager decodes at B=2 x 32 steps on the CPU: a Chrome trace
    with events, the top operations, and no device share claimed."""
    assert torch_profile_trace.main([str(tmp_path), "2", "voyager", "--cpu",
                                     "-B", "2", "-T", "32"]) == 0
    out = capsys.readouterr().out
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    assert "rotated route" in out and "top CPU operations" in out
    assert "device idle share: not measured" in out


def test_ci_check_script_parses():
    proc = subprocess.run(["sh", "-n", os.path.join("tools",
                                                    "torch_ci_check.sh")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
