"""Spec layer of the PyTorch port against the JAX package.

The port copies codes.py and config.py (NumPy only) and mirrors
jax_core's StaticSpec, so every constant the kernels are built from must
equal the JAX package's: all 8 registry codes x SOFT16/SOFT8/HARD8 x
saturating/wrapping, field by field, branch tables included.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import viterbidecodercpp_torch as pt
import viterbidecodercpp_tpu as vt
from viterbidecodercpp_torch.ops import torch_core
from viterbidecodercpp_tpu.ops import jax_core

MODES = ["SOFT16", "SOFT8", "HARD8"]
ARITHS = ["saturating", "wrapping"]
CODE_NAMES = [c.name for c in vt.COMMON_CODES]


def _specs(name, mode, arith):
    jc = vt.get_code(name)
    tc = pt.get_code(name)
    jcfg = vt.get_decode_config(vt.DecodeType(mode), jc.R, arith=arith)
    tcfg = pt.get_decode_config(pt.DecodeType(mode), tc.R, arith=arith)
    return (jax_core.make_static_spec(jc, jcfg),
            torch_core.make_static_spec(tc, tcfg))


@pytest.mark.parametrize("arith", ARITHS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CODE_NAMES)
def test_static_spec_and_initial_metrics(name, mode, arith):
    js, ts = _specs(name, mode, arith)
    assert type(ts).__name__ == "StaticSpec"
    assert ts._fields == js._fields
    for field in js._fields:
        assert getattr(ts, field) == getattr(js, field), field
    assert torch_core.symmetric_amplitude(ts) == \
        jax_core.symmetric_amplitude(js)
    assert torch_core.needs_big_state(ts) == jax_core.needs_big_state(js)
    for start in (0, 5, js.S + 3):
        jm = np.asarray(jax_core.initial_metrics(js, 3, start))
        tm = torch_core.initial_metrics(ts, 3, start, "cpu")
        assert tm.dtype == torch.int32
        np.testing.assert_array_equal(tm.numpy(), jm)


def test_registry_and_puncture_tables_equal():
    assert len(pt.COMMON_CODES) == len(vt.COMMON_CODES)
    for a, b in zip(pt.COMMON_CODES, vt.COMMON_CODES):
        assert (a.name, a.K, a.G, a.R, a.num_states, a.num_half_states,
                a.state_bits) == (b.name, b.K, b.G, b.R, b.num_states,
                                  b.num_half_states, b.state_bits)
        for hi, lo in ((127, -127), (3, -3), (1, -1), (5, 0)):
            np.testing.assert_array_equal(pt.branch_table(a, hi, lo),
                                          vt.branch_table(b, hi, lo))
    assert [(p.name, p.pattern) for p in pt.DAB_PI_TABLE] == \
        [(p.name, p.pattern) for p in vt.DAB_PI_TABLE]
    assert (pt.DAB_PI_X.name, pt.DAB_PI_X.pattern) == \
        (vt.DAB_PI_X.name, vt.DAB_PI_X.pattern)
    np.testing.assert_array_equal(pt.DAB_PI_TABLE[3].mask(100, 7),
                                  vt.DAB_PI_TABLE[3].mask(100, 7))
    x = np.random.RandomState(0).randint(0, 1 << 30, 1000)
    np.testing.assert_array_equal(pt.parity(x), vt.parity(x))
    assert pt.get_code(2) == pt.get_code("Voyager")
    with pytest.raises(KeyError):
        pt.get_code("no such code")
    with pytest.raises(ValueError, match="g_0"):
        pt.CodeSpec("bad", 5, (0b10110, 0b11001))


@pytest.mark.parametrize("arith", ARITHS)
def test_decode_configs_equal_for_every_rate(arith):
    """Includes the narrow-type wrap of the error margin at extreme
    rates (config.py:93-95)."""
    for mode in MODES:
        for rate in range(1, 17):
            a = pt.get_decode_config(pt.DecodeType(mode), rate, arith=arith)
            b = vt.get_decode_config(vt.DecodeType(mode), rate, arith=arith)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.metric_max == b.metric_max
    with pytest.raises(ValueError):
        pt.DecoderConfig(1, -1, 2, 0, 0, 0, metric_bits=12)


def test_public_names_match_the_jax_package():
    assert set(pt.__all__) == set(vt.__all__)


def test_port_imports_neither_jax_nor_triton():
    """The card's machine has no jax, and a module that compiled or
    imported triton at import time would break the CPU tests.  Importing
    the host chain builds nothing either, the parallel layer starts no
    process group, and the BER, punctured-decoder and scaling tools
    answer --help without jax."""
    code = ("import sys\n"
            "import viterbidecodercpp_torch\n"
            "from viterbidecodercpp_torch.ops import (_build, bigstate,"
            " chainback, encoder, lane, numpy_ref, plane, rotated,"
            " torch_core)\n"
            "from viterbidecodercpp_torch import ber, puncture, streaming\n"
            "from viterbidecodercpp_torch.utils import native, testsig\n"
            "from viterbidecodercpp_torch.parallel import (block_sp,"
            " frame_dp, launch, mesh)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'triton', 'viterbidecodercpp_tpu')]\n"
            "assert not bad, bad\n"
            "assert not _build.build_seconds\n"
            "assert native.ensure_built.cache_info().currsize == 0\n"
            "assert 'ber' not in viterbidecodercpp_torch.__all__\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # each tool's documented way to run on the CPU
    for tool, cpu_flag in (("torch_run_snr_ber.py", "--cpu"),
                           ("torch_run_punctured_decoder.py", "--cpu"),
                           ("torch_run_scaling.py", "--simulate")):
        # -X importtime lists every module the tool imported
        proc = subprocess.run(
            [sys.executable, "-X", "importtime",
             os.path.join("tools", tool), "--help"],
            cwd=root, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert cpu_flag in proc.stdout
        imported = {line.split("|")[-1].strip().split(".")[0]
                    for line in proc.stderr.splitlines()
                    if line.startswith("import time:")}
        assert "viterbidecodercpp_torch" in imported
        assert not imported & {"jax", "jaxlib", "triton",
                               "viterbidecodercpp_tpu"}, (tool, imported)


HARNESS_TOOLS = ("torch_run_simple.py", "torch_run_tests.py",
                 "torch_run_streaming.py", "torch_ber_truncated_delta.py",
                 "torch_fuzz_differential.py", "torch_run_benchmark.py",
                 "torch_profile_trace.py")
# One child a tool, with jax blocked from import: import the oracle, then
# run the tool as a script with --help and with no argument, and report
# each run's exit code (SystemExit's code) and standard output.
_BLOCKED = """
import contextlib, io, json, runpy, sys
sys.modules['jax'] = None
sys.modules['jaxlib'] = None
import viterbidecodercpp_torch.ops.numpy_ref
path, runs = sys.argv[1], []
for argv in (['--help'], []):
    sys.argv = [path] + argv
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name='__main__')
        code = 0
    except SystemExit as exc:
        code = exc.code
    runs.append([code, out.getvalue()])
bad = [m for m, mod in sys.modules.items() if mod is not None
       and m.split('.')[0] in ('jax', 'jaxlib', 'viterbidecodercpp_tpu')]
print(json.dumps({'runs': runs, 'bad': bad}))
"""


@pytest.mark.parametrize("tool", HARNESS_TOOLS)
def test_harness_tools_run_without_jax_and_refuse_without_a_card(tool):
    """With jax blocked from import, the oracle imports and each harness
    tool answers --help; without --cpu on a machine with no card the tool
    exits with a message naming the card (SystemExit with a message:
    status 1, the message on stderr) before it prints or decodes
    anything."""
    import json

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED, os.path.join("tools", tool)],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.splitlines()[-1])
    assert report["bad"] == []
    (help_code, help_out), (code, out) = report["runs"]
    assert help_code == 0 and "--cpu" in help_out
    assert isinstance(code, str) and "no CUDA card" in code, code
    assert "--cpu" in code
    assert out == ""
