"""The port's differential fuzzer (``tools/torch_fuzz_differential.py``)
on the CPU, against the NumPy oracle and the JAX package.

The tool itself imports no jax and holds every route to the port's
``numpy_ref``; here the same seeded cases also go through the JAX
package's ``backend="xla"`` decoder (K <= 11), and decoder states cross
between the two packages in both directions through
``to_numpy``/``from_numpy``.  Every comparison is exact (tolerance 0).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import viterbidecodercpp_torch as pt  # noqa: E402
import viterbidecodercpp_tpu as vt  # noqa: E402
from tools import torch_fuzz_differential as fuzz  # noqa: E402

# seeds 0..11 cover the rotated warp and block designs (K=12/13
# included), both walk designs, the lane and plane routes, the truncated
# walk, the puncture and checkpoint arms and end states other than 0; 47
# is a K=17 cluster case walked from another end state, 403 a K=18 case
# (the cluster of four blocks on the card) with a truncated walk
SEEDS = list(range(12)) + [47, 403]
_FIELDS = ("metrics", "decisions", "accumulated_error", "bit_cursor")


def _jax_decoder(case):
    code = vt.CodeSpec(case.code.name, case.code.K, case.code.G)
    config = vt.get_decode_config(vt.DecodeType(case.mode), code.R,
                                  arith=case.config.arith)
    return vt.ViterbiDecoder(code, config, backend="xla",
                             traceback_length=case.total_bits)


def test_seeds_cover_every_route():
    covered = set()
    for seed in SEEDS:
        case = fuzz.draw(seed)
        spec = fuzz.torch_core.make_static_spec(case.code, case.config)
        route = fuzz.select_backend(spec, torch.device("cpu"))
        covered.update(fuzz.categories(case, route))
        covered.update(fuzz.categories(case, "torch"))
    assert not set(fuzz.REQUIRED) - covered


def test_draw_depends_on_the_seed_alone():
    a, b = fuzz.draw(7), fuzz.draw(7)
    assert a.describe() == b.describe()
    np.testing.assert_array_equal(a.symbols, b.symbols)
    assert (a.cuts, a.checkpoint, a.puncture, a.end_state) == \
        (b.cuts, b.checkpoint, b.puncture, b.end_state)


@pytest.mark.parametrize("seed", SEEDS)
def test_run_case_agrees_with_numpy_ref_and_jax(seed):
    """run_case raises on any disagreement with numpy_ref; both routes'
    outputs must also equal the JAX xla decoder's on the same symbols."""
    r = fuzz.run_case(seed, "cpu")
    case, want = r["case"], r["want"]
    assert set(r["outputs"]) == {fuzz.select_backend(
        fuzz.torch_core.make_static_spec(case.code, case.config),
        torch.device("cpu")), "torch"}
    for out in r["outputs"].values():
        np.testing.assert_array_equal(out["bits"], want["bits"])
        np.testing.assert_array_equal(out["error"], want["error"])
        np.testing.assert_array_equal(out["acc"], want["acc"])
    if case.code.K > 11:
        return
    dec = _jax_decoder(case)
    bits, err, acc = dec.decode(case.symbols, case.total_bits,
                                end_state=case.end_state)
    for out in r["outputs"].values():
        np.testing.assert_array_equal(out["bits"], np.asarray(bits))
        np.testing.assert_array_equal(out["error"], np.asarray(err))
        np.testing.assert_array_equal(out["acc"], np.asarray(acc))


@pytest.mark.parametrize("seed", [0, 2, 6, 10])
def test_decoder_state_crosses_between_the_packages(seed):
    """A JAX xla state cut at a random step continues in the port's torch
    decoder, and a port state continues in the JAX decoder: both end with
    the bits, get_error and renorm totals of the JAX decoder run to the
    end."""
    case = fuzz.draw(seed)
    R, nbits, B = case.code.R, case.total_bits, case.batch
    T = case.symbols.shape[1] // R
    cut = int(np.random.RandomState(seed).randint(1, T))
    head, tail = case.symbols[:, :cut * R], case.symbols[:, cut * R:]
    jdec = _jax_decoder(case)
    pdec = pt.ViterbiDecoder(case.code, case.config, backend="torch",
                             traceback_length=nbits, device="cpu")
    jfull = jdec.update(jdec.update(jdec.reset(B), head), tail)
    want_bits = np.asarray(jdec.chainback(jfull, nbits))
    want_err = np.asarray(jdec.get_error(jfull))
    want_acc = np.asarray(jfull.accumulated_error)

    # JAX -> port
    jhead = jdec.update(jdec.reset(B), head)
    pst = pt.DecoderState.from_numpy(
        {f: np.asarray(getattr(jhead, f)) for f in _FIELDS}, device="cpu")
    pst = pdec.update(pst, torch.as_tensor(tail))
    np.testing.assert_array_equal(pdec.chainback(pst, nbits).numpy(),
                                  want_bits)
    np.testing.assert_array_equal(pdec.get_error(pst).numpy(), want_err)
    np.testing.assert_array_equal(pst.accumulated_error.numpy(), want_acc)

    # port -> JAX
    phead = pdec.update(pdec.reset(B), torch.as_tensor(head))
    jst = vt.DecoderState(**{f: jnp.asarray(v)
                             for f, v in phead.to_numpy().items()})
    jst = jdec.update(jst, tail)
    np.testing.assert_array_equal(np.asarray(jdec.chainback(jst, nbits)),
                                  want_bits)
    np.testing.assert_array_equal(np.asarray(jdec.get_error(jst)), want_err)
    np.testing.assert_array_equal(np.asarray(jst.accumulated_error),
                                  want_acc)


def test_a_wrong_decoder_fails_with_a_reproducer(monkeypatch, capsys):
    """A chainback that flips one bit makes the tool exit 1 and print the
    case's reproducer line."""
    chainback = pt.ViterbiDecoder.chainback

    def wrong(self, *args, **kwargs):
        bits = chainback(self, *args, **kwargs).clone()
        bits[0, 0] ^= 1
        return bits

    monkeypatch.setattr(pt.ViterbiDecoder, "chainback", wrong)
    assert fuzz.main(["--cpu", "--cases", "3", "--seed", "5"]) == 1
    out = capsys.readouterr().out
    case = fuzz.draw(5)
    assert f"[fuzz] MISMATCH {case.describe()} route=" in out
    assert "arm=ragged" in out and "bits differ from numpy_ref" in out
    assert ("reproduce: python3 tools/torch_fuzz_differential.py --seed 5 "
            "--cases 1 -v --cpu") in out
    with pytest.raises(fuzz.Mismatch, match="seed=5 "):
        fuzz.run_case(5, "cpu")


def test_main_reports_the_coverage(capsys):
    assert fuzz.main(["--cpu", "--cases", "2", "--seed", "3"]) == 0
    out = capsys.readouterr().out
    assert "[fuzz] coverage: {" in out
    assert "[fuzz] DONE: 2 cases" in out and "0 mismatches" in out
