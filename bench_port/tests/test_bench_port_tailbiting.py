"""The blind-decoding cell (``lte-pdcch-blind``) and the BER-point cell
(``voyager-ber``) at tiny sizes on the CPU: each runs correct, each
planted fault in its timed path reads ``correct`` false, the control
(the reference one metric width down) fails, a program without the
circular decode is refused at once, and each of their readers reads a
record made by hand."""

import json
import time

import pytest
import torch

from bench_port_tiny import ROOT, edit, run_tiny, tiny_tree
from bench_port import harness
from bench_port.counts import bounds, tailbiting
from viterbidecodercpp_torch import decoder, ratematch
from viterbidecodercpp_torch.ops import chainback, torch_core
from viterbidecodercpp_torch.utils import testsig

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = ("lte-pdcch-blind", "voyager-ber")
TINY = {"lte-pdcch-blind": {"subframes": 1, "pool": 1, "warmup": 1,
                            "check_groups": 1, "check_frames": 3,
                            "check_sent": 1},
        "voyager-ber": {"frames": 8, "block_bits": 64, "max_bits": 2048,
                        "check_frames": 4, "check_points": 2,
                        "ebno_db": 0.0}}
# (voyager-ber at 0 dB: tens of bit errors a point, so that a point that
# decodes or counts less than it draws shows in its error count)
# DCI payloads of 4-10 bits (frames of 20-26 with the CRC): the plain
# ACS on the CPU runs 3L steps a call
TINY_PAYLOADS = [4, 6, 8, 10]
# long enough at these sizes for every sampled call to be reached
SECONDS = 3.0
# one core a test process: the plain versions run thousands of small ops
torch.set_num_threads(1)


def tiny(tmp_path):
    bench = tiny_tree(tmp_path)
    for name, params in TINY.items():
        edit(bench / "workloads" / f"{name}.json",
             lambda w, p=params: w["params"].update(p))
    edit(bench / "configs" / "lte-pdcch.json",
         lambda c: c.update(dci_payload_bits=TINY_PAYLOADS))
    return bench


def middle_copy_from_state_0(mp):
    mp.setattr(torch_core, "equal_metrics",
               lambda spec, B, device: torch_core.initial_metrics(
                   spec, B, 0, device))


def last_copy_walked(mp):
    real = chainback.chainback

    def walk(spec, packed, start, total_bits, *, first_bit=0, n_bits=None,
             **kw):
        if first_bit:
            # the newest n_bits the walk can give: the last copy's
            first_bit = total_bits - n_bits
        return real(spec, packed, start, total_bits, first_bit=first_bit,
                    n_bits=n_bits, **kw)

    mp.setattr(chainback, "chainback", walk)


def repeats_not_combined(mp):
    real = ratematch.dematch

    def dematch(soft, L, *, R=3, **kw):
        # the circular buffer's first pass only: repeated bits dropped
        return real(soft[..., :min(soft.shape[-1], L * R)], L, R=R, **kw)

    mp.setattr(ratematch, "dematch", dematch)


def decoded_bit_flipped(mp):
    real = decoder.ViterbiDecoder.decode

    def decode(self, *a, **k):
        bits, err, acc = real(self, *a, **k)
        bits = bits.clone()
        bits[:, 0] ^= 1
        return bits, err, acc

    mp.setattr(decoder.ViterbiDecoder, "decode", decode)


def error_count_off_by_one(mp):
    real = testsig.count_bit_errors
    mp.setattr(testsig, "count_bit_errors", lambda a, b: real(a, b) + 1)


def half_batch_decoded(mp):
    """measure_point's loop decodes and counts half of each batch."""
    from viterbidecodercpp_torch import ber
    real = ber.decode_errors

    def decode_errors(dec, syms, tx):
        half = syms.shape[0] // 2
        return real(dec, syms[:half], tx[:half])

    mp.setattr(ber, "decode_errors", decode_errors)


def batch_not_drawn(mp):
    """Every other batch of measure_point's loop is the one before it
    again, not drawn, though its bits are counted."""
    from viterbidecodercpp_torch import ber
    real, last = ber.draw_batch, []

    def draw_batch(*a, **k):
        if len(last) % 2 == 0:
            last.append(real(*a, **k))
        else:
            last.append(last[-1])
        return last[-1]

    mp.setattr(ber, "draw_batch", draw_batch)


def channel_shifted(mp):
    real = testsig.awgn_quantize
    mp.setattr(testsig, "awgn_quantize",
               lambda *a, **k: (real(*a, **k) + 1).clamp(max=3))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell, tmp_path):
    out = run_tiny(tiny(tmp_path), cell, seed=2_300_000_017, seconds=SECONDS)
    assert out["correct"] and out["attempted"] > 0, out["checks"]
    assert set(out["metrics"]) == {"decode_symbols_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert all(c["value"] == c["limit"] == 0
               for c in out["checks"].values())


@pytest.mark.parametrize("cell, fault", [
    ("lte-pdcch-blind", middle_copy_from_state_0),
    ("lte-pdcch-blind", last_copy_walked),
    ("lte-pdcch-blind", repeats_not_combined),
    ("voyager-ber", decoded_bit_flipped),
    ("voyager-ber", error_count_off_by_one),
    ("voyager-ber", channel_shifted),
    ("voyager-ber", half_batch_decoded),
    ("voyager-ber", batch_not_drawn),
], ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_is_caught(cell, fault, tmp_path, monkeypatch):
    bench = tiny(tmp_path)
    fault(monkeypatch)
    out = run_tiny(bench, cell, seconds=SECONDS)
    assert not out["correct"], out["checks"]


# the control at a size where a narrower metric loses bits on every seed
CONTROL_PARAMS = {"voyager-ber": {"frames": 32, "check_frames": 32}}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, tmp_path):
    from bench_port import control
    bench = tiny(tmp_path)
    if cell in CONTROL_PARAMS:
        edit(bench / "workloads" / f"{cell}.json",
             lambda w: w["params"].update(CONTROL_PARAMS[cell]))
    for seed in (1, 2, 3):
        r = control.readings(cell, seed, "cpu", bench)
        assert not r["correct"], r


def test_program_without_circular_decode_refused(tmp_path, monkeypatch):
    """The parent of the change that added the circular decode has no
    ``decode_tailbiting``: the cell stops at once with a BenchError,
    which ``run.py`` turns into a non-zero exit."""
    bench = tiny(tmp_path)
    monkeypatch.delattr(decoder.ViterbiDecoder, "decode_tailbiting")
    t0 = time.perf_counter()
    with pytest.raises(harness.BenchError, match="decode_tailbiting"):
        run_tiny(bench, "lte-pdcch-blind")
    assert time.perf_counter() - t0 < 5


def reader(name):
    return harness.load_module(ROOT / "bench_port" / "metrics"
                               / f"{name}.py").read


SHAPES = [{"S": 64, "B": 10, "T": 3 * L, "R": 3, "W": 2, "data_bits": L,
           "K": 7} for L in (44, 55, 64, 67)]
TRACE = {"idle_share": 0.3, "calls": 6, "window_s": 2.0,
         "kernels": {"void rotated_acs_warp<6>(int)": [6, 0.004],
                     "void chainback_tiled<2>(int)": [6, 0.001],
                     "void at::native::fill(int)": [12, 0.5]}}
# the first 6 calls: sizes 44, 55, 64, 67, 44, 55
ACS = sum(bounds.acs_bound(64, 10, 3 * L, 3, 2)[0] for L in
          (44, 55, 64, 67, 44, 55)) / 6
WALK = sum(bounds.walk_bound(2 * L - 6, 10, 2 * L - 6, 1)[0] for L in
           (44, 55, 64, 67, 44, 55)) / 6
# voyager-ber's record: one shape, every batch's
BER_SHAPE = {"S": 64, "B": 16384, "T": 2054, "R": 2, "W": 2,
             "data_bits": 2048}
SPANS = {"idle_s": 0.4, "idle_in_program_s": 0.1,
         "per_call": {"decoder.tailbiting": {
             "total": [5e-3, 6e-3, 7e-3],
             "self": {"decoder.tailbiting": [1e-3, 3e-3, 2e-3],
                      "decoder.update": [2e-3, 2e-3, 2e-3],
                      "ops.rotated_acs": [1e-4, 2e-4, 3e-4],
                      "ops.chainback": [1e-4, 1e-4, 1e-4]}},
             "ratematch.dematch": {"total": [1e-4, 4e-4, 2e-4, 3e-4],
                                   "self": {}}}}


@pytest.mark.parametrize("name, rec, want", [
    ("device_idle_share.pdcch", {"trace": TRACE}, 0.3),
    ("device_idle_share.ber", {"trace": TRACE}, 0.3),
    ("ber.overhead_share", {"trace": TRACE}, 1 - 0.005 / 2.0),
    ("idle.in_program_share.pdcch", {"span_window": SPANS}, 0.25),
    ("decoder.tailbiting.self_ms", {"span_window": SPANS}, 2.0),
    ("ratematch.dematch_ms", {"span_window": SPANS}, 0.25),
    ("rotated_acs_roofline.pdcch", {"trace": TRACE, "shapes": SHAPES},
     100 * 6 * ACS / 1e3 / 0.004),
    ("chainback_roofline.pdcch", {"trace": TRACE, "shapes": SHAPES},
     100 * 6 * WALK / 1e3 / 0.001),
    ("decoder.update.self_ms.pdcch", {"span_window": SPANS}, 2.0),
    ("ops.launch_ms.pdcch", {"span_window": SPANS}, 0.3),
    ("rotated_acs_roofline", {"trace": TRACE, "shape": BER_SHAPE},
     100 * 6 * bounds.acs_bound(64, 16384, 2054, 2, 2)[0] / 1e3 / 0.004),
    ("chainback_roofline", {"trace": TRACE, "shape": BER_SHAPE},
     100 * 6 * bounds.walk_bound(2054, 16384, 2054, 1)[0] / 1e3 / 0.001),
])
def test_reader(name, rec, want):
    assert reader(name)(rec) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(
    m["name"] for m in BENCH["per_layer"]
    if set(m["workloads"]) & set(CELLS)))
def test_reader_finds_nothing(name):
    """An untraced record (or the parent's, without the spans) reads as
    nothing, never 0, and never raises."""
    assert reader(name)({"shapes": SHAPES, "shape": BER_SHAPE,
                         "span_window": None}) is None


def test_bound_of_each_size():
    """Calls of the four sizes in turn: sizes 0 and 1 run once more than
    2 and 3 in the first 6."""
    rec = {"trace": {"calls": 6}, "shapes": SHAPES}
    assert tailbiting.mean_bound_ms(rec, "acs") == pytest.approx(ACS)
    assert tailbiting.mean_bound_ms(rec, "walk") == pytest.approx(WALK)
    assert tailbiting.mean_bound_ms({"shapes": SHAPES}, "acs") is None
