"""The comparison catches a broken program: the rest of a run, the look
for a card skipped, with the timed path broken underneath, must come out
``correct`` false, once for each fault a cell can have; and the control
(the reference one metric width down, in the program's place) fails."""

import textwrap

import pytest
import torch

from bench_port_tiny import CELLS, edit, run_tiny, tiny_tree
from viterbidecodercpp_torch import decoder, streaming


def flip_first_bit(bits):
    bits = bits.clone()
    bits[:, 0] ^= 1
    return bits


def answer_altered_batch(mp):
    real = decoder.ViterbiDecoder.chainback
    mp.setattr(decoder.ViterbiDecoder, "chainback",
               lambda self, *a, **k: flip_first_bit(real(self, *a, **k)))


def half_batch_left_out(mp):
    real = decoder.ViterbiDecoder.decode

    def decode(self, symbols, total_bits, **kw):
        half = symbols.shape[0] // 2
        bits, err, acc = real(self, symbols[:half], total_bits, **kw)
        pad = symbols.shape[0] - half
        return (torch.cat([bits, bits.new_zeros(pad, bits.shape[1])]),
                torch.cat([err, err.new_zeros(pad)]),
                torch.cat([acc, acc.new_zeros(pad)]))

    mp.setattr(decoder.ViterbiDecoder, "decode", decode)


def update_returns_its_state(mp):
    mp.setattr(decoder.ViterbiDecoder, "update",
               lambda self, state, symbols: state)


def push_returns_its_state(mp):
    real = streaming.StreamingDecoder.push

    def push(self, state, symbols):
        _, bits, valid = real(self, state, symbols)
        return state, bits, valid

    mp.setattr(streaming.StreamingDecoder, "push", push)


def answer_altered_push(mp):
    real = streaming.StreamingDecoder.push

    def push(self, state, symbols):
        state, bits, valid = real(self, state, symbols)
        return state, flip_first_bit(bits), valid

    mp.setattr(streaming.StreamingDecoder, "push", push)


# the 4-rank cell's faults are planted in each rank process by a
# sitecustomize module on PYTHONPATH
SP_FAULTS = {
    "exchange_left_out": """
        import torch, torch.distributed as dist
        from viterbidecodercpp_torch.parallel import block_sp

        def shift(x, group, step):
            n, i = dist.get_world_size(group), dist.get_rank(group)
            return torch.zeros_like(x) if 0 <= i - step < n else None

        block_sp.shift = shift
        """,
    "answer_altered": """
        from viterbidecodercpp_torch.parallel import block_sp
        real = block_sp.decode_stream_sp

        def decode_stream_sp(*a, **k):
            res = real(*a, **k)
            bits = res.bits.clone()
            bits[:, 100] ^= 1
            return block_sp.SpResult(bits, res.halo_mismatches)

        block_sp.decode_stream_sp = decode_stream_sp
        """,
}


@pytest.mark.parametrize("cell, fault", [
    ("voyager-batch", answer_altered_batch),
    ("voyager-batch", half_batch_left_out),
    ("voyager-batch", update_returns_its_state),
    ("cassini-batch", answer_altered_batch),
    ("cassini-batch", update_returns_its_state),
    ("voyager-stream", push_returns_its_state),
    ("voyager-stream", answer_altered_push),
], ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_is_caught(cell, fault, tmp_path, monkeypatch):
    bench = tiny_tree(tmp_path)
    assert run_tiny(bench, cell)["correct"]
    fault(monkeypatch)
    out = run_tiny(bench, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(SP_FAULTS))
def test_sp_fault_is_caught(fault, tmp_path, monkeypatch):
    bench = tiny_tree(tmp_path)
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        textwrap.dedent(SP_FAULTS[fault]))
    monkeypatch.setenv("PYTHONPATH", str(site))
    out = run_tiny(bench, "voyager-sp4")
    assert not out["correct"], out["checks"]


# the control at a size where a 4-bit metric loses bits on every seed (at
# the tiny sizes it can decode a few short streams right)
CONTROL_PARAMS = {"voyager-stream": {"frames": 16, "check_frames": 16,
                                     "pass_pushes": 24, "check_passes": 2},
                  "voyager-sp4": {"frames": 16, "check_frames": 16,
                                  "stream_bits": 4096}}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, tmp_path):
    from bench_port import control
    bench = tiny_tree(tmp_path)
    if cell in CONTROL_PARAMS:
        edit(bench / "workloads" / f"{cell}.json",
             lambda w: w["params"].update(CONTROL_PARAMS[cell]))
    for seed in (1, 2, 3):
        r = control.readings(cell, seed, "cpu", bench)
        assert not r["correct"], r
