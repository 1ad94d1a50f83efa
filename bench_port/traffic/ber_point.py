"""Bit-error-rate points back to back: one caller runs
``ber.measure_point`` again and again on one generator, as a BER sweep
does, each point with the budgets ``ber.capped_budgets`` allows.  A point
draws, encodes, sends through the channel, decodes and counts one batch
of ``frames`` frames of ``block_bits`` bits at a time on the card, and
reads its error count on the host after each batch (the program's own
loop, unchanged).  The window closes after the point running at
``--seconds``, with a device synchronise.

Params (``workloads/<cell>.json``): ``frames`` (B, frames a batch),
``block_bits``, ``ebno_db``, ``max_bits`` and ``max_errors`` (a point's
budgets before the cap), ``check_points`` and ``check_frames`` (the
comparison reads the first batch of one of the window's first
``check_points`` points, drawn from the seed, and the decoded bits of
that many of its frames).

Compared, each with limit 0: the batch drawn again from the point's
generator state through the frozen channel (``channel.py``) against the
program's draw (data bits and symbols, ``symbol_mismatches``); the
program's decode of the batch, on the sampled frames, against the NumPy
reference on the frozen channel's symbols: bits, end-state metric and
renormalisation total (``bit_mismatches``, ``metric_mismatches``,
``acc_mismatches``; at 6 dB a decode with narrower metrics gets the bits
right and the metrics wrong); the program's
error count of the batch against the errors of its decoded bits, counted
on the host against the frozen channel's data
(``error_count_mismatches``); the point the window timed against its
replay (``point_bits_mismatches``, ``point_error_mismatches``,
``point_draw_mismatches``): every batch of the point drawn again from
its generator state through the frozen channel, decoded by a
``ViterbiDecoder`` and counted on the card, under the point's own
stopping rule, gives the window's ``total_bits`` and
``total_bit_errors`` and leaves the generator where the window's point
left it; ``points_unchecked`` where the window never reached the
sampled point.
"""

import dataclasses
import sys
import time

# the comparison's numbers, but for points_unchecked
CHECKS = ("symbol_mismatches", "bit_mismatches", "metric_mismatches",
          "acc_mismatches", "error_count_mismatches", "point_bits_mismatches",
          "point_error_mismatches", "point_draw_mismatches")


@dataclasses.dataclass
class Points:
    code: object
    dconf: object
    gen: object             # the points' torch.Generator
    frames: int
    block_bits: int
    ebno_db: float
    max_bits: int
    max_errors: int

    def point(self, max_bits=None):
        from viterbidecodercpp_torch import ber

        return ber.measure_point(
            self.code, self.dconf, self.ebno_db, generator=self.gen,
            block_bits=self.block_bits, batch=self.frames,
            max_bits=self.max_bits if max_bits is None else max_bits,
            max_errors=self.max_errors, device=self.gen.device)


def _setup(run) -> Points:
    import torch

    import viterbidecodercpp_torch as vp
    from viterbidecodercpp_torch.decoder import resolve_device

    cfg, p = run.cell.config, run.cell.params
    code = vp.CodeSpec(cfg["code"], int(cfg["K"]), tuple(cfg["G"]))
    dconf = vp.get_decode_config(vp.DecodeType(cfg["decode_type"]),
                                 code.R, arith=cfg["arith"])
    run.mark("program imported")
    # measure_point wants the generator on the card it names (cuda:0)
    gen = torch.Generator(device=resolve_device(run.device))
    gen.manual_seed(run.seed)
    return Points(code, dconf, gen, int(p["frames"]), int(p["block_bits"]),
                  float(p["ebno_db"]), int(p["max_bits"]),
                  int(p["max_errors"]))


def _loop(pts: Points, seconds: float, states=None) -> tuple:
    """Points back to back until ``seconds`` have passed; returns (points,
    batches).  ``states[i]``, for each i it holds, receives point i's
    (generator state before it, its BerPoint, the state after it)."""
    n = batches = 0
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        before = pts.gen.get_state() if states is not None \
            and n in states else None
        pt = pts.point()
        if before is not None:
            states[n] = (before, pt, pts.gen.get_state())
        batches += pt.total_bits // (pts.frames * pts.block_bits)
        n += 1
    return n, batches


def _redraw(run, pts: Points, state) -> tuple:
    """The batch drawn from generator state ``state``, twice: (the
    program's symbols (B, T, R) and data bits, the frozen channel's
    symbols (B, T * R) and data bits)."""
    import torch

    from viterbidecodercpp_torch import ber

    again = torch.Generator(device=pts.gen.device)
    again.set_state(state)
    syms, tx = ber.draw_batch(pts.code, pts.dconf, pts.ebno_db, again,
                              pts.frames, pts.block_bits)
    again.set_state(state)
    data, want = _frozen_batch(run, pts, again)
    return syms, tx, want, data


def _frozen_batch(run, pts: Points, gen) -> tuple:
    """One batch of the frozen channel from ``gen``: (data bits (B, N),
    symbols (B, T * R) int32), drawing as ``ber.draw_batch`` draws."""
    import torch

    from bench_port import channel

    cfg, B, N = run.cell.config, pts.frames, pts.block_bits
    data = torch.randint(0, 2, (B, N), generator=gen, dtype=torch.uint8,
                         device=gen.device)
    return data, channel.channel(
        channel.encode(int(cfg["K"]), tuple(cfg["G"]), data), gen,
        pts.ebno_db, pts.dconf.soft_decision_high,
        pts.dconf.soft_decision_low, torch.int32)


def _replay(run, pts: Points, state) -> tuple:
    """The point that started at generator state ``state``, again, outside
    ``measure_point``: each batch from the frozen channel, decoded by a
    new ``ViterbiDecoder`` and its errors counted on the card, until the
    point's stopping rule (both budgets capped one batch below INT32_MAX,
    as the JAX package's int32 counters cap them) ends it.  Returns
    (bits, bit errors, the generator's state after the point)."""
    import torch

    from viterbidecodercpp_torch.decoder import ViterbiDecoder

    B, N = pts.frames, pts.block_bits
    gen = torch.Generator(device=pts.gen.device)
    gen.set_state(state)
    step = B * N
    cap = (1 << 31) - 1 - step
    max_bits, max_errors = min(pts.max_bits, cap), min(pts.max_errors, cap)
    dec = ViterbiDecoder(pts.code, pts.dconf, traceback_length=N,
                         device=gen.device)
    bits = errors = 0
    while bits < max_bits and errors < max_errors:
        data, syms = _frozen_batch(run, pts, gen)
        rx, _, _ = dec.decode(syms, N)
        errors += int((rx != data).sum())
        bits += step
    return bits, errors, gen.get_state()


def _reference(tr, want, frames, T: int, N: int) -> tuple:
    """The NumPy reference's (bits, end-state metric, renormalisation
    total) of frames ``frames`` of the frozen channel's symbols
    ``want``."""
    import torch

    from bench_port.reference import viterbi as ref

    idx = torch.as_tensor(frames, device=want.device)
    return ref.decode(tr, want.index_select(0, idx).cpu().numpy()
                      .reshape(len(frames), T, tr.R), N)


def _compare(want: tuple, got: list) -> list:
    return [[name, int((g != w).sum())] for name, g, w in zip(
        ("bit_mismatches", "metric_mismatches", "acc_mismatches"), got,
        want)]


def control(run, metric_bits: int) -> list:
    """The comparison's numbers with the reference at ``metric_bits``-bit
    metrics in the program's place, on the batch a run's warm-up point
    draws and the run's sample of its frames."""
    from bench_port.harness import sample_frames
    from bench_port.reference import viterbi as ref

    cfg, p = run.cell.config, run.cell.params
    pts = _setup(run)
    rng = run.rng(1)
    rng.integers(0, int(p["check_points"]))
    _, _, want, _ = _redraw(run, pts, pts.gen.get_state())
    frames = sample_frames(rng, pts.frames, int(p["check_frames"]))
    T = pts.block_bits + int(cfg["K"]) - 1
    args = (cfg["K"], cfg["G"], cfg["decode_type"], cfg["arith"])
    full = _reference(ref.trellis(*args), want, frames, T, pts.block_bits)
    low = _reference(ref.trellis(*args, metric_bits), want, frames, T,
                     pts.block_bits)
    return [["symbol_mismatches", 0]] + _compare(full, low) + [
        [name, 0] for name in CHECKS[4:]]


def run(run) -> dict:
    import numpy as np
    import torch

    from bench_port import profiling
    from bench_port.harness import sample_frames
    from bench_port.reference import viterbi as ref
    from viterbidecodercpp_torch.decoder import ViterbiDecoder
    from viterbidecodercpp_torch.utils import testsig

    p = run.cell.params
    pts = _setup(run)
    cuda = run.device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    B, N = pts.frames, pts.block_bits
    cfg = run.cell.config
    K, G = int(cfg["K"]), tuple(cfg["G"])
    T, R = N + K - 1, len(G)
    rng = run.rng(1)
    check_point = int(rng.integers(0, int(p["check_points"])))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # a one-batch point builds every kernel and warms every shape
    pts.point(max_bits=1)
    sync()
    run.mark("a warm-up batch")

    states = {check_point: None}
    setup_s = time.time() - run.t_start
    t0 = time.perf_counter()
    points, batches = _loop(pts, run.seconds, states)
    sync()
    window_s = time.perf_counter() - t0
    rec = {"attempted": batches, "failed": 0, "setup_s": setup_s,
           "window_s": window_s, "points": points, "batches": batches,
           "symbols": batches * B * T * R,
           "shape": {"S": 1 << (K - 1), "B": B, "T": T, "R": R,
                     "W": max((1 << (K - 1)) // 32, 1), "data_bits": N}}
    if run.trace:
        rec["trace"] = profiling.trace_window(
            lambda: pts.point(max_bits=1),
            lambda s: dict(zip(("calls", "batches"), _loop(pts, s))))
    rec["device"] = {
        "kind": torch.cuda.get_device_name() if cuda else "cpu", "count": 1,
        "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda
        else 0}

    # -- the comparison, once the window has closed ----------------------
    if states[check_point] is None:
        print(f"ber_point: {points} points, {batches} batches in "
              f"{window_s:.4f} s; point {check_point} never reached",
              file=sys.stderr)
        rec["checks"] = [[name, 0] for name in CHECKS] + [
            ["points_unchecked", 1]]
        return rec
    state, timed, after = states[check_point]
    syms, tx, want, data = _redraw(run, pts, state)
    n_sym = int((syms.reshape(B, -1) != want).sum()) + int((tx != data)
                                                           .sum())
    dec = ViterbiDecoder(pts.code, pts.dconf, traceback_length=N,
                         device=pts.gen.device)
    rx, err, acc = dec.decode(syms.reshape(B, -1), N)
    errors = int(testsig.count_bit_errors(rx, tx))
    counted = int((rx != data).sum())
    frames = sample_frames(rng, B, int(p["check_frames"]))
    tr = ref.trellis(K, G, cfg["decode_type"], cfg["arith"])
    got = [x.index_select(0, torch.as_tensor(frames, device=rx.device))
           .cpu().numpy().astype(np.int64) for x in (rx, err, acc)]
    want_out = _reference(tr, want, frames, T, N)
    bits, point_errors, replayed = _replay(run, pts, state)
    print(f"ber_point: {points} points, {batches} batches of {B} frames in "
          f"{window_s:.4f} s; point {check_point}'s first batch drawn "
          f"again: {errors} bit errors, {len(frames)} frames compared with "
          f"the reference; the point timed {timed.total_bits} bits, "
          f"{timed.total_bit_errors} errors, replayed {bits} bits, "
          f"{point_errors} errors", file=sys.stderr)
    rec["checks"] = [["symbol_mismatches", n_sym]] + _compare(
        want_out, got) + [
        ["error_count_mismatches", abs(errors - counted)],
        ["point_bits_mismatches", abs(timed.total_bits - bits)],
        ["point_error_mismatches",
         abs(timed.total_bit_errors - point_errors)],
        ["point_draw_mismatches", int(not torch.equal(after, replayed))],
        ["points_unchecked", 0]]
    return rec
