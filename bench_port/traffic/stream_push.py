"""Closed-loop fixed-delay streaming: ``B`` concurrent streams through one
``StreamingDecoder``, each push of ``chunk`` steps timed from the call
until its (B, chunk) bits are on the host, the next push issued at once.

Each stream is a pass of ``pass_pushes`` pushes from ``reset``; the
passes' symbols cycle through a pool of ``pool`` distinct passes made at
set-up (each push's block a contiguous (B, chunk * R) tensor, as a
receiver hands it over).

Params: ``frames``, ``window``, ``chunk``, ``pass_pushes``, ``pool``,
``warmup`` (pushes before the window), ``check_passes`` and
``check_frames`` (the sample the comparison reads: that many of the
window's passes, that many streams of each, drawn from the seed).

Compared with the plain reference, exactly: the bits of every valid push
of each sampled pass and stream, and every push's ``valid`` flag.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def _setup(run):
    import torch

    import viterbidecodercpp_torch as vp
    from bench_port import channel
    from bench_port.reference import viterbi as ref

    cfg, p = run.cell.config, run.cell.params
    K, G = int(cfg["K"]), tuple(cfg["G"])
    R, B = len(G), int(p["frames"])
    window, chunk, P = int(p["window"]), int(p["chunk"]), \
        int(p["pass_pushes"])
    dev = torch.device(run.device)
    code = vp.CodeSpec(cfg["code"], K, G)
    dconf = vp.get_decode_config(vp.DecodeType(cfg["decode_type"]), R,
                                 arith=cfg["arith"])
    sd = vp.StreamingDecoder(code, dconf, window=window, chunk=chunk,
                             device=dev)
    run.mark("program imported")
    tr = ref.trellis(K, G, cfg["decode_type"], cfg["arith"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(run.seed)
    dtype = getattr(torch, cfg["symbol_dtype"])
    pool = []
    for _ in range(int(p["pool"])):
        data = torch.randint(0, 2, (B, P * chunk), generator=gen,
                             dtype=torch.uint8, device=dev)
        syms = channel.channel(channel.encode(K, G, data, terminate=False),
                               gen, float(cfg["ebno_db"]), tr.high, tr.low,
                               dtype)
        # (P, B, chunk * R): push j's block is pool[s][j], contiguous
        pool.append(syms.reshape(B, P, chunk * R).transpose(0, 1)
                    .contiguous())
    if run.device == "cuda":
        torch.cuda.synchronize()
    run.mark(f"{len(pool)} input passes made")
    shape = {"S": 1 << (K - 1), "B": B, "R": R, "window": window,
             "chunk": chunk, "pass_pushes": P}
    return sd, pool, tr, shape


def _loop(sd, pool, seconds, frames=None, latency=None, passes=None) -> int:
    """Push back to back for ``seconds``, a new pass from ``reset`` every
    ``pass_pushes`` pushes; returns the pushes made.  ``latency`` receives
    each push's seconds, ``passes`` one (pool slot, [bits of ``frames``],
    [valid]) a pass."""
    P, B = pool[0].shape[0], pool[0].shape[1]
    n, j, slot, state = 0, P, -1, None
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        if j == P:
            slot, j = (slot + 1) % len(pool), 0
            state = sd.reset(B)
            if passes is not None:
                passes.append((slot, [], []))
        ts = time.perf_counter()
        state, bits, valid = sd.push(state, pool[slot][j])
        host = bits.cpu()
        te = time.perf_counter()
        if latency is not None:
            latency.append(te - ts)
        if passes is not None:
            passes[-1][1].append(host.numpy()[frames])
            passes[-1][2].append(bool(valid))
        n += 1
        j += 1
    return n


def _pass_rows(pool, slot: int, n: int, frames) -> np.ndarray:
    """(F, n * chunk * R) host symbols of a pass's first n pushes for the
    sampled streams."""
    import torch

    syms = pool[slot][:n].index_select(1, torch.as_tensor(
        frames, device=pool[slot].device)).cpu().numpy()
    return syms.transpose(1, 0, 2).reshape(len(frames), -1)


def _compare(tr, shape: dict, todo: list) -> list:
    """The numbers compared over ``todo`` ([(F, n * chunk * R) symbols,
    (n, F, chunk) bits, (n,) valid] a pass): bits of valid pushes and
    valid flags that differ from the reference's."""
    from bench_port.reference import viterbi as ref

    nbit = nvalid = 0
    for syms, bits, valid in todo:
        stream = syms.reshape(len(syms), -1, shape["R"])
        want, want_valid = ref.stream_pushes(tr, stream, shape["window"],
                                             shape["chunk"])
        nvalid += int((valid != want_valid).sum())
        nbit += int((bits[want_valid] != want[want_valid]).sum())
    return [["bit_mismatches", nbit], ["valid_mismatches", nvalid]]


def control(run, metric_bits: int) -> list:
    """The comparison's numbers with the reference at ``metric_bits``-bit
    metrics in the program's place: ``check_passes`` whole passes of the
    pool, the run's sampled streams."""
    from bench_port.harness import sample_frames
    from bench_port.reference import viterbi as ref

    p, cfg = run.cell.params, run.cell.config
    _, pool, tr, shape = _setup(run)
    frames = sample_frames(run.rng(1), shape["B"], int(p["check_frames"]))
    low = ref.trellis(cfg["K"], cfg["G"], cfg["decode_type"], cfg["arith"],
                      metric_bits)
    todo = []
    for i in range(int(p["check_passes"])):
        syms = _pass_rows(pool, i % len(pool), shape["pass_pushes"], frames)
        bits, valid = ref.stream_pushes(
            low, syms.reshape(len(syms), -1, shape["R"]), shape["window"],
            shape["chunk"])
        todo.append((syms, bits, valid))
    return _compare(tr, shape, todo)


def run(run) -> dict:
    import torch

    from bench_port import profiling
    from bench_port.harness import sample_frames

    p = run.cell.params
    sd, pool, tr, shape = _setup(run)
    cuda = run.device == "cuda"
    rng = run.rng(1)
    frames = sample_frames(rng, shape["B"], int(p["check_frames"]))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = sd.reset(shape["B"])
    for j in range(int(p["warmup"])):
        state, bits, _ = sd.push(state, pool[0][j % shape["pass_pushes"]])
        bits.cpu()
    run.mark(f"{p['warmup']} warm-up pushes")

    latency, passes = [], []
    setup_s = time.time() - run.t_start
    t0 = time.perf_counter()
    pushes = _loop(sd, pool, run.seconds, frames, latency, passes)
    window_s = time.perf_counter() - t0
    print(f"stream_push: {pushes} pushes in {window_s:.4f} s",
          file=sys.stderr)
    rec = {"attempted": pushes, "failed": 0, "setup_s": setup_s,
           "window_s": window_s, "calls": pushes, "push_latency_s": latency,
           "shape": shape}
    if run.trace:
        def warm():
            sd.push(sd.reset(shape["B"]), pool[0][0])[1].cpu()

        rec["trace"] = profiling.trace_window(
            warm, lambda s: {"calls": _loop(sd, pool, s)})
    rec["device"] = {
        "kind": torch.cuda.get_device_name() if cuda else "cpu", "count": 1,
        "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda
        else 0}

    # -- the comparison, once the window has closed ----------------------
    picked = sorted(rng.choice(len(passes), min(int(p["check_passes"]),
                                                len(passes)), replace=False))
    todo = [(_pass_rows(pool, passes[i][0], len(passes[i][1]), frames),
             np.stack(passes[i][1]), np.asarray(passes[i][2]))
            for i in picked]
    del pool, sd, state
    if cuda:
        torch.cuda.empty_cache()
    print(f"stream_push: compared {len(todo)} passes x {len(frames)} "
          f"streams ({sum(len(t[1]) for t in todo)} pushes) with the "
          f"reference", file=sys.stderr)
    rec["checks"] = _compare(tr, shape, todo)
    return rec
