"""Closed-loop batch decode: one caller issues ``ViterbiDecoder.decode``
calls back to back on one stream, with no host synchronisation between
calls, cycling through a pool of distinct input batches made at set-up;
the window closes with ``torch.cuda.synchronize()``.  The host never
drains the device: before issuing a call it waits only for the call
``AHEAD`` calls before it to finish, so the window ends within ``AHEAD``
calls of ``--seconds`` instead of a whole launch queue later.

Params (``workloads/<cell>.json``): ``frames`` (B, terminated frames a
call), ``pool`` (distinct batches), ``warmup`` (calls before the window),
``check_slots`` and ``check_frames`` (the sample the comparison reads:
that many pool batches, that many frames of each, drawn from the seed;
each batch's outputs are those of its last call in the window).

Compared with the plain reference, exactly: each sampled frame's decoded
bits, its end-state metric and its accumulated renormalisation error.
"""

from __future__ import annotations

import sys
import time

import numpy as np

# calls the host may run ahead of the device
AHEAD = 4


def _setup(run):
    """(decoder, pool (n, B, T * R), trellis, shape) of the cell."""
    import torch

    import viterbidecodercpp_torch as vp
    from bench_port import channel
    from bench_port.reference import viterbi as ref

    cfg, p = run.cell.config, run.cell.params
    K, G, nbits = int(cfg["K"]), tuple(cfg["G"]), int(cfg["data_bits"])
    R, B = len(G), int(p["frames"])
    dev = torch.device(run.device)
    code = vp.CodeSpec(cfg["code"], K, G)
    dconf = vp.get_decode_config(vp.DecodeType(cfg["decode_type"]), R,
                                 arith=cfg["arith"])
    dec = vp.ViterbiDecoder(code, dconf, device=dev)
    run.mark("program imported")
    tr = ref.trellis(K, G, cfg["decode_type"], cfg["arith"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(run.seed)
    dtype = getattr(torch, cfg["symbol_dtype"])
    pool = []
    for _ in range(int(p["pool"])):
        data = torch.randint(0, 2, (B, nbits), generator=gen,
                             dtype=torch.uint8, device=dev)
        pool.append(channel.channel(channel.encode(K, G, data), gen,
                                    float(cfg["ebno_db"]), tr.high, tr.low,
                                    dtype))
    if run.device == "cuda":
        torch.cuda.synchronize()
    run.mark(f"{len(pool)} input batches made")
    T = nbits + K - 1
    shape = {"S": 1 << (K - 1), "B": B, "T": T, "R": R,
             "W": max((1 << (K - 1)) // 32, 1), "data_bits": nbits}
    return dec, pool, tr, shape


def _loop(dec, pool, nbits, seconds, keep=None, enqueue=None) -> int:
    """Decode back to back for ``seconds``; returns the calls made.
    ``keep[slot]`` receives the last outputs of each pool slot it holds,
    ``enqueue`` each call's host time from the call to its return."""
    import torch

    cuda = pool[0].device.type == "cuda"
    # done[i % AHEAD] marks the end of call i on the device
    done = [torch.cuda.Event() for _ in range(AHEAD)] if cuda else None
    n = 0
    t_end = time.perf_counter() + seconds
    while True:
        if cuda and n >= AHEAD:
            done[n % AHEAD].synchronize()
        ts = time.perf_counter()
        if ts >= t_end:
            return n
        slot = n % len(pool)
        out = dec.decode(pool[slot], nbits)
        if enqueue is not None:
            enqueue.append(time.perf_counter() - ts)
        if cuda:
            done[n % AHEAD].record()
        if keep is not None and slot in keep:
            keep[slot] = out
        n += 1


def _sample(run, n_pool: int, B: int) -> dict:
    """{pool slot: frames} the comparison reads, drawn from the seed."""
    from bench_port.harness import sample_frames

    p = run.cell.params
    rng = run.rng(1)
    slots = sorted(rng.choice(n_pool, min(int(p["check_slots"]), n_pool),
                              replace=False))
    return {int(s): sample_frames(rng, B, int(p["check_frames"]))
            for s in slots}


def _rows(pool, frames: dict) -> dict:
    """{slot: (F, T * R) host symbols of the slot's sampled frames}."""
    import torch

    return {s: pool[s].index_select(0, torch.as_tensor(
        fr, device=pool[s].device)).cpu().numpy() for s, fr in frames.items()}


def _compare(tr, shape: dict, got: dict, syms: dict) -> list:
    """The numbers compared: bits, end-state metrics and renormalisation
    totals of ``got`` ({slot: (bits, metric, acc)}) that differ from the
    reference's on the same symbols."""
    from bench_port.reference import viterbi as ref

    nbit = nmet = nacc = 0
    for s, (bits, err, acc) in got.items():
        want = ref.decode(tr, syms[s].reshape(len(bits), shape["T"],
                                              shape["R"]),
                          shape["data_bits"])
        nbit += int((bits != want[0]).sum())
        nmet += int((err != want[1]).sum())
        nacc += int((acc != want[2]).sum())
    return [["bit_mismatches", nbit], ["metric_mismatches", nmet],
            ["acc_mismatches", nacc]]


def control(run, metric_bits: int) -> list:
    """The comparison's numbers with the reference at ``metric_bits``-bit
    metrics in the program's place, on the run's inputs and sample."""
    from bench_port.reference import viterbi as ref

    _, pool, tr, shape = _setup(run)
    frames = _sample(run, len(pool), shape["B"])
    syms = _rows(pool, frames)
    cfg = run.cell.config
    low = ref.trellis(cfg["K"], cfg["G"], cfg["decode_type"], cfg["arith"],
                      metric_bits)
    got = {s: ref.decode(low, x.reshape(len(x), shape["T"], shape["R"]),
                         shape["data_bits"]) for s, x in syms.items()}
    return _compare(tr, shape, got, syms)


def run(run) -> dict:
    import torch

    from bench_port import profiling

    p = run.cell.params
    dec, pool, tr, shape = _setup(run)
    cuda = run.device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    nbits, B = shape["data_bits"], shape["B"]
    frames = _sample(run, len(pool), B)
    if cuda:
        # the peak from here on: the pool, the program and its outputs,
        # not the generator's passing buffers
        torch.cuda.reset_peak_memory_stats()
    for i in range(int(p["warmup"])):
        dec.decode(pool[i % len(pool)], nbits)
    sync()
    run.mark(f"{p['warmup']} warm-up calls")

    keep = {s: None for s in frames}
    enqueue = []
    setup_s = time.time() - run.t_start
    t0 = time.perf_counter()
    calls = _loop(dec, pool, nbits, run.seconds, keep, enqueue)
    sync()
    window_s = time.perf_counter() - t0
    rec = {"attempted": calls, "failed": 0, "setup_s": setup_s,
           "window_s": window_s, "calls": calls,
           "symbols": calls * B * shape["T"] * shape["R"],
           "enqueue_s": enqueue, "shape": shape}
    if run.trace:
        rec["trace"] = profiling.trace_window(
            lambda: dec.decode(pool[0], nbits),
            lambda s: {"calls": _loop(dec, pool, nbits, s)})
    rec["device"] = {
        "kind": torch.cuda.get_device_name() if cuda else "cpu", "count": 1,
        "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda
        else 0}

    # -- the comparison, once the window has closed ----------------------
    reached = {s: fr for s, fr in frames.items() if keep[s] is not None}
    got = {s: [x.index_select(0, torch.as_tensor(fr, device=x.device))
               .cpu().numpy().astype(np.int64) for x in keep[s]]
           for s, fr in reached.items()}
    syms = _rows(pool, reached)
    del keep, pool, dec
    if cuda:
        torch.cuda.empty_cache()
    print(f"batch_decode: {calls} calls in {window_s:.4f} s; compared "
          f"{sum(len(fr) for fr in reached.values())} frames of "
          f"{len(got)} pool batches with the reference", file=sys.stderr)
    # a sampled batch the window never reached counts as unchecked
    rec["checks"] = _compare(tr, shape, got, syms) + [
        ["batches_unchecked", len(frames) - len(got)]]
    return rec
