#!/usr/bin/env python3
"""The BER loop's two host schedules, side by side on one card.

    python3 tools/torch_ber_loop_ab.py [--out FILE] [--batches N]

``ber.measure_point`` reads each batch's error count on the host before
it starts the next batch (one sync a batch).  The other schedule here
enqueues batch i+1 before it reads batch i's count (copied to pinned
memory behind an event) and drops batch i+1 uncounted when batch i met a
stop: the same draws, the same totals, and the card never waits for the
host's read.  It did not gain on an H100 (PERF.md): the host's
enqueue of each batch's ~80 operations, not the read, sets the pace.

On one CUDA card, at Voyager K=7 R=1/2 SOFT8, 2048-bit blocks, an Eb/No
at which no error stop fires and a fixed budget of N batches of 256
frames (N/4 of 1024), the script

* checks both schedules give the same ``BerPoint`` at 3 dB (the bit
  stop) and with ``max_errors`` 1000 at 2 dB (the error stop), 16 frames
  a batch;
* times both in turns - one sync, lookahead, lookahead, one sync - in
  three rounds, at B=256 and B=1024 (host clock around the point: it
  ends in a host read), and ``ViterbiDecoder.decode`` alone at the same
  shapes (CUDA events);
* profiles 24 batches of each schedule at both B with ``torch.profiler``:
  the device's busy time and its idle share of the window;
* counts the operations that synchronise the host with the card in 8
  batches of each schedule (``torch.cuda.set_sync_debug_mode``), and
  where they were called.

Prints the card's name and power limit and one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch

CODE, MODE, BLOCK, EBNO_DB = "Voyager", "SOFT8", 2048, 6.0
TURNS = ("one_sync", "lookahead", "lookahead", "one_sync")


def lookahead_point(code, config, EbNo_dB, *, generator, block_bits, batch,
                    max_bits, max_errors=10_000, device="cuda"):
    """``ber.measure_point`` (no timeout) with batch i+1 enqueued before
    batch i's count is read."""
    from viterbidecodercpp_torch import ber
    from viterbidecodercpp_torch.decoder import ViterbiDecoder

    dec = ViterbiDecoder(code, config, traceback_length=block_bits,
                         device=device)
    step = batch * block_bits
    max_bits, max_errors = ber.capped_budgets(max_bits, max_errors, step)

    def enqueue():
        syms, tx = ber.draw_batch(code, config, EbNo_dB, generator, batch,
                                  block_bits)
        count = ber.decode_errors(dec, syms, tx)
        host = torch.empty((), dtype=torch.int32, pin_memory=True)
        host.copy_(count, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    bits = errors = 0
    if max_bits > 0 and max_errors > 0:
        pending = enqueue()
        while True:
            bits += step
            ahead = enqueue() if bits < max_bits else None
            pending[1].synchronize()
            errors += int(pending[0])
            if ahead is None or errors >= max_errors:
                break
            pending = ahead
    return ber.BerPoint(EbNo_dB=float(EbNo_dB),
                        ber=errors / bits if bits else 0.0,
                        total_bits=bits, total_bit_errors=errors)


def host_syncs(fn) -> list:
    """The synchronising CUDA operations of one call of ``fn``, as the
    ``file:line`` that called each."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--batches", type=int, default=256,
                    help="timed batches of 256 frames (N/4 of 1024)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_ber_loop_ab: needs a CUDA card")
    import viterbidecodercpp_torch as pt
    from chip_smoke import card_line, profile_idle, time_ms
    from viterbidecodercpp_torch import ber

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    code = pt.get_code(CODE)
    cfg = pt.get_decode_config(pt.DecodeType(MODE), code.R)

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def point(who, EbNo, B, max_bits, seed, max_errors=10_000):
        kw = dict(generator=gen(seed), block_bits=BLOCK, batch=B,
                  max_bits=max_bits, max_errors=max_errors, device=dev)
        if who == "one_sync":
            return ber.measure_point(code, cfg, EbNo, **kw)
        return lookahead_point(code, cfg, EbNo, **kw)

    res = {"card": card, "code": f"{CODE} {MODE}", "block_bits": BLOCK,
           "EbNo_dB": EBNO_DB}
    # the same draws, the same totals: the bit stop and the error stop
    for EbNo, max_errors in ((3.0, 10_000), (2.0, 1000)):
        a, b = (point(w, EbNo, 16, 40 * 16 * BLOCK, 7, max_errors)
                for w in ("one_sync", "lookahead"))
        if a != b:
            raise SystemExit(f"schedules differ at {EbNo} dB: {a} vs {b}")
        res.setdefault("checked_equal", []).append(dataclasses.asdict(a))
    for B in (256, 1024):
        n = args.batches * 256 // B
        budget = n * B * BLOCK
        times = {}
        for who in TURNS * 3:
            point(who, EBNO_DB, B, 4 * B * BLOCK, 1)      # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = point(who, EBNO_DB, B, budget, 2)
            s = time.perf_counter() - t0
            if p.total_bits != budget:
                raise SystemExit(f"{who} B={B} stopped early: {p}")
            times.setdefault(who, []).append(s)
        syms, _ = ber.draw_batch(code, cfg, EBNO_DB, gen(3), B, BLOCK)
        dec = pt.ViterbiDecoder(code, cfg, traceback_length=BLOCK,
                                device=dev)
        syms = syms.reshape(B, -1)
        dec_ms = time_ms(lambda: dec.decode(syms, BLOCK))
        row = {"batches": n, "bits": budget, "decode_ms": dec_ms,
               "decode_bits_per_s": B * BLOCK / (dec_ms / 1e3)}
        for who, ts in times.items():
            med = statistics.median(ts)
            row[who] = {"seconds": ts, "bits_per_s": budget / med,
                        "ms_per_batch": med / n * 1e3,
                        "overhead_share": 1 - row["decode_ms"]
                        / (med / n * 1e3),
                        "profile_24_batches": profile_idle(
                            lambda: point(who, EBNO_DB, B, 24 * B * BLOCK,
                                          4))}
            syncs = host_syncs(lambda: point(who, EBNO_DB, B, 8 * B * BLOCK,
                                             5))
            row[who]["syncs_per_batch"] = len(syncs) / 8
            row[who]["sync_sites"] = sorted(set(syncs))
        res[f"B={B}"] = row
        print(f"B={B}: " + ", ".join(
            f"{who} {row[who]['bits_per_s']:.4e} bits/s "
            f"(idle {row[who]['profile_24_batches']['idle_share']:.3f}, "
            f"{row[who]['syncs_per_batch']} syncs a batch)"
            for who in ("one_sync", "lookahead"))
            + f"; decode alone {row['decode_bits_per_s']:.4e} bits/s, "
              f"on {card}", flush=True)
    out = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    print(out, flush=True)


if __name__ == "__main__":
    main()
