#!/usr/bin/env python3
"""Randomized differential fuzz of the PyTorch port's decode surface (the
twin of tools/fuzz_differential.py).

Every case draws a random code (K = 3..17 with the top and bottom taps
set, and a 2 % share at K = 18..20 whose draw leaves every other case
as it was; R = 2..4 and a small share up to the kernels' 1/16), a random
regime
(SOFT16 / SOFT8 / HARD8, 30 % wrapping), a random batch and bit count and
pure-noise symbols over the soft range (the tie rules and the renorm get
stressed), and decodes it on two routes of the same device: the kernel
route the decoder picks (rotated warp or block design, lane or plane ACS;
tiled, chain-loaded or plane walk; the plane ACS as one block, a
cluster, or with global-memory metrics from K=20) and the plain scan
(``backend="torch"``).  Each route is held frame by frame to the port's
``ops/numpy_ref.py`` oracle, bit for bit:

  * ragged updates (1-3 chunks) + exact chainback: bits, ``get_error``,
    the renorm total and the final state-order metrics, walked from state
    0 or (30 % of cases) a random end state;
  * a checkpoint at a random cut (``state.to_numpy()`` ->
    ``DecoderState.from_numpy``), then the rest of the symbols: the
    carry, ``row_rots`` included, crosses at a random entry phase;
  * on the plane route, the truncated walk: at block 8, overlap 48 (every
    tile reaches the last row, so it is exact) against the oracle's
    traceback, and at a random short block and overlap against
    :func:`truncated_traceback` over the oracle's decisions;
  * for K <= 13, in 30 % of cases, a random periodic puncture pattern at a
    random phase, re-inflated with the neutral midpoint
    (``ops/encoder.depuncture``), against the oracle on the re-inflated
    stream.

On a card the kernel route launches the CUDA kernels; ``--cpu`` runs
their plain versions on the CPU.  The tool imports no jax.

    python3 tools/torch_fuzz_differential.py [--cases N] [--seed S] [-v]
    python3 tools/torch_fuzz_differential.py --minutes 5     # time-bounded
    python3 tools/torch_fuzz_differential.py --cpu --cases 10

At the end it prints the cases a route, design and arm took.  On the
first mismatch it prints one reproducer line and exits 1.
"""

import argparse
import collections
import dataclasses
import os
import sys
import time
from typing import Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np
import torch

import viterbidecodercpp_torch as pt
from viterbidecodercpp_torch.decoder import DecoderState, select_backend
from viterbidecodercpp_torch.ops import (chainback, encoder, numpy_ref,
                                         rotated, torch_core)
from viterbidecodercpp_torch.puncture import puncture_np

# The categories a long enough run must cover (chip_smoke.py phase 7).
REQUIRED = ("rotated warp", "rotated block", "rotated block K=12/13",
            "tiled walk", "chain walk", "lane", "plane block K=14..16",
            "plane cluster K=17", "plane K>=18", "torch", "truncated walk",
            "puncture arm", "checkpoint arm", "end state != 0")
TRUNC_BLOCK, TRUNC_OVERLAP = 8, 48
# The share of cases at K = 18..20 (clusters of four and eight blocks,
# global-memory metrics), one frame of at most HUGE_MAX_BITS bits (the
# oracle takes ~0.02 s a step at K=20): drawn from a stream of its own,
# so every other seed draws the case it drew before
HUGE_SHARE = 0.02
HUGE_MAX_BITS = 20


class Mismatch(AssertionError):
    """A route disagreed with the oracle on the case of ``seed``;
    ``repro`` is the case's reproducer line."""

    def __init__(self, seed: int, repro: str):
        super().__init__(repro)
        self.seed = seed
        self.repro = repro


@dataclasses.dataclass
class Case:
    seed: int
    code: pt.CodeSpec
    mode: str                             # SOFT16 / SOFT8 / HARD8
    config: pt.DecoderConfig
    batch: int
    total_bits: int
    symbols: np.ndarray                   # (B, T * R) int32
    cuts: Tuple[int, ...]                 # ragged chunk ends, last == T
    checkpoint: Optional[int]             # cut of the checkpoint arm
    short_walk: Tuple[int, int]           # a truncated walk's block, overlap
    puncture: Optional[Tuple[Tuple[bool, ...], int]]   # (pattern, phase)
    end_state: int                        # the walks' and get_error's state

    def describe(self) -> str:
        c = self.code
        return (f"seed={self.seed} K={c.K} R={c.R} G={c.G} {self.mode} "
                f"{self.config.arith} B={self.batch} bits={self.total_bits} "
                f"end={self.end_state}")


def draw(seed: int) -> Case:
    """The case of ``seed``; depends on the seed alone, not the device."""
    rng = np.random.RandomState(seed)
    huge = np.random.RandomState([seed, 18])
    big = rng.rand() < 0.15
    K = int(rng.randint(14, 18) if big else rng.randint(3, 14))
    huge_case = huge.rand() < HUGE_SHARE
    if huge_case:
        big, K = True, int(huge.randint(18, 21))
    R = int(rng.randint(5, torch_core.KERNEL_MAX_RATE + 1)
            if rng.rand() < 0.1 else rng.randint(2, 5))
    mask = (1 << K) - 1
    # top and bottom taps set => the full constraint length is used
    G = tuple(int(g) | 1 | (1 << (K - 1))
              for g in rng.randint(0, mask + 1, R))
    code = pt.CodeSpec(f"fuzz-K{K}", K, G)
    dt = pt.DecodeType(rng.choice(["SOFT16", "SOFT8", "HARD8"]))
    arith = "wrapping" if rng.rand() < 0.3 else "saturating"
    config = pt.get_decode_config(dt, R, arith=arith)
    B = int(rng.randint(1, 3 if big else 5))
    total_bits = int(rng.randint(8, 30 if big else 80))
    if huge_case:
        B, total_bits = 1, min(total_bits, HUGE_MAX_BITS)
    T = total_bits + K - 1
    syms = rng.randint(config.soft_decision_low,
                       config.soft_decision_high + 1,
                       (B, T * R)).astype(np.int32)
    nch = int(rng.randint(1, 4))
    cuts = tuple(int(c) for c in sorted(
        rng.choice(np.arange(1, T), nch - 1, replace=False))) + (T,)
    checkpoint = int(rng.randint(1, T)) if rng.rand() < 0.5 else None
    short_walk = (8 * int(rng.randint(1, 3)), 8 * int(rng.randint(0, 3)))
    puncture = None
    if not big and rng.rand() < 0.3:
        p = int(rng.randint(2, 9))
        pattern = rng.rand(p) < 0.7
        pattern[rng.randint(p)] = True
        puncture = (tuple(bool(x) for x in pattern), int(rng.randint(p)))
    end_state = int(rng.randint(1 << (K - 1))) if rng.rand() < 0.3 else 0
    return Case(seed, code, dt.value, config, B, total_bits, syms, cuts,
                checkpoint, short_walk, puncture, end_state)


def oracle(case: Case, symbols: np.ndarray) -> dict:
    """``numpy_ref`` frame by frame: bits and error at the case's end
    state, renorm total, final state-order metrics (S, B) and each frame's
    (T, S) decisions."""
    bits, err, acc, metrics, decisions = [], [], [], [], []
    for frame in symbols:
        m, dec, a = numpy_ref.acs_run(case.code, case.config, frame)
        bits.append(numpy_ref.traceback(case.code, dec, case.total_bits,
                                        case.end_state))
        err.append(int(m[case.end_state]))
        acc.append(a)
        metrics.append(m)
        decisions.append(dec)
    return {"bits": np.stack(bits), "error": np.asarray(err, np.int64),
            "acc": np.asarray(acc, np.int64),
            "metrics": np.stack(metrics, axis=1), "decisions": decisions}


def truncated_traceback(code: pt.CodeSpec, decisions: np.ndarray,
                        total_bits: int, block: int, overlap: int,
                        end_state: int = 0) -> np.ndarray:
    """The truncated walk's contract over one frame's (T, S) state-order
    decisions: the total_bits + K - 1 rows split into ``block``-row tiles,
    each walked newest to oldest over its block + ``overlap`` rows (rows
    past the last are skipped), from ``end_state`` when its window reaches
    the last row and from state 0 otherwise, committing its own block."""
    n = code.K - 1
    rows = total_bits + n
    out = np.zeros(rows, np.uint8)
    for b0 in range(0, rows, block):
        state = end_state if b0 + block + overlap >= rows else 0
        for r in range(min(b0 + block + overlap, rows) - 1, b0 - 1, -1):
            d = int(decisions[r, state])
            if r < b0 + block:
                out[r] = d
            state = (state >> 1) | (d << (n - 1))
    return out[n:]


def categories(case: Case, route: str) -> list:
    """What the case covers on ``route`` (a kernel route or "torch"): its
    ACS design, its walk design and the arms it runs."""
    spec = torch_core.make_static_spec(case.code, case.config)
    out = []
    if route == "rotated":
        acs = rotated.kernel_design(spec.S, spec.R)
        out.append(f"rotated {acs}")
        if acs == "block" and case.code.K >= 12:
            out.append("rotated block K=12/13")
    elif route == "lane":
        out.append("lane")
    elif route == "plane":
        K = case.code.K
        out.append("plane K>=18" if K >= 18 else "plane cluster K=17"
                   if K == 17 else "plane block K=14..16")
        if K >= 20:
            out.append("plane global K>=20")
        if case.total_bits >= 16:
            out.append("truncated walk")
    else:
        out.append("torch")
    if route in ("rotated", "lane"):
        out.append(f"{chainback.walk_design(spec.W)} walk")
    for arm, on in (("ragged updates", len(case.cuts) > 1),
                    ("checkpoint arm", case.checkpoint is not None),
                    ("puncture arm", case.puncture is not None),
                    ("end state != 0", case.end_state != 0)):
        if on:
            out.append(arm)
    return out


def _np(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().astype(np.int64)


def run_case(seed: int, device="cuda", verbose: bool = False) -> dict:
    """Draw and check one case on both routes of ``device``; raises
    :class:`Mismatch` with the reproducer line on any disagreement.
    Returns the case, the oracle's answers, each route's outputs and the
    categories covered."""
    device = torch.device(device)
    case = draw(seed)
    code, config, B, nbits, end = case.code, case.config, case.batch, \
        case.total_bits, case.end_state
    R = code.R
    spec = torch_core.make_static_spec(code, config)
    want = oracle(case, case.symbols)
    syms = torch.as_tensor(case.symbols, device=device)
    routes = (select_backend(spec, device), "torch")
    desc = case.describe()
    outputs, covered = {}, []

    def check(got, expect, route, arm, what):
        if not np.array_equal(np.asarray(got), np.asarray(expect)):
            raise Mismatch(seed, f"{desc} route={route} arm={arm} ({what} "
                                 f"differ from numpy_ref)")

    def check_state(dec, st, route, arm, expect=want):
        got = {"bits": _np(dec.chainback(st, nbits, end)),
               "error": _np(dec.get_error(st, end)),
               "acc": _np(st.accumulated_error),
               "metrics": _np(st.metrics)}
        for key, what in (("bits", "bits"), ("error", "get_error"),
                          ("acc", "renorm totals"),
                          ("metrics", "final metrics")):
            check(got[key], expect[key], route, arm, what)
        return got

    for route in routes:
        dec = pt.ViterbiDecoder(code, config, backend=route,
                                traceback_length=nbits, device=device)
        st = dec.reset(B)
        prev = 0
        for cut in case.cuts:
            st = dec.update(st, syms[:, prev * R:cut * R])
            prev = cut
        outputs[route] = check_state(dec, st, route,
                                     f"ragged{list(case.cuts)}")
        covered += categories(case, route)
        if route == "plane" and nbits >= 16:
            trunc = dec.chainback(st, nbits, end, mode="truncated",
                                  block=TRUNC_BLOCK, overlap=TRUNC_OVERLAP)
            check(_np(trunc), want["bits"], route,
                  f"truncated({TRUNC_BLOCK}/{TRUNC_OVERLAP})", "bits")
            block, overlap = case.short_walk
            trunc = dec.chainback(st, nbits, end, mode="truncated",
                                  block=block, overlap=overlap)
            check(_np(trunc), np.stack([
                truncated_traceback(code, d, nbits, block, overlap, end)
                for d in want["decisions"]]), route,
                f"truncated({block}/{overlap})", "bits")
        if case.checkpoint is not None:
            cut = case.checkpoint
            st = dec.update(dec.reset(B), syms[:, :cut * R])
            st = DecoderState.from_numpy(st.to_numpy(), device=device)
            st = dec.update(st, syms[:, cut * R:])
            check_state(dec, st, route, f"checkpoint@{cut}")
        if case.puncture is not None:
            pattern, phase = case.puncture
            keep = pt.PunctureSpec("fuzz-pi", pattern).mask(
                case.symbols.shape[1], phase)
            dep = encoder.depuncture(
                torch.as_tensor(puncture_np(case.symbols, keep),
                                device=device), keep, 0)
            arm = (f"puncture {''.join('1' if x else '0' for x in pattern)}"
                   f"@{phase}")
            check_state(dec, dec.update(dec.reset(B), dep), route, arm,
                        oracle(case, dep.cpu().numpy()))
    if verbose:
        print("ok", desc, f"routes={'/'.join(routes)}", flush=True)
    return {"case": case, "want": want, "outputs": outputs,
            "categories": sorted(set(covered))}


def run(cases: Optional[int], seed: int = 0, device="cuda",
        minutes: Optional[float] = None, verbose: bool = False,
        log=None) -> dict:
    """Run ``cases`` seeded cases (seed, seed + 1, ...), or as many as fit
    in ``minutes``; raises :class:`Mismatch` at the first disagreement.
    Returns the case count, the seconds and the count of each category."""
    log = log or (lambda line: None)
    counts = collections.Counter()
    t0 = time.perf_counter()
    n = 0
    while True:
        if minutes is not None:
            if time.perf_counter() - t0 >= minutes * 60:
                break
        elif n >= cases:
            break
        counts.update(run_case(seed + n, device, verbose)["categories"])
        n += 1
        if n % 50 == 0:
            log(f"[fuzz] {n} cases clean "
                f"({(time.perf_counter() - t0) / 60:.1f} min)")
    return {"cases": n, "seconds": time.perf_counter() - t0,
            "counts": dict(sorted(counts.items()))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", type=int, default=50)
    ap.add_argument("--minutes", type=float, default=None,
                    help="run for this long instead of --cases")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the first case (then seed + 1, ...)")
    ap.add_argument("-v", action="store_true", help="print every case")
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU "
                         "instead of the kernels on the card")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_fuzz_differential: no CUDA card "
                 "(torch.cuda.is_available() is false); pass --cpu to run "
                 "on the CPU")
    device = "cpu" if args.cpu else "cuda"
    try:
        r = run(args.cases, args.seed, device, args.minutes, args.v,
                log=lambda line: print(line, flush=True))
    except Mismatch as exc:
        print(f"[fuzz] MISMATCH {exc.repro}")
        print(f"[fuzz] reproduce: python3 tools/torch_fuzz_differential.py "
              f"--seed {exc.seed} --cases 1 -v{' --cpu' if args.cpu else ''}")
        return 1
    print(f"[fuzz] coverage: {r['counts']}")
    missing = [c for c in REQUIRED if not r["counts"].get(c)]
    if missing:
        print(f"[fuzz] not covered by these cases: {missing}")
    print(f"[fuzz] DONE: {r['cases']} cases in {r['seconds']:.1f} s "
          f"({r['cases'] / max(r['seconds'], 1e-9):.2f} cases/s) on "
          f"{device}, 0 mismatches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
