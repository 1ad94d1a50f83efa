#!/usr/bin/env python3
"""Smoke run of the PyTorch port (viterbidecodercpp_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and exits non-zero:

1. Device: requires ``torch.cuda.is_available()``, prints the card's
   name and power limit (nvidia-smi), builds all eight CUDA kernels from
   ``viterbidecodercpp_torch/csrc`` with nvcc for sm_90a, one nvcc
   process per source, and the native host chain (``native/sigchain.cpp``)
   with g++, all started together (into ``viterbidecodercpp_torch/_build/``),
   and prints the build times.
2. Kernel vs plain on the card, bit-exact, across every dispatch boundary
   of the rotated ACS (warp design for S <= 1024 and R <= 5, block design
   above) and the walk (tiled for W <= 8, dependent loads above): the five
   rotated-class registry codes x SOFT16/SOFT8/HARD8 x
   saturating/wrapping, plus random codes at K=8, 10, 11, 12, 13 (R=2),
   K=8 R=5, K=10 R=6 and K=9 R=16, at B=61 and T in {1, n-1, 301} from
   off-reset metrics, symbols past the soft range; on the same rows the
   walk in slot order (streamed and one-shot rotations, with and without
   a valid mask) and in state order (with and without a valid mask).
2b. The same for the plane class: the plane ACS kernel on Cassini x the
   three regimes x both arithmetic modes and random K=14, K=16 and K=17
   R=1/2 codes, and at the boundaries of its branch-pattern tables a
   K=15 R=1/8 SOFT16 wrapping code (a full 8-rate table), a K=14 R=1/11
   HARD8 code (two tables) and a K=17 R=1/6 code (the cluster at
   Cassini's rate), each at B=1 with T = 1 and n-1 and at B=20, T=301,
   from off-reset metrics (metrics, packed rows, acc); on the B=20 rows
   the frame-major walk at B=1 and B=20 over N in {1, G-1, G, G+1, 301}
   rows (G the walk's group size) with random rotations and a valid mask
   zero on group edges, with rotations alone and with neither, and the
   truncated walk at block=64/overlap=96, at 16/48 over 37 rows and at
   its defaults.
2c. The same for the lane class, across every tile and gate boundary of
   the lane ACS kernel: Basic K=3, Basic K=5 and random K=2 (R=3), K=4
   (R=5), K=6 (R=4), K=5 (R=9), K=2 (R=16) and K=6 (R=16) codes (both
   kinds of branch-metric table, the rate loop of R > 5, the 2-step tile)
   x the three regimes x both arithmetic modes, at B in {1, 3, 100}
   (frames past B in a live warp) x T in {1, 31, 32, 33} (partial tiles)
   and at B=100 T=301 into an ``out`` slice of a larger buffer (rows
   outside it untouched), from off-reset metrics, symbols past the soft
   range, and from entry metrics near metric_max (the renorm vote fires);
   on the B=100 rows the state-order walk kernel.
2d. The plane ACS past K=17: random K=18 and K=19 codes (clusters of
   four and eight blocks; cudaOccupancyMaxActiveClusters printed) and
   K=20, 21 and 22 codes (the persistent global-metric kernel; its
   resident blocks, grid and tiles a block printed), at R=2 and R=6, both
   arithmetic modes, at (B, T) = (1, 1) from the reset metrics, (1, n-1)
   from random metrics near metric_max and (3, 2n+3) from both, at
   phase0 != 0, the B=3 calls into an ``out`` buffer at ``row0=2``
   (metrics, words, acc, the whole buffer); then K=23 at B=3, T=2n+3
   from both starts, more tiles than the card's resident blocks, so
   each block steps several; on the B=3 rows the exact and the
   truncated walk.
3. The flagship path at full size: Voyager K=7 R=1/2 SOFT8, B=1024
   frames x 2048 trellis steps (2042 random data bits + 6 tail bits per
   frame), encoded on the card, mild numpy noise, decoded by
   ``ViterbiDecoder(...).decode`` on CUDA tensors.  Every frame must
   decode exactly, both kernels must have launched, and bits, final
   metrics and acc must equal the plain state-order scan
   (ops/torch_core.py) run on the card.  Repeated through reset + three
   ragged updates + chainback.
3b. The big-state path at full size: Cassini K=15 R=1/6 SOFT16, B=512
   frames x 2062 trellis steps (2048 data bits + 14 tail bits), the same
   checks, plus ``chainback(mode="truncated")`` at its defaults equal to
   the exact bits; all three plane kernels must have launched.
3c. The lane path at full size: Basic K=5 R=1/2 SOFT16, B=512 frames x
   2052 trellis steps (2048 data bits + 4 tail bits), the same checks as
   phase 3; the lane ACS and the state-order walk must have launched.
3d. Streaming at full size, ``StreamingDecoder.push`` on three routes:
   Voyager SOFT16 B=1024 window 256 chunk 64 (rotated ACS + slot-order
   walk), Basic K=5 SOFT16 B=1024 window 160 chunk 32 (lane ACS +
   state-order walk), Cassini SOFT16 B=512 window 280 chunk 56 (plane ACS
   + plane walk); 2048 data bits per frame plus the tail and window+chunk
   flush rows.  Each stream must equal the data sent on mild noise, equal
   the same stream through the plain versions of its kernels on the card
   (bits, valid, final metrics, ring), have launched its kernels and
   have replayed its CUDA graph at every push after the first.  Then
   Voyager on an AWGN channel (utils/testsig.py): the bit-error delta of
   windows 64, 128 and 256 against the exact decode of the same symbols.
3e. K >= 18 at full width: a K=18 R=1/2 SOFT16 code, B=64 x 2048
   noise-free data bits (a 2.2 GB decision buffer), through
   ``ViterbiDecoder.decode`` on the cluster of four blocks: every frame
   equal to its data, the first 8 frames' bits, get_error and acc equal
   to the plain versions on the card, and the ACS kernel's metrics,
   words and acc on them equal to plain; the same stream through
   ``StreamingDecoder`` (window 288, chunk 32) equal to the data; K=20
   and K=21 decodes of B=4 x 512 bits on the global-metric kernel, equal
   to the data and to the plain versions.
4. Times on the card (CUDA events, warm-up, median): each kernel and its
   plain version at its path's full-size shape beside its bound (the
   larger of its bytes over the HBM rate and its int32 operations over
   the int32 rate, counted from the shapes; an ACS step counts its 2^R
   branch metrics once a frame) and its share of the bound,
   each whole decode in decoded symbols/s (B*T*R / s), and each stream's
   median ms per push (of 41, each into the state the last returned: a
   push is host-bound) and streamed
   symbols/s (B*chunk*R / s).
4e. The two plane ACS routes past K=17 beside their bounds: the cluster
   kernel at K=18 (B=64 x 2065 steps) and K=19 (B=16 x 530), the
   global-metric kernel at K=20 and K=21 (B=4 x 531 and 532; its grid,
   tiles a block and resident blocks), kernel and plain time, time a
   trellis step, bound and share, the call's kernels' device time and
   the host's time to enqueue the call.
4f. The BER channel kernel (``csrc/awgn_channel.cu``) at the voyager-ber
   cell's batch, Voyager SOFT8 B=16384 x 2048 bits at 6 dB: equal to its
   plain version (``testsig.quantise`` of ``testsig.modulate_encode`` on
   the same noise), kernel and plain time beside its bytes bound.
4d. The BER loop's times (``ber.measure_point``): Voyager SOFT8, 2048-bit
   blocks, 6 dB (no error stop fires), 256 batches of 256 frames and 64
   of 1024, after one batch of ``ber.draw_batch`` at each B held to the
   plain chain (``awgn_quantize(modulate_encode(...))`` after the same
   ``randint``: symbols, bits and the generator's state equal) and with
   the channel kernel's launches counted, one a batch of the timed
   points: decoded data bits/s (median of three points, host clock),
   ``decode`` alone at the same shape (CUDA events), the loop's overhead
   share, the device's idle share over 24 batches (``torch.profiler``),
   and one host-chain point's bits/s (4 batches of 256).
5. The BER engine against the reference curves: ``measure_point`` on the
   card at the 48 points tests/test_ber.py gates (8 registry codes x 3
   regimes x 2 Eb/No; 4096-bit blocks, 1024 for Cassini; budgets for >=
   10^4 expected errors, at most 6e7 bits) and the Cassini SOFT16 0.5 dB
   host-chain point, each inside test_ber.py's window (1.3x, widened to
   5 sigma) of ``data_ber_reference_*.json`` and with at least one error;
   the rotated, lane and plane kernels must have launched, and the
   channel kernel once a batch; before each point one batch of
   ``ber.draw_batch`` at its shape (256 frames of its block) equal to the
   plain chain as in phase 4d.
5b. DAB FIC punctured decode (K=7 R=1/4, 21 x PI_16 + 3 x PI_15 + PI_X)
   in the three regimes on the card, as
   ``tools/torch_run_punctured_decoder.py`` runs it: 0 bit errors.
6. The parallel layer (``viterbidecodercpp_torch/parallel``): the script
   spawns itself as 4 gloo ranks sharing the first card (halos and
   counters staged through host memory) and, on a machine with two or
   more cards, as min(4, cards) NCCL ranks, one a card; any rank's
   failure fails the run.  The ranks load the kernels phase 1 built (none
   rebuilds) and drive, at full width: time-SP of Voyager SOFT16 (rotated
   route) and Basic K=5 SOFT16 (lane route), B=1024 x 131072 data bits,
   overlaps 256 and 160, and Cassini SOFT16 (plane route), B=128 x 16384
   bits, overlap 128, over a time axis of all ranks, all through the AWGN
   channel at 3 dB; the Voyager stream again on a (data=2, time=2) mesh;
   frame-DP of Voyager SOFT8, 1024 frames x 2042 bits a rank at 2 dB; and
   data-parallel BER points (``group=``), Voyager SOFT8, 2048-bit blocks,
   256 frames a rank, 8 batches at 6 and 2 dB (the channel kernel must
   have launched in them).  The parent holds every SP
   result to the single-process ``ViterbiDecoder.decode`` of the same
   stream on the card (0 halo mismatches), the frame-DP bits and error
   total to one decode of all ranks' frames and the ranks' own counts, and
   the BER totals to the sum of the ranks' own points from the same
   generators.  Each rank then holds the layer through the kernels to the
   layer through their plain versions (``plain=True``) on its own
   full-width tile of each time-SP case above, with the shapes,
   rotations, uniform starts and ``valid`` mask the main path gave the
   kernels, and to the plain versions and the plain scan at B=61, a
   301-row tile a rank, overlap 64, with and without 150 rows of padding
   past ``total_rows`` on the three routes (bits and mismatch count).  It
   prints each rank's tile and exchange time (CUDA events), the whole
   call (host clock) and the single-process decode's time.
7. The harness on the card, in this process (each tool's function, no
   subprocess): ``tools/torch_run_tests.py``'s matrix (3 regimes x the 8
   registry codes x 2 arithmetic modes x the kernel route and the plain
   scan; 0 failures and exactly the reference's one skip),
   ``torch_run_simple.py`` (DAB Radio, 0 bit errors),
   ``torch_run_streaming.py`` for Voyager (rotated route) and Cassini
   (plane route), 0 bit errors,
   ``torch_ber_truncated_delta.py`` at 2^18 bits (its BER delta printed;
   its first batch's plane ACS, exact and truncated walk at B=64 x 1040
   rows, block 512, overlap 160, equal to their plain versions),
   and ``FUZZ_CASES`` fixed seeded cases of ``torch_fuzz_differential.py``
   against ``ops/numpy_ref.py`` on both routes: 0 mismatches, and every
   category of its ``REQUIRED`` reached (rotated warp and block, K=12/13
   block, tiled and chain walks, lane, plane K=14..16 and the K=17
   cluster, K >= 18, the truncated walk, the puncture and checkpoint
   arms); ``torch_run_benchmark.py`` on the kernel routes (Voyager SOFT8
   B=1024, Cassini SOFT16 B=512, the K=18 code B=64; -T 0.5), its rows
   read by the unmodified ``parse_benchmark.py`` and
   ``compare_benchmark.py`` in subprocesses (exit 0), and
   ``torch_profile_trace.py voyager`` (8 decodes; top device operations,
   idle share).  All seven decode kernels must
   have launched (none of these tools runs the BER channel kernel); their
   counts join the kernels line.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is a JSON object with one entry per kernel (kernel launches on the main
paths: one a call, the global plane ACS's persistent kernel too;
largest difference from the plain version, ms, plain_ms, bound_ms,
bound_by, bound_share, library_ms), the decode and stream times and the
BER loop's, phase 6's results and times and phase 7's counts and
seconds.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROTATED_CODES = ("Voyager", "LTE", "DAB Radio", "CDMA IS-95A", "CDMA 2000")
MODES = ("SOFT16", "SOFT8", "HARD8")
ARITHS = ("saturating", "wrapping")
REPS = 7
PLAIN_REPS = 3
PUSH_REPS = 41
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "rotated_acs": ("viterbidecodercpp_torch/csrc/rotated_acs.cu",
                    "viterbidecodercpp_tpu/ops/rotated_pallas.py:209"),
    "chainback": ("viterbidecodercpp_torch/csrc/chainback.cu",
                  "viterbidecodercpp_tpu/ops/chainback_pallas.py:60"),
    "plane_acs": ("viterbidecodercpp_torch/csrc/plane_acs.cu",
                  "viterbidecodercpp_tpu/ops/bigstate_pallas.py:119"),
    "plane_acs_global": ("viterbidecodercpp_torch/csrc/plane_acs_global.cu",
                         "viterbidecodercpp_tpu/ops/bigstate_pallas.py:119"),
    "plane_walk": ("viterbidecodercpp_torch/csrc/plane_walk.cu",
                   "viterbidecodercpp_tpu/ops/bigstate_pallas.py:535"),
    "plane_walk_trunc": ("viterbidecodercpp_torch/csrc/plane_walk_trunc.cu",
                         "viterbidecodercpp_tpu/ops/bigstate_pallas.py:713"),
    "lane_acs": ("viterbidecodercpp_torch/csrc/lane_acs.cu",
                 "viterbidecodercpp_tpu/ops/acs_pallas.py:125"),
    # none: XLA fuses the JAX package's encode -> AWGN -> quantise chain
    "awgn_channel": ("viterbidecodercpp_torch/csrc/awgn_channel.cu", None),
}
# the kernels of a decode (every tool of phase 7 launches them)
DECODE_KERNELS = tuple(k for k in KERNELS if k != "awgn_channel")
# (code, mode, B, window, chunk, route, the route's kernels)
STREAMS = (
    ("Voyager", "SOFT16", 1024, 256, 64, "rotated",
     ("rotated_acs", "chainback")),
    ("Basic K=5 R=1/2", "SOFT16", 1024, 160, 32, "lane",
     ("lane_acs", "chainback")),
    ("Cassini", "SOFT16", 512, 280, 56, "plane", ("plane_acs", "plane_walk")),
)
# phase 2's random codes (K, R, mode) beside the registry's K=7 and K=9:
# each n of the class and each group count of the ACS's branch patterns
ROTATED_RANDOM = ((8, 2, "SOFT8"), (10, 2, "SOFT16"), (11, 2, "HARD8"),
                  (12, 2, "SOFT8"), (13, 2, "SOFT8"), (8, 5, "SOFT8"),
                  (10, 6, "SOFT16"), (9, 16, "SOFT8"))
# phase 2c's random codes (K, R) beside Basic K=3 and K=5 (R=2): every n of
# the class, the per-lane branch metrics (2^R > S), the rate loop of R > 5
# and the smallest symbol tile (K=2 R=16: 2 steps)
LANE_RANDOM = ((2, 3), (4, 5), (6, 4), (5, 9), (2, 16), (6, 16))
LANE_B = (1, 3, 100)
LANE_T = (1, 31, 32, 33, 301)
# phase 2b's random codes (K, R, mode, arith) beside Cassini (K=15, R=6):
# every n of the class, a full 8-rate pattern table, two tables (R > 8) and
# the K=17 cluster at Cassini's rate
PLANE_RANDOM = ((14, 2, "SOFT8", "saturating"),
                (16, 2, "SOFT8", "saturating"),
                (17, 2, "SOFT8", "saturating"),
                (15, 8, "SOFT16", "wrapping"),
                (14, 11, "HARD8", "saturating"),
                (17, 6, "SOFT16", "saturating"))
# phase 2d's codes past K=17: the cluster kernel's 4 and 8 blocks (K=18,
# 19) and the global-metric kernel (K=20, 21, 22), at R=2 and Cassini's R=6
BIG_PLANE_K = (18, 19, 20, 21, 22)
BIG_PLANE_R = (2, 6)
# each spec's calls: (B, T as an index into (1, n-1, 2n+3), start)
BIG_PLANE_CALLS = ((1, 0, "reset"), (1, 1, "near max"), (3, 2, "reset"),
                   (3, 2, "near max"))
# and K=23 at B=3: 1536 tiles of the global kernel, more than the blocks
# an H100 holds at once (at most 8 an SM), so each block steps several
MULTI_TILE_K = 23
MULTI_TILE_CALLS = ((3, 2, "reset"), (3, 2, "near max"))
# phase 3e: K >= 18 at full width.  The K=18 code (taps set at both
# ends), SOFT16, B=64 x 2048 data bits (the cluster of four blocks; the
# first frames held to the plain versions), its stream, and the wider
# codes K=20 and K=21 at B=4 x 512 bits (the global-metric kernel)
BIG_TAPS = (0o12345, 0o7651)
K18_B, K18_BITS, K18_PLAIN_FRAMES = 64, 2048, 8
K18_WINDOW, K18_CHUNK = 288, 32
WIDE_K, WIDE_B, WIDE_BITS = (20, 21), 4, 512
# phase 4e's shapes: (K, B, data bits); K=19 at 16 frames, two waves of
# its cudaOccupancyMaxActiveClusters
BIG_TIMES = ((18, K18_B, K18_BITS), (19, 16, 512), (20, WIDE_B, WIDE_BITS),
             (21, WIDE_B, WIDE_BITS))
SWEEP_EBNO_DB = 3.0
SWEEP_WINDOWS = (64, 128, 256)
SWEEP_CHUNK = 32
SWEEP_END_BITS = 64
# phase 4d: the BER loop at an Eb/No where no error stop fires (a few
# errors in 1e8 bits), a fixed budget of LOOP_BATCHES batches of 256
# frames (a quarter as many of 1024)
LOOP_CODE, LOOP_MODE, LOOP_BLOCK, LOOP_EBNO_DB = "Voyager", "SOFT8", 2048, 6.0
LOOP_BATCHES = 256
LOOP_PROFILE_BATCHES = 24
HOST_CHAIN_BATCHES = 4
# phase 5: the points tests/test_ber.py gates (code -> regime -> Eb/No)
# and the reference curves they are held against
BER_POINTS = {
    "Voyager": {"SOFT16": (2.0, 3.0), "SOFT8": (2.0, 3.0),
                "HARD8": (3.0, 4.0)},
    "CDMA IS-95A": {"SOFT16": (2.0, 2.5), "SOFT8": (2.0, 2.5),
                    "HARD8": (3.0, 3.5)},
    "Cassini": {"SOFT16": (0.0, 0.5), "SOFT8": (0.5, 1.0),
                "HARD8": (1.5, 2.0)},
    "Basic K=3 R=1/2": {"SOFT16": (2.0, 3.0), "SOFT8": (2.5, 3.5),
                        "HARD8": (3.5, 4.5)},
    "Basic K=5 R=1/2": {"SOFT16": (2.0, 3.0), "SOFT8": (2.5, 3.5),
                        "HARD8": (3.5, 4.5)},
    "LTE": {"SOFT16": (1.5, 2.5), "SOFT8": (1.5, 2.5), "HARD8": (2.5, 3.5)},
    "DAB Radio": {"SOFT16": (1.5, 2.5), "SOFT8": (1.5, 2.5),
                  "HARD8": (2.5, 3.5)},
    "CDMA 2000": {"SOFT16": (1.0, 2.0), "SOFT8": (1.0, 2.0),
                  "HARD8": (2.0, 3.0)},
}
BER_FILES = {"Voyager": "data_ber_reference_voyager.json",
             "CDMA IS-95A": "data_ber_reference_k9_k15.json",
             "Cassini": "data_ber_reference_k9_k15.json",
             "Basic K=3 R=1/2": "data_ber_reference_5codes.json",
             "Basic K=5 R=1/2": "data_ber_reference_5codes.json",
             "LTE": "data_ber_reference_5codes.json",
             "DAB Radio": "data_ber_reference_5codes.json",
             "CDMA 2000": "data_ber_reference_5codes.json"}
# the host-chain point (code, regime, Eb/No, seed), block 1024, 64 frames
BER_HOST_CHAIN = ("Cassini", "SOFT16", 0.5, 3)
# tests/test_ber.py's window is Poisson's, but Viterbi errors come in
# bursts (one error event flips ~5-30 bits), so the count of a point
# spreads several times wider than Poisson's at its 300 expected errors:
# phase 5 draws for 10^4 (same cap, same window)
BER_WANT_ERRORS = 10_000
BER_KERNELS = ("rotated_acs", "chainback", "lane_acs", "plane_acs",
               "plane_walk", "awgn_channel")
# phase 4f: the channel kernel at the voyager-ber cell's batch
CHANNEL_B, CHANNEL_BITS = 16384, 2048


# Peak rates of one H100 SXM (NVIDIA's data sheet; the Hopper white paper
# for the SM layout): HBM3 at 3.35 TB/s, and int32 ALU work at 132 SMs x
# 64 INT32 lanes x 1.98 GHz boost clock.  The kernels do int32 work only.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations a trellis state costs per step: two adds, two clamps, a
# compare, a select and a share of the decision word.  A step has only 2^R
# distinct branch metrics, each a sum of R distances, so the branch metric
# costs R 2^R a step a frame, not R a state.  A walk row costs ~8 per frame.
ACS_OPS = 8
WALK_OPS = 8


def acs_bound(S: int, B: int, T: int, R: int, W: int) -> tuple:
    """(ms, resource) of an ACS call: metrics in and out, symbols in,
    decision words and acc out; the step's 2^R branch metrics once a
    frame and ACS_OPS a state."""
    nbytes = 4 * (2 * S * B + B * T * R + T * W * B + B)
    return bound(B * T * (S * ACS_OPS + R * 2 ** R), nbytes)


def walk_bound(rows: int, B: int, out_bits: int, meta: int) -> tuple:
    """(ms, resource) of a walk: one word per row per frame (the word the
    path needs), ``meta`` int32 per row (rotation, valid), the start
    states, and ``out_bits`` bytes out per frame."""
    nbytes = 4 * rows * B + 4 * meta * rows + 4 * B + out_bits * B
    return bound(rows * B * WALK_OPS, nbytes)


def bound(ops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    require(a.shape == b.shape and a.dtype == b.dtype,
            f"shape/dtype mismatch {tuple(a.shape)} {a.dtype} vs "
            f"{tuple(b.shape)} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def time_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median CUDA-event time of ``reps`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def profile_idle(fn) -> dict:
    """``torch.profiler`` over one call of ``fn``: the device's busy time
    (the kernels' own time) and its idle share of the wall-clock window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    busy = 0.0
    for e in prof.key_averages():
        # an aten:: operator's self device time is that of the kernels it
        # launched, which appear under their own names: count those only
        if e.key.startswith("aten::"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        busy += max(us, 0)
    require(busy > 0, "the profiler saw no device time")
    return {"window_ms": window_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / window_us}


def phase2(pt, torch_core, rotated, chainback, dev, rng) -> dict:
    """Kernel vs plain across the rotated class and each dispatch
    boundary of the two kernels; returns the largest difference seen per
    kernel (0 when bit-exact)."""
    err = {"rotated_acs": 0, "chainback": 0}
    specs = []
    for name in ROTATED_CODES:
        code = pt.get_code(name)
        for mode in MODES:
            for arith in ARITHS:
                cfg = pt.get_decode_config(pt.DecodeType(mode), code.R,
                                           arith=arith)
                specs.append((f"{name} {mode} {arith}",
                              torch_core.make_static_spec(code, cfg)))
    # every n of the class (the ACS is a template on n up to the warp
    # design's S = 1024, the block design above; the walk's ring takes
    # W <= 8) and every group count of the branch patterns (5 rates each)
    for K, R, mode in ROTATED_RANDOM:
        c = random_code(pt, K, rng, R)
        specs.append((f"{c.name} {mode} saturating",
                      torch_core.make_static_spec(
                          c, pt.get_decode_config(pt.DecodeType(mode), R))))
    B = 61                        # not a multiple of any frames-per-block
    for label, spec in specs:
        n = spec.K - 1
        for T in (1, n - 1, 301):
            syms = torch.as_tensor(
                rng.randint(spec.soft_low - 2, spec.soft_high + 3,
                            (B, T, spec.R)).astype(np.int32), device=dev)
            m0 = torch_core.initial_metrics(spec, B, 0, dev)
            # start off the reset state so every slot carries a live metric
            m0 = torch.minimum(m0, torch.as_tensor(
                rng.randint(0, spec.metric_max + 1, m0.shape)
                .astype(np.int32), device=dev))
            got = rotated.acs_rotated(spec, m0, syms)
            torch.cuda.synchronize()
            want = rotated.acs_rotated_ref(spec, m0, syms)
            e = max(max_abs_diff(g, w) for g, w in zip(got, want))
            err["rotated_acs"] = max(err["rotated_acs"], e)
            require(e == 0, f"rotated ACS kernel != plain for {label} T={T} "
                            f"(max abs diff {e})")
            rots = torch.as_tensor(rng.randint(0, n, T).astype(np.int32),
                                   device=dev)
            valid = torch.as_tensor((rng.rand(T) > 0.2).astype(np.int32),
                                    device=dev)
            starts = torch.as_tensor(rng.randint(0, spec.S, B)
                                     .astype(np.int32), device=dev)
            for kw in ({"slot_order": True, "rots": rots},
                       {"slot_order": True},
                       {"slot_order": True, "rots": rots, "valid": valid},
                       {}, {"valid": valid}):
                walk = chainback.walk_rows(spec, got[1], starts, **kw)
                torch.cuda.synchronize()
                e = max_abs_diff(walk, chainback.walk_rows_ref(
                    spec, got[1], starts, **kw))
                err["chainback"] = max(err["chainback"], e)
                require(e == 0, f"walk kernel != plain for {label} T={T} "
                                f"{sorted(kw)}")
            if T > n:
                walk = chainback.chainback(spec, got[1], starts, T - n,
                                           slot_order=True, rots=rots)
                torch.cuda.synchronize()
                e = max_abs_diff(walk, chainback.chainback_ref(
                    spec, got[1], starts, T - n, slot_order=True, rots=rots))
                err["chainback"] = max(err["chainback"], e)
                require(e == 0, f"chainback kernel != plain for {label}")
    print(f"phase2 ok: {len(specs)} specs (K=7..13, R up to 16) at B={B}, "
          f"T in (1, n-1, 301), kernel == plain bit-for-bit (ACS "
          f"metrics/rows/acc; walk in slot order with streamed and one-shot "
          f"rotations, in state order, with a valid mask)", flush=True)
    return err


def random_code(pt, K: int, rng, R: int = 2):
    G = tuple(int(rng.randint(0, 1 << K)) | 1 | (1 << (K - 1))
              for _ in range(R))
    return pt.CodeSpec(f"random K={K} R=1/{R} G={G}", K, G)


def phase2b(pt, torch_core, plane, dev, rng) -> dict:
    """Plane kernels vs plain across the class and each boundary of the
    ACS's branch-pattern tables; returns the largest difference seen per
    kernel (0 when bit-exact)."""
    err = {"plane_acs": 0, "plane_walk": 0, "plane_walk_trunc": 0}
    code = pt.get_code("Cassini")
    specs = []
    for mode in MODES:
        for arith in ARITHS:
            cfg = pt.get_decode_config(pt.DecodeType(mode), code.R,
                                       arith=arith)
            specs.append((f"Cassini {mode} {arith}",
                          torch_core.make_static_spec(code, cfg)))
    for K, R, mode, arith in PLANE_RANDOM:
        c = random_code(pt, K, rng, R)
        specs.append((f"{c.name} {mode} {arith}",
                      torch_core.make_static_spec(
                          c, pt.get_decode_config(pt.DecodeType(mode), R,
                                                  arith=arith))))
    B, T = 20, 301
    G = 5  # rows a group of the walk kernels (csrc/plane_walk_group.cuh)
    walk_rows = (1, G - 1, G, G + 1, T)
    for i, (label, spec) in enumerate(specs):
        n = spec.K - 1
        # one frame at T = 1 and n - 1 (the table pipeline's first steps),
        # then B frames at T, whose rows the walks read
        for Bs, Ts in ((1, 1), (1, n - 1), (B, T)):
            # symbols past the soft range exercise the wrapper's clamp
            syms = torch.as_tensor(
                rng.randint(spec.soft_low - 2, spec.soft_high + 3,
                            (Bs, Ts, spec.R)).astype(np.int32), device=dev)
            m0 = torch_core.initial_metrics(spec, Bs, 0, dev)
            m0 = torch.minimum(m0, torch.as_tensor(
                rng.randint(0, spec.metric_max + 1, m0.shape)
                .astype(np.int32), device=dev))
            phase0 = (i + Ts) % n
            got = plane.acs_plane(spec, m0, syms, phase0=phase0)
            torch.cuda.synchronize()
            want = plane.acs_plane_ref(spec, m0, syms, phase0=phase0)
            e = max(max_abs_diff(g, w) for g, w in zip(got, want))
            err["plane_acs"] = max(err["plane_acs"], e)
            require(e == 0, f"plane ACS kernel != plain for {label} B={Bs} "
                            f"T={Ts} (max abs diff {e})")
        packed = got[1]
        start = torch.as_tensor(rng.randint(0, spec.S, B).astype(np.int32),
                                device=dev)
        rots = torch.as_tensor(rng.randint(0, n, T).astype(np.int32),
                               device=dev)
        # chains shorter than, equal to and just past a group, one frame
        # and B frames (a partial block of warps)
        for Bs in (1, B):
            for N in walk_rows:
                rows = packed[:Bs, :N].contiguous()
                st = start[:Bs].contiguous()
                # zeros on the top row of every group and at random
                valid = (rng.rand(N) > 0.2).astype(np.int32)
                valid[N - 1::-G] = 0
                valid = torch.as_tensor(valid, device=dev)
                for kw in ({"rots": rots, "valid": valid}, {"rots": rots},
                           {}):
                    walk = plane.walk_plane_frames(spec, rows, st, **kw)
                    torch.cuda.synchronize()
                    e = max_abs_diff(walk, plane.walk_plane_frames_ref(
                        spec, rows, st, **kw))
                    err["plane_walk"] = max(err["plane_walk"], e)
                    require(e == 0, f"plane walk kernel != plain for {label} "
                                    f"B={Bs} N={N} {sorted(kw)}")
        # interior cold tiles (64/96), an unaligned 37-row buffer whose
        # overlap passes the end (16/48), the defaults (512/128)
        for rows, blk, ov in ((packed, 64, 96), (packed[:, :37], 16, 48),
                              (packed, 512, 128)):
            rows = rows.contiguous()
            tb = rows.shape[1] - n
            tr = plane.chainback_plane_truncated(spec, rows, start, tb, rots,
                                                 blk, ov)
            torch.cuda.synchronize()
            e = max_abs_diff(tr, plane.chainback_plane_truncated_ref(
                spec, rows, start, tb, rots, blk, ov))
            err["plane_walk_trunc"] = max(err["plane_walk_trunc"], e)
            require(e == 0, f"truncated walk kernel != plain for {label} "
                            f"block={blk} overlap={ov} rows={rows.shape[1]}")
    print(f"phase2b ok: {len(specs)} plane specs (K=14..17, R up to 11) at "
          f"B=1 T in (1, n-1) and B={B} T={T}, kernel == plain bit-for-bit "
          f"(ACS metrics/rows/acc at phase0 = (i + T) mod n; on the B={B} "
          f"rows the frame-major walk of N in {walk_rows} rows at B=1 and "
          f"B={B} with random rots, a valid mask zero on group edges and "
          f"neither; the truncated walk at 64/96, 16/48 over 37 rows and "
          f"512/128)", flush=True)
    return err


def phase2d(pt, torch_core, plane, dev, rng) -> dict:
    """The plane ACS past K=17 against its plain version, tolerance 0:
    K = 18..22 (clusters of 4 and 8 blocks, then global metrics) x R in
    BIG_PLANE_R x both arithmetic modes, each at BIG_PLANE_CALLS ((B, T)
    with B in {1, 3}, T in {1, n-1, 2n+3}, from the reset metrics or from
    random metrics near metric_max: the renorm gate fires from the first
    step, and the frame minimum lies in any block), at phase0 != 0, the B=3
    calls into an ``out`` buffer at ``row0=2``; K = MULTI_TILE_K at
    MULTI_TILE_CALLS, where the global kernel's blocks step several tiles
    each (required); on the last call's rows (B=3, T=2n+3) both walks.
    Returns the largest difference seen per kernel."""
    err = {"plane_acs": 0, "plane_acs_global": 0, "plane_walk": 0,
           "plane_walk_trunc": 0}
    calls = 0
    t0 = time.perf_counter()
    for K in (*BIG_PLANE_K, MULTI_TILE_K):
        n = K - 1
        for R in BIG_PLANE_R:
            code = random_code(pt, K, rng, R)
            for j, arith in enumerate(ARITHS):
                mode = MODES[(K + R + j) % len(MODES)]
                spec = torch_core.make_static_spec(
                    code, pt.get_decode_config(pt.DecodeType(mode), R,
                                               arith=arith))
                kernel = plane.acs_kernel(spec)
                label = f"K={K} R={R} {mode} {arith} ({kernel})"
                for Bs, Tn, start in (MULTI_TILE_CALLS if K == MULTI_TILE_K
                                      else BIG_PLANE_CALLS):
                    Ts = (1, n - 1, 2 * n + 3)[Tn]
                    syms = torch.as_tensor(rng.randint(
                        spec.soft_low - 2, spec.soft_high + 3,
                        (Bs, Ts, R)).astype(np.int32), device=dev)
                    if start == "reset":
                        m0 = torch_core.initial_metrics(spec, Bs, 0, dev)
                    else:
                        m0 = torch.as_tensor(
                            spec.metric_max - rng.randint(
                                0, 4 * spec.max_error + 1,
                                (spec.S, Bs)), dtype=torch.int32,
                            device=dev)
                    phase0 = (Ts + j + 1) % n
                    kw = {}
                    if Bs == 3:
                        kw = {"row0": 2, "out": torch.full(
                            (Bs, Ts + 5, spec.W // 128, 128), -7,
                            dtype=torch.int32, device=dev)}
                    got = plane.acs_plane(spec, m0, syms,
                                          phase0=phase0, **kw)
                    torch.cuda.synchronize()
                    bufs = []
                    if kw:
                        # the whole buffers: rows outside the call
                        # stay untouched
                        bufs = [kw["out"]]
                        kw["out"] = torch.full_like(kw["out"], -7)
                        bufs.append(kw["out"])
                    want = plane.acs_plane_ref(spec, m0, syms,
                                               phase0=phase0, **kw)
                    e = max(max_abs_diff(g, w) for g, w in
                            zip((*got, *bufs[:1]),
                                (*want, *bufs[1:])))
                    err[kernel] = max(err[kernel], e)
                    calls += 1
                    require(e == 0, f"plane ACS kernel != plain for "
                                    f"{label} from {start} B={Bs} "
                                    f"T={Ts} phase0={phase0}")
                if K == MULTI_TILE_K:
                    _, per = plane.global_grid(
                        spec.S, Bs, plane.RESIDENT_BLOCKS[
                            (dev.index, K, R, arith == "saturating")])
                    require(per > 1, f"K={K} B={Bs}: the global kernel's "
                                     f"blocks took one tile each")
                # both walks over the last call's rows (B=3, T=2n+3)
                rows = got[1].contiguous()
                T = rows.shape[1]
                st = torch.as_tensor(rng.randint(0, spec.S, 3)
                                     .astype(np.int32), device=dev)
                rots = torch.as_tensor(rng.randint(0, n, T)
                                       .astype(np.int32), device=dev)
                valid = torch.as_tensor((rng.rand(T) > 0.2)
                                        .astype(np.int32), device=dev)
                for wkw in ({"rots": rots, "valid": valid}, {}):
                    w = plane.walk_plane_frames(spec, rows, st, **wkw)
                    torch.cuda.synchronize()
                    e = max_abs_diff(w, plane.walk_plane_frames_ref(
                        spec, rows, st, **wkw))
                    err["plane_walk"] = max(err["plane_walk"], e)
                    require(e == 0, f"plane walk kernel != plain for {label}")
                for blk, ov in ((16, 8), (8, 24)):
                    tr = plane.chainback_plane_truncated(spec, rows, st,
                                                         T - n, rots, blk, ov)
                    torch.cuda.synchronize()
                    e = max_abs_diff(tr, plane.chainback_plane_truncated_ref(
                        spec, rows, st, T - n, rots, blk, ov))
                    err["plane_walk_trunc"] = max(err["plane_walk_trunc"], e)
                    require(e == 0, f"truncated walk kernel != plain for "
                                    f"{label} block={blk} overlap={ov}")
    print(f"phase2d ok: the plane ACS past K=17, {calls} calls (K in "
          f"{BIG_PLANE_K}, R in {BIG_PLANE_R}, saturating and wrapping, "
          f"(B, T, start) in B=1 T=1 reset, B=1 T=n-1 near metric_max, B=3 "
          f"T=2n+3 from both, phase0 != 0, B=3 into out[:, 2:2+T]; "
          f"K={MULTI_TILE_K} B=3 T=2n+3 from both, several tiles a block) "
          f"== plain bit-for-bit (metrics, words, acc); clusters of 4 and "
          f"8 blocks (K=18, 19: cudaOccupancyMaxActiveClusters "
          f"{sorted(set(plane.ACTIVE_CLUSTERS.items()))}) and the persistent "
          f"global-metric kernel (K >= 20: resident blocks "
          f"{sorted(set(plane.RESIDENT_BLOCKS.items()))}); both walks over "
          f"the B=3 rows "
          f"== plain ({time.perf_counter() - t0:.1f} s)", flush=True)
    return err


def reset_counts() -> None:
    from viterbidecodercpp_torch import trace
    trace.reset_counters()


def read_counts() -> dict:
    """{kernel: launches since reset_counts()} of every kernel."""
    from viterbidecodercpp_torch import trace
    counts = trace.counters()
    return {k: counts.get("launches." + k, 0) for k in KERNELS}


def add_counts(launches: dict, counts: dict, kernels, what: str) -> None:
    """Require each of ``kernels`` to have launched, and add the counts."""
    for name in kernels:
        require(counts[name] > 0, f"{what} did not launch the {name} kernel")
        launches[name] = launches.get(name, 0) + counts[name]


def phase2c(pt, dev, rng) -> dict:
    """Lane kernel vs plain across the class and every tile and gate
    boundary; returns the largest difference seen per kernel (0 when
    bit-exact)."""
    from viterbidecodercpp_torch.ops import chainback, lane, torch_core
    err = {"lane_acs": 0, "chainback": 0}
    codes = [pt.get_code("Basic K=3 R=1/2"), pt.get_code("Basic K=5 R=1/2")]
    codes += [random_code(pt, K, rng, R) for K, R in LANE_RANDOM]
    specs = []
    for code in codes:
        for mode in MODES:
            for arith in ARITHS:
                cfg = pt.get_decode_config(pt.DecodeType(mode), code.R,
                                           arith=arith)
                specs.append((f"{code.name} {mode} {arith}",
                              torch_core.make_static_spec(code, cfg)))

    def check(label, spec, B, T, near_max=False, out_at=None):
        # symbols past the soft range: the kernel's branch metric is the
        # abs-diff, exact for any symbols
        syms = torch.as_tensor(
            rng.randint(spec.soft_low - 2, spec.soft_high + 3,
                        (B, T, spec.R)).astype(np.int32), device=dev)
        if near_max:
            # every state near metric_max: the renorm vote fires often
            m0 = torch.as_tensor(rng.randint(
                spec.metric_max - 2 * spec.max_error, spec.metric_max + 1,
                (spec.S, B)).astype(np.int32), device=dev)
        else:
            m0 = torch.minimum(
                torch_core.initial_metrics(spec, B, 0, dev),
                torch.as_tensor(rng.randint(0, spec.metric_max + 1,
                                            (spec.S, B)).astype(np.int32),
                                device=dev))
        buf = None
        if out_at is not None:
            # out is rows [out_at, out_at + T) of a larger buffer, as a
            # decoder passes it; the rows around it keep the sentinel
            buf = torch.full((T + out_at + 4, 1, B), -7, dtype=torch.int32,
                             device=dev)
        got = lane.acs_lane(spec, m0, syms, out=None if buf is None
                            else buf[out_at:out_at + T])
        torch.cuda.synchronize()
        want = lane.acs_lane_ref(spec, m0, syms)
        e = max(max_abs_diff(g, w) for g, w in zip(got, want))
        err["lane_acs"] = max(err["lane_acs"], e)
        what = (f"{label} B={B} T={T}" + (" near metric_max" if near_max
                                          else "") + (f" into out[{out_at}:]"
                                                      if buf is not None
                                                      else ""))
        require(e == 0, f"lane ACS kernel != plain for {what} (max abs "
                        f"diff {e})")
        if buf is not None:
            require(bool((buf[:out_at] == -7).all())
                    and bool((buf[out_at + T:] == -7).all()),
                    f"lane ACS wrote rows outside out for {what}")
            require(got[1].data_ptr() == buf[out_at].data_ptr(),
                    f"lane ACS rows are not out's view for {what}")
        if spec.S < 32:
            require(bool(((got[1] >> spec.S) == 0).all()),
                    f"lane ACS words carry bits >= S for {what}")
        return got, int((got[2] > 0).sum())

    fired = 0
    for label, spec in specs:
        n = spec.K - 1
        # one frame and frames past B in a live warp, at partial, whole and
        # two tiles (a tile is 32 steps or fewer)
        for B in LANE_B:
            for T in LANE_T[:-1]:
                check(label, spec, B, T)
        fired += check(label, spec, 3, 33, near_max=True)[1]
        B, T = LANE_B[-1], LANE_T[-1]
        got, _ = check(label, spec, B, T, out_at=5)
        ends = torch.as_tensor(rng.randint(0, spec.S, B).astype(np.int32),
                               device=dev)
        walk = chainback.chainback(spec, got[1], ends, T - n)
        torch.cuda.synchronize()
        e = max_abs_diff(walk, chainback.chainback_ref(spec, got[1], ends,
                                                       T - n))
        err["chainback"] = max(err["chainback"], e)
        require(e == 0, f"state-order walk kernel != plain for {label}")
    require(fired > 0, "the renorm never fired from entry metrics near "
                       "metric_max")
    print(f"phase2c ok: {len(specs)} lane specs (K=2..6, R up to 16) at B in "
          f"{LANE_B} x T in {LANE_T[:-1]} and B={LANE_B[-1]} T={LANE_T[-1]} "
          f"into out rows [5, {5 + LANE_T[-1]}) of a larger buffer, kernel == "
          f"plain bit-for-bit (ACS metrics/rows/acc from off-reset metrics, "
          f"symbols past the soft range; rows outside out untouched; "
          f"state-order walk), and from "
          f"entry metrics near metric_max ({fired} frames renormalised)",
          flush=True)
    return err


def exact_frames(bits: torch.Tensor, data: torch.Tensor) -> int:
    return int((bits == data).all(dim=1).sum())


def phase3c(pt, dev, rng, launches: dict):
    """The lane path at full size; returns (decoder, symbols, N)."""
    from viterbidecodercpp_torch.ops import encoder, torch_core
    code = pt.get_code("Basic K=5 R=1/2")
    B, N = 512, 2048
    T, R = N + code.K - 1, code.R
    data = torch.as_tensor(rng.randint(0, 2, (B, N)).astype(np.uint8),
                           device=dev)
    clean = encoder.encode_symbols(code, data, 127, -127).cpu().numpy()
    # mild noise: every symbol keeps its sign, so the decode is exact
    noisy = np.clip(clean + rng.randint(-60, 61, clean.shape), -127, 127)
    syms = torch.as_tensor(noisy.reshape(B, T * R).astype(np.int32),
                           device=dev)
    dec = pt.ViterbiDecoder(code, "SOFT16", device=dev)
    require(dec.backend == "lane", f"Basic K=5 took the {dec.backend} "
                                   f"backend on the card")
    reset_counts()
    bits, final_err, acc = dec.decode(syms, N)
    state = dec.reset(B)
    ptr = state.decisions.data_ptr()
    cuts = (0, 333, 1001, T)           # ragged chunk lengths
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        state = dec.update(state, syms[:, lo * R:hi * R])
        # the kernel writes the chunk's rows into the carry's buffer
        require(state.decisions.data_ptr() == ptr,
                "lane update moved the decision buffer")
    ragged = dec.chainback(state, N)
    torch.cuda.synchronize()
    counts = read_counts()
    add_counts(launches, counts, ("lane_acs", "chainback"), "the lane path")
    exact = exact_frames(bits, data)
    require(exact == B, f"only {exact} of {B} Basic K=5 frames decoded "
                        f"exactly")
    spec = dec.spec
    m0 = torch_core.initial_metrics(spec, B, 0, dev)
    ref_m, ref_p, ref_acc = torch_core.acs_scan(spec, m0,
                                                syms.reshape(B, T, R))
    ref_bits = torch_core.chainback_scan(
        spec, ref_p, torch.zeros(B, dtype=torch.int32, device=dev), N)
    require(torch.equal(bits, ref_bits), "lane decode bits != plain scan")
    require(torch.equal(final_err, ref_m[0]), "lane final error != plain")
    require(torch.equal(acc, ref_acc), "lane acc != plain scan")
    require(torch.equal(ragged, ref_bits), "lane ragged bits != plain")
    require(torch.equal(state.metrics, ref_m), "lane ragged metrics != plain")
    require(torch.equal(state.accumulated_error, ref_acc),
            "lane ragged acc != plain")
    require(torch.equal(state.decisions, ref_p), "lane rows != plain rows")
    print(f"phase3c ok: Basic K=5 SOFT16 B={B} T={T}: {exact}/{B} frames "
          f"exact; bits, final metrics, acc and state-order rows == plain "
          f"scan; ragged updates of {np.diff(cuts).tolist()} steps agree, "
          f"rows written in place; launches "
          f"{ {k: counts[k] for k in ('lane_acs', 'chainback')} }",
          flush=True)
    return dec, syms, N


def run_stream(sd, stream: torch.Tensor, n_push: int):
    """Push ``stream`` (B, n_push * chunk * R) through ``sd``; returns
    ([(bits, valid)] per push, final state)."""
    state = sd.reset(stream.shape[0])
    step = sd.chunk * sd.code.R
    out = []
    for i in range(n_push):
        state, bits, valid = sd.push(state, stream[:, i * step:(i + 1) * step])
        out.append((bits, valid))
    return out, state


def chained_push(sd, state, block):
    """A call that pushes ``block`` into the stream of ``state``, each call
    into the state the last one returned (a push consumes its state)."""
    held = [state]

    def push():
        held[0] = sd.push(held[0], block)[0]
    return push


def committed(out, code, N: int) -> torch.Tensor:
    """The data bits of a stream: its valid output from row K-1 on."""
    bits = torch.cat([b for b, v in out if v], dim=1)
    return bits[:, code.K - 1:code.K - 1 + N]


def padded_stream(syms: torch.Tensor, rows: int) -> torch.Tensor:
    """(B, T, R) symbols zero-padded to ``rows`` steps, as (B, rows * R)."""
    B, T, R = syms.shape
    out = torch.zeros((B, rows, R), dtype=torch.int32, device=syms.device)
    out[:, :T] = syms
    return out.reshape(B, rows * R)


def phase3d(pt, dev, rng, launches: dict, seed: int) -> list:
    """The three full-size streams and the window sweep; returns, per
    stream, what phase 4 times: (label, decoder, primed state, block)."""
    from viterbidecodercpp_torch.ops import encoder
    from viterbidecodercpp_torch.utils import testsig
    timed = []
    N = 2048
    for name, mode, B, window, chunk, route, kernels in STREAMS:
        code = pt.get_code(name)
        R = code.R
        n_push = -(-(N + code.K - 1 + window + chunk) // chunk)
        data = torch.as_tensor(rng.randint(0, 2, (B, N)).astype(np.uint8),
                               device=dev)
        clean = encoder.encode_symbols(code, data, 127, -127)
        noise = torch.as_tensor(rng.randint(-60, 61, clean.shape)
                                .astype(np.int32), device=dev)
        # mild noise: every symbol keeps its sign, so the stream is exact
        stream = padded_stream(torch.clamp(clean + noise, -127, 127),
                               n_push * chunk)
        label = f"{name} {mode} B={B} window={window} chunk={chunk}"
        sd = pt.StreamingDecoder(code, mode, window=window, chunk=chunk,
                                 device=dev)
        require(sd.backend == route, f"{label} took the {sd.backend} route")
        reset_counts()
        out, state = run_stream(sd, stream, n_push)
        torch.cuda.synchronize()
        counts = read_counts()
        add_counts(launches, counts, kernels, f"the {label} stream")
        pushes = [pt.trace.counters().get("streaming." + k, 0)
                  for k in ("graph_captures", "eager_pushes",
                            "graph_replays")]
        require(pushes == [1, 1, n_push - 1],
                f"{label}: captures, eager pushes and replays {pushes}, "
                f"not [1, 1, {n_push - 1}]")
        exact = exact_frames(committed(out, code, N), data)
        require(exact == B, f"{label}: only {exact} of {B} streams equal "
                            f"the data sent")
        sp = pt.StreamingDecoder(code, mode, window=window, chunk=chunk,
                                 device=dev, plain=True)
        out_p, state_p = run_stream(sp, stream, n_push)
        for i, ((b, v), (bp, vp)) in enumerate(zip(out, out_p)):
            require(v == vp and torch.equal(b, bp),
                    f"{label}: push {i} != the plain stream")
        for f in ("metrics", "history", "rows_seen"):
            require(torch.equal(getattr(state, f), getattr(state_p, f)),
                    f"{label}: final {f} != the plain stream")
        print(f"phase3d ok: {label} ({route}), {n_push} pushes: {exact}/{B} "
              f"streams equal the data sent; bits, valid, final metrics and "
              f"ring == the plain stream on the card; every push after "
              f"the first a graph replay; launches "
              f"{ {k: counts[k] for k in kernels} }", flush=True)
        timed.append((label, sd, state, stream[:, :chunk * R]))
        del out_p, state_p, stream

    # window sweep on an AWGN channel
    code = pt.get_code("Voyager")
    B, R = 1024, code.R
    T = N + code.K - 1
    cfg = pt.get_decode_config(pt.DecodeType.SOFT16, R)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    data = torch.randint(0, 2, (B, N), generator=gen, device=dev,
                         dtype=torch.uint8)
    syms = testsig.awgn_quantize(testsig.modulate_encode(code, data), gen,
                                 SWEEP_EBNO_DB, R, cfg)
    bits, _, _ = pt.ViterbiDecoder(code, cfg, device=dev).decode(
        syms.reshape(B, T * R), N)
    # the exact decode ends in state 0 (the tail); a stream does not use
    # the termination and walks from its best state, so the last bits of a
    # frame differ for a reason that no window fixes: count those apart
    body = N - SWEEP_END_BITS
    e_exact = int(testsig.count_bit_errors(bits, data))
    e_body = int(testsig.count_bit_errors(bits[:, :body], data[:, :body]))
    line = (f"phase3d sweep: Voyager SOFT16 B={B} x {N} bits, AWGN at Eb/No "
            f"{SWEEP_EBNO_DB} dB: exact decode {e_exact} bit errors "
            f"(BER {e_exact / (B * N):.4e})")
    for window in SWEEP_WINDOWS:
        n_push = -(-(T + window + SWEEP_CHUNK) // SWEEP_CHUNK)
        sd = pt.StreamingDecoder(code, cfg, window=window, chunk=SWEEP_CHUNK,
                                 device=dev)
        out, _ = run_stream(sd, padded_stream(syms, n_push * SWEEP_CHUNK),
                            n_push)
        got = committed(out, code, N)
        e = int(testsig.count_bit_errors(got, data))
        eb = int(testsig.count_bit_errors(got[:, :body], data[:, :body]))
        line += (f"; window {window} (chunk {SWEEP_CHUNK}): {e} errors, "
                 f"delta {e - e_exact:+d} (bits [0, {body}): delta "
                 f"{eb - e_body:+d})")
    print(line, flush=True)
    return timed


def big_code(pt, K: int):
    """The K >= 18 codes of phases 3e and 4e: BIG_TAPS with g_(K-1) set."""
    return pt.CodeSpec(f"K={K}", K, tuple((1 << (K - 1)) | g
                                          for g in BIG_TAPS))


def phase3e(pt, dev, rng, launches: dict) -> dict:
    """K >= 18 at full width through the entry points: the K=18 SOFT16
    decode of K18_B x K18_BITS noise-free bits (every frame equal to its
    data; the first K18_PLAIN_FRAMES frames' bits, get_error and renorm
    totals, and the kernel's metrics, words and acc, equal to the plain
    versions on the card), the K=18 stream (equal to the data), and the
    K=20 and K=21 decodes of WIDE_B x WIDE_BITS bits (equal to the data
    and to the plain versions).  Returns the JSON line's entry."""
    from viterbidecodercpp_torch.ops import encoder, plane, torch_core
    out = {}
    for K, B, N in ((18, K18_B, K18_BITS),
                    *((k, WIDE_B, WIDE_BITS) for k in WIDE_K)):
        code = big_code(pt, K)
        n = K - 1
        T = N + n
        data = torch.as_tensor(rng.randint(0, 2, (B, N)).astype(np.uint8),
                               device=dev)
        syms = encoder.encode_symbols(code, data, 127, -127).reshape(B, -1)
        dec = pt.ViterbiDecoder(code, "SOFT16", device=dev)
        kernel = plane.acs_kernel(dec.spec)
        require(dec.backend == "plane", f"K={K} took the {dec.backend} "
                                        f"backend on the card")
        rows = -(-T // plane.time_block_rows(dec.spec)) * \
            plane.time_block_rows(dec.spec)
        buf_gb = B * rows * dec.spec.W * 4 / 1e9
        reset_counts()
        t0 = time.perf_counter()
        bits, err_, acc = dec.decode(syms, N)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        add_counts(launches, counts, (kernel, "plane_walk"),
                   f"the K={K} decode")
        exact = exact_frames(bits, data)
        require(exact == B, f"K={K}: only {exact} of {B} frames decoded "
                            f"exactly")
        # the plain versions on the card over the first frames
        F = min(B, K18_PLAIN_FRAMES)
        spec = dec.spec
        m0 = torch_core.initial_metrics(spec, F, 0, dev)
        syms3 = syms[:F].reshape(F, T, code.R).to(torch.int32)
        pm, pp, pa = plane.acs_plane_ref(spec, m0, syms3)
        zero = torch.zeros(F, dtype=torch.int32, device=dev)
        pbits = plane.walk_plane_frames_ref(spec, pp, zero)[:, n:]
        require(torch.equal(bits[:F], pbits), f"K={K} bits != plain")
        require(torch.equal(err_[:F], pm[0]), f"K={K} get_error != plain")
        require(torch.equal(acc[:F], pa), f"K={K} acc != plain")
        km, kp, ka = plane.acs_plane(spec, m0, syms3)
        e = max(max_abs_diff(g, w) for g, w in zip((km, kp, ka),
                                                   (pm, pp, pa)))
        require(e == 0, f"K={K} ACS kernel != plain on the decode's first "
                        f"{F} frames")
        del pp, kp
        print(f"phase3e ok: K={K} SOFT16 ({kernel}) B={B} T={T}: "
              f"{exact}/{B} frames exact ({secs:.2f} s, decision buffer "
              f"{B} x {rows} x {spec.W} words = {buf_gb:.2f} GB); the first "
              f"{F} frames' bits, get_error and acc == the plain versions "
              f"on the card, and the ACS kernel's metrics, words and acc == "
              f"plain; launches "
              f"{ {k: counts[k] for k in (kernel, 'plane_walk')} }",
              flush=True)
        out[f"K={K}"] = {"B": B, "T": T, "kernel": kernel, "exact": exact,
                         "decision_gb": buf_gb}
        if K != 18:
            continue
        # the K=18 stream, held to the data
        n_push = -(-(T + K18_WINDOW + K18_CHUNK) // K18_CHUNK)
        stream = padded_stream(syms.reshape(B, T, code.R).to(torch.int32),
                               n_push * K18_CHUNK)
        del syms, bits
        sd = pt.StreamingDecoder(code, "SOFT16", window=K18_WINDOW,
                                 chunk=K18_CHUNK, device=dev)
        require(sd.backend == "plane", f"the K=18 stream took the "
                                       f"{sd.backend} route")
        reset_counts()
        res, _ = run_stream(sd, stream, n_push)
        torch.cuda.synchronize()
        counts = read_counts()
        add_counts(launches, counts, ("plane_acs", "plane_walk"),
                   "the K=18 stream")
        exact = exact_frames(committed(res, code, N), data)
        require(exact == B, f"the K=18 stream: only {exact} of {B} frames "
                            f"equal the data sent")
        print(f"phase3e ok: K=18 SOFT16 stream B={B} window={K18_WINDOW} "
              f"chunk={K18_CHUNK}, {n_push} pushes: {exact}/{B} streams "
              f"equal the data sent; launches "
              f"{ {k: counts[k] for k in ('plane_acs', 'plane_walk')} }",
              flush=True)
        out["K=18 stream"] = {"B": B, "pushes": n_push, "exact": exact}
        del stream, res
    return out


def device_busy_ms(fn) -> float:
    """The device time of the kernels one call of ``fn`` launches
    (torch.profiler; one profiled call first, dropped: a window's first
    device events can be lost)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    busy = 0.0
    for e in prof.key_averages():
        if e.key.startswith(("aten::", "ProfilerStep")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        busy += max(us, 0)
    return busy / 1e3


def phase4e(pt, dev, rng, card: str) -> dict:
    """The two ACS routes past K=17 beside their bounds: kernel and plain
    time at each BIG_TIMES shape (random symbols, reset metrics), its
    time a trellis step and its share of the bound, and what bounds the
    call: its kernels' device time (torch.profiler) and the host's time
    to enqueue it; for the global kernel its grid, tiles a block and the
    blocks the card holds at once.  Returns, per shape, the numbers the
    JSON line reports."""
    from viterbidecodercpp_torch.ops import plane, torch_core
    out = {}
    for K, B, N in BIG_TIMES:
        code = big_code(pt, K)
        spec = torch_core.make_static_spec(
            code, pt.get_decode_config(pt.DecodeType.SOFT16, code.R))
        T = N + K - 1
        m0 = torch_core.initial_metrics(spec, B, 0, dev)
        sy = torch.as_tensor(rng.randint(-127, 128, (B, T, code.R))
                             .astype(np.int32), device=dev)
        kernel = plane.acs_kernel(spec)
        got = plane.acs_plane(spec, m0, sy)
        want = plane.acs_plane_ref(spec, m0, sy)
        e = max(max_abs_diff(g, w) for g, w in zip(got, want))
        require(e == 0, f"{kernel} != plain at K={K} B={B} T={T}")
        del got, want
        ms = time_ms(lambda: plane.acs_plane(spec, m0, sy))
        busy = device_busy_ms(lambda: plane.acs_plane(spec, m0, sy))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plane.acs_plane(spec, m0, sy)
        enqueue = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        # one call: the plain versions take seconds here
        plain = time_ms(lambda: plane.acs_plane_ref(spec, m0, sy), 1, 0)
        bms, by = acs_bound(spec.S, B, T, code.R, spec.W)
        grid = {}
        if kernel == "plane_acs":
            layout = f"a cluster of {spec.S >> 15} blocks a frame"
        else:
            resident = plane.RESIDENT_BLOCKS[(dev.index, K, code.R,
                                              spec.saturating)]
            blocks, per = plane.global_grid(spec.S, B, resident)
            grid = {"grid": blocks, "tiles_per_block": per,
                    "resident_blocks": resident}
            layout = (f"one persistent kernel a call: grid {blocks} of "
                      f"{resident} resident blocks, {per} tiles of "
                      f"{plane.GLOBAL_TILE} slots a block")
        print(f"phase4e {kernel} K={K} ({layout}) "
              f"SOFT16 B={B} T={T}: kernel {ms:.4f} ms (median of {REPS}; "
              f"{ms / T * 1e3:.3f} us a step), plain {plain:.4f} ms (one "
              f"call), bound {bms:.6f} ms ({by}), share of the "
              f"bound {bms / ms:.4f}; the call's kernels busy {busy:.4f} "
              f"ms on the device, host enqueue {enqueue:.4f} ms; on {card}",
              flush=True)
        out[f"K={K}"] = {"kernel": kernel, "B": B, "T": T, "ms": ms,
                         "us_a_step": ms / T * 1e3, "plain_ms": plain,
                         "device_busy_ms": busy, "enqueue_ms": enqueue,
                         "bound_ms": bms, "bound_by": by, "max_abs_err": e,
                         **grid}
        del m0, sy
        torch.cuda.empty_cache()
    return out


def channel_check(code, cfg, EbNo: float, B: int, N: int, seed: int,
                  dev) -> int:
    """One batch of ``ber.draw_batch`` (the channel kernel after its
    draws) against the plain chain, ``awgn_quantize(modulate_encode(...))``
    after the same ``randint``, from the same generator state: data bits,
    symbols and the generator's state after it equal.  Returns the largest
    difference of the symbols (0)."""
    from viterbidecodercpp_torch import ber
    from viterbidecodercpp_torch.utils import testsig
    g1, g2 = (torch.Generator(device=dev) for _ in range(2))
    g1.manual_seed(seed)
    g2.manual_seed(seed)
    syms, tx = ber.draw_batch(code, cfg, EbNo, g1, B, N)
    want_tx = torch.randint(0, 2, (B, N), generator=g2, dtype=torch.uint8,
                            device=dev)
    want = testsig.awgn_quantize(testsig.modulate_encode(code, want_tx), g2,
                                 EbNo, code.R, cfg)
    label = f"the channel kernel, {code.name} B={B} N={N} at {EbNo} dB"
    require(torch.equal(tx, want_tx), f"{label}: data bits != plain chain")
    e = max_abs_diff(syms, want)
    require(e == 0, f"{label}: symbols != plain chain (by {e})")
    require(torch.equal(g1.get_state(), g2.get_state()),
            f"{label}: the generator's state != the plain chain's")
    return e


def phase4f(pt, dev) -> dict:
    """The channel kernel at the voyager-ber cell's batch (Voyager SOFT8,
    6 dB, B=CHANNEL_B x CHANNEL_BITS): equal to its plain version,
    ``testsig.quantise(testsig.modulate_encode(...))`` on the same noise,
    and both timed (noise drawn beforehand, so neither counts ``randn``).
    Returns the kernels line's numbers: max_abs_err, ms, plain_ms, bound
    (its bytes: the data bits, the noise read, the symbols written; its
    few operations a symbol lie far below them) and the shape."""
    from viterbidecodercpp_torch.ops import channel
    from viterbidecodercpp_torch.utils import testsig
    code = pt.get_code(LOOP_CODE)
    cfg = pt.get_decode_config(pt.DecodeType(LOOP_MODE), code.R)
    B, N = CHANNEL_B, CHANNEL_BITS
    T = N + code.K - 1
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    bits = torch.randint(0, 2, (B, N), generator=g, dtype=torch.uint8,
                         device=dev)
    noise = torch.randn((B, T, code.R), generator=g, dtype=torch.float32,
                        device=dev)
    args = (noise, *testsig.channel_scalars(LOOP_EBNO_DB, code.R, cfg, dev),
            cfg.soft_decision_low, cfg.soft_decision_high)

    def kernel():
        return channel.encode_awgn_quantize(code, bits, *args)

    def plain():
        return testsig.quantise(testsig.modulate_encode(code, bits), *args)

    e = max_abs_diff(kernel(), plain())
    require(e == 0, f"channel kernel != plain at B={B} N={N}")
    ms, plain_ms = time_ms(kernel), time_ms(plain, PLAIN_REPS, 1)
    nbytes = B * N + 2 * 4 * B * T * code.R
    del bits, noise, args
    torch.cuda.empty_cache()
    return {"max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
            "bound": bound(0, nbytes),
            "shape": f"{LOOP_CODE} {LOOP_MODE} B={B} T={T} at "
                     f"{LOOP_EBNO_DB} dB"}


def phase4d(pt, dev, card: str, launches: dict, err: dict) -> dict:
    """The BER loop's times: ``measure_point`` against ``decode`` alone at
    B=256 and B=1024 (the channel kernel held to the plain chain at both
    and its launches counted, one a batch), the device's idle share in
    the loop, and one host-chain point."""
    from viterbidecodercpp_torch import ber
    code = pt.get_code(LOOP_CODE)
    cfg = pt.get_decode_config(pt.DecodeType(LOOP_MODE), code.R)

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    out = {"code": f"{LOOP_CODE} {LOOP_MODE}", "block_bits": LOOP_BLOCK,
           "EbNo_dB": LOOP_EBNO_DB}
    for B in (256, 1024):
        n = LOOP_BATCHES * 256 // B
        budget = n * B * LOOP_BLOCK

        def point(batches, seed):
            return ber.measure_point(
                code, cfg, LOOP_EBNO_DB, generator=gen(seed),
                block_bits=LOOP_BLOCK, batch=B,
                max_bits=batches * B * LOOP_BLOCK, device=dev)

        e = channel_check(code, cfg, LOOP_EBNO_DB, B, LOOP_BLOCK, 11 + B,
                          dev)
        err["awgn_channel"] = max(err.get("awgn_channel", 0), e)
        point(4, 0)                                  # warm-up
        secs = []
        reset_counts()
        for rep in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = point(n, rep + 1)
            secs.append(time.perf_counter() - t0)
            require(p.total_bits == budget,
                    f"BER loop B={B} at {LOOP_EBNO_DB} dB stopped early: {p}")
        counts = read_counts()
        require(counts["awgn_channel"] == 3 * n,
                f"BER loop B={B}: {counts['awgn_channel']} channel launches "
                f"in {3 * n} batches")
        add_counts(launches, counts, ("awgn_channel",), f"the BER loop B={B}")
        syms, _ = ber.draw_batch(code, cfg, LOOP_EBNO_DB, gen(5), B,
                                 LOOP_BLOCK)
        dec = pt.ViterbiDecoder(code, cfg, traceback_length=LOOP_BLOCK,
                                device=dev)
        syms = syms.reshape(B, -1)
        dec_ms = time_ms(lambda: dec.decode(syms, LOOP_BLOCK))
        batch_ms = statistics.median(secs) / n * 1e3
        prof = profile_idle(lambda: point(LOOP_PROFILE_BATCHES, 9))
        row = {"batches": n, "bits": budget, "seconds": secs,
               "bits_per_s": budget / statistics.median(secs),
               "ms_per_batch": batch_ms, "decode_ms": dec_ms,
               "decode_bits_per_s": B * LOOP_BLOCK / (dec_ms / 1e3),
               "overhead_share": 1 - dec_ms / batch_ms,
               f"profile_{LOOP_PROFILE_BATCHES}_batches": prof}
        out[f"B={B}"] = row
        print(f"phase4d BER loop {LOOP_CODE} {LOOP_MODE} block {LOOP_BLOCK} "
              f"B={B}: the channel kernel == the plain chain (symbols, bits, "
              f"generator state), {counts['awgn_channel']} launches in "
              f"{3 * n} batches", flush=True)
        print(f"phase4d BER loop {LOOP_CODE} {LOOP_MODE} block {LOOP_BLOCK} "
              f"B={B}, {n} batches at {LOOP_EBNO_DB} dB: measure_point "
              f"{row['bits_per_s']:.4e} decoded bits/s ({batch_ms:.4f} ms a "
              f"batch, median of 3 points); decode alone {dec_ms:.4f} ms = "
              f"{row['decode_bits_per_s']:.4e} bits/s; loop overhead share "
              f"{row['overhead_share']:.4f}; device idle share "
              f"{prof['idle_share']:.4f} over {LOOP_PROFILE_BATCHES} batches "
              f"(torch.profiler); on {card}", flush=True)
    hc_bits = HOST_CHAIN_BATCHES * 256 * LOOP_BLOCK
    ber.measure_point_host_chain(code, cfg, LOOP_EBNO_DB, seed=0,
                                 block_bits=LOOP_BLOCK,
                                 max_bits=256 * LOOP_BLOCK, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = ber.measure_point_host_chain(code, cfg, LOOP_EBNO_DB, seed=1,
                                     block_bits=LOOP_BLOCK, max_bits=hc_bits,
                                     device=dev)
    secs = time.perf_counter() - t0
    require(p.total_bits == hc_bits,
            f"host-chain point at {LOOP_EBNO_DB} dB stopped early: {p}")
    out["host_chain"] = {"bits": hc_bits, "seconds": secs,
                         "bits_per_s": hc_bits / secs}
    print(f"phase4d host chain {LOOP_CODE} {LOOP_MODE} block {LOOP_BLOCK} "
          f"B=256, {HOST_CHAIN_BATCHES} batches: {hc_bits / secs:.4e} "
          f"decoded bits/s (native mt19937 channel on the host, decode on "
          f"the card); on {card}", flush=True)
    return out


def ber_reference(name: str, mode: str) -> dict:
    """Eb/No -> BER of the in-repo reference curve for (code, regime)."""
    from pathlib import Path
    path = Path(__file__).resolve().parent / BER_FILES[name]
    with open(path) as f:
        for rec in json.load(f):
            if rec["name"] == name and rec["decode_type"] == mode:
                return dict(zip(rec["EbNo_dB"], rec["ber"]))
    raise SmokeFailure(f"no reference curve for {name} {mode} in {path}")


def ber_budget(r: float) -> int:
    """Bits for >= BER_WANT_ERRORS expected errors, at most 6e7 bits
    (tests/test_ber.py:70-72, there with 300 expected errors)."""
    return min(int(BER_WANT_ERRORS / max(r, 1e-9)), 60_000_000)


def ber_window(r: float, errors: int) -> tuple:
    """tests/test_ber.py:85-91: a 1.3x window around the reference BER,
    widened to 5 sigma of the observed count."""
    sigma_rel = 5.0 / max(np.sqrt(max(errors, 1)), 1.0)
    return (min(r / 1.3, r * (1 - sigma_rel)),
            max(r * 1.3, r * (1 + sigma_rel)))


def phase5(pt, dev, launches: dict, err: dict, seed: int) -> dict:
    """The BER engine on the card at every point tests/test_ber.py gates,
    and its host-chain point, each held against the reference curves;
    before each point one batch of its channel kernel against the plain
    chain at the point's shape."""
    import zlib
    from viterbidecodercpp_torch import ber
    rows, outside = [], []

    def check(label, r, p):
        lo, hi = ber_window(r, p.total_bit_errors)
        # a point with no error at all lies in every window that the 5
        # sigma widening opens below zero: it fails here
        ok = p.total_bit_errors > 0 and lo <= p.ber <= hi
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        rows.append({"point": label, "ber": p.ber, "reference": r,
                     "bits": p.total_bits, "errors": p.total_bit_errors,
                     "inside": ok, "peak_mib": peak})
        print(f"phase5 {label}: BER {p.ber:.4e} ({p.total_bit_errors}/"
              f"{p.total_bits}), reference {r:.4e}, window [{lo:.4e}, "
              f"{hi:.4e}] {'ok' if ok else 'OUTSIDE'}; peak device memory "
              f"{peak:.1f} MiB", flush=True)
        if not ok:
            outside.append(label)

    points_counts, checked = [], 0
    t0 = time.perf_counter()
    for name, regimes in BER_POINTS.items():
        code = pt.get_code(name)
        block = 1024 if name == "Cassini" else 4096
        for mode, points in regimes.items():
            ref = ber_reference(name, mode)
            cfg = pt.get_decode_config(pt.DecodeType(mode), code.R)
            g = torch.Generator(device=dev)
            g.manual_seed(zlib.crc32(f"{name}/{mode}".encode()) + seed)
            for EbNo in points:
                r = ref[EbNo]
                e = channel_check(code, cfg, EbNo, 256, block,
                                  zlib.crc32(f"{name}/{mode}/{EbNo}".encode()),
                                  dev)
                err["awgn_channel"] = max(err["awgn_channel"], e)
                checked += 1
                reset_counts()
                torch.cuda.reset_peak_memory_stats(dev)
                p = ber.measure_point(code, cfg, EbNo, generator=g,
                                      block_bits=block,
                                      max_bits=ber_budget(r),
                                      max_errors=100_000, device=dev)
                check(f"{name} {mode} {EbNo} dB block {block}", r, p)
                points_counts.append(read_counts())
                batches = p.total_bits // (256 * block)
                require(points_counts[-1]["awgn_channel"] == batches,
                        f"{name} {mode} {EbNo} dB: "
                        f"{points_counts[-1]['awgn_channel']} channel "
                        f"launches in {batches} batches")
    name, mode, EbNo, hc_seed = BER_HOST_CHAIN
    code = pt.get_code(name)
    r = ber_reference(name, mode)[EbNo]
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    p = ber.measure_point_host_chain(
        code, pt.get_decode_config(pt.DecodeType(mode), code.R), EbNo,
        seed=hc_seed, block_bits=1024, batch=64, max_bits=ber_budget(r),
        max_errors=100_000, device=dev)
    check(f"{name} {mode} {EbNo} dB block 1024 host chain", r, p)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    points_counts.append(read_counts())
    counts = {k: sum(c[k] for c in points_counts) for k in KERNELS}
    add_counts(launches, counts, BER_KERNELS, "the BER engine")
    require(not outside, f"{len(outside)} BER points outside their windows: "
                         f"{outside}")
    bits = sum(row["bits"] for row in rows)
    print(f"phase5 ok: {len(rows)} BER points ({len(rows) - 1} on the card, "
          f"one host chain) inside tests/test_ber.py's windows of the "
          f"reference curves; {bits} bits in {secs:.2f} s; launches "
          f"{ {k: counts[k] for k in BER_KERNELS} }; the channel kernel == "
          f"the plain chain at {checked} points' shapes (symbols, bits, "
          f"generator state)", flush=True)
    return {"points": rows, "bits": bits, "seconds": secs}


def phase5b(dev, launches: dict) -> None:
    """DAB FIC punctured decode in the three regimes on the card, as
    tools/torch_run_punctured_decoder.py runs it: 0 bit errors."""
    from tools.torch_run_punctured_decoder import decode_dab_fic
    reset_counts()
    rows = decode_dab_fic(dev)
    torch.cuda.synchronize()
    counts = read_counts()
    add_counts(launches, counts, ("rotated_acs", "chainback"),
               "the punctured decode")
    for regime, backend, kept, syms, errors, nbits, _ in rows:
        require(backend == "rotated", f"DAB FIC {regime} took the {backend} "
                                      f"backend")
        require(errors == 0, f"DAB FIC {regime}: {errors} of {nbits} bits "
                             f"wrong after depuncturing")
    print(f"phase5b ok: DAB FIC K=7 R=1/4, 21 x PI_16 + 3 x PI_15 + PI_X, "
          f"{rows[0][3]} -> {rows[0][2]} symbols, {rows[0][5]} data bits: 0 "
          f"bit errors in {[r[0] for r in rows]}; launches "
          f"{ {k: counts[k] for k in ('rotated_acs', 'chainback')} }",
          flush=True)


# -- phase 6: the parallel layer -------------------------------------------
# Ranks are this script run with --rank by phase 6's parent: four gloo ranks
# sharing cuda:0, and min(4, cards) NCCL ranks (one a card) when the machine
# has two or more cards.

# full-width time-SP cases: (label, stream, frames, data bits, overlap,
# data-axis size, route); "2-D" decodes the "rotated" case's stream on a
# (data=2, time=world/2) mesh
SP_STREAMS = {"Voyager": ("Voyager", "SOFT16", 1024, 131072),
              "Basic K=5": ("Basic K=5 R=1/2", "SOFT16", 1024, 131072),
              "Cassini": ("Cassini", "SOFT16", 128, 16384)}
SP_CASES = (("rotated", "Voyager", 256, 1, "rotated"),
            ("lane", "Basic K=5", 160, 1, "lane"),
            ("plane", "Cassini", 128, 1, "plane"),
            ("2-D", "Voyager", 256, 2, "rotated"))
SP_EBNO_DB = 3.0
ROUTE_KERNELS = {"rotated": ("rotated_acs", "chainback"),
                 "lane": ("lane_acs", "chainback"),
                 "plane": ("plane_acs", "plane_walk")}
# the layer through the kernels against its plain versions: B=61, a tile
# of 301 rows a rank, overlap 64, the stream's true end at the last row
# and 150 rows before it
CHECK_B, CHECK_L, CHECK_O, CHECK_PADS = 61, 301, 64, (0, 150)
CHECK_STREAMS = {"rotated": "Voyager", "lane": "Basic K=5",
                 "plane": "Cassini"}
# frame-DP: Voyager SOFT8, 1024 frames x 2048 rows a rank, AWGN
DP_CODE, DP_MODE, DP_B, DP_BITS, DP_EBNO_DB = "Voyager", "SOFT8", 1024, \
    2042, 2.0
# data-parallel BER points: Voyager SOFT8, 2048-bit blocks, 256 frames a
# rank, 8 batches, at each Eb/No (an error budget no point reaches: a
# point that stops on its errors sums them over the ranks a batch, the
# ranks' own points each stop on their own)
BER_DP_EBNO_DB, BER_DP_BLOCK, BER_DP_B, BER_DP_BATCHES = (6.0, 2.0), 2048, \
    256, 8
BER_DP_MAX_ERRORS = 1 << 30


def sp_stream(pt, stream: str, nbits: int, B: int, ntime: int, seed: int,
              dev, rows: int = 0):
    """(code, config, (B, T', R) symbols, T): ``stream``'s code through
    the AWGN channel at SP_EBNO_DB from a generator seeded ``seed``, T rows
    zero-padded to T' = ``rows`` or else a multiple of ntime."""
    from viterbidecodercpp_torch.utils import testsig
    name, mode = SP_STREAMS[stream][:2]
    code = pt.get_code(name)
    config = pt.get_decode_config(pt.DecodeType(mode), code.R)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    tx = torch.randint(0, 2, (B, nbits), generator=g, dtype=torch.uint8,
                       device=dev)
    syms = testsig.awgn_quantize(testsig.modulate_encode(code, tx), g,
                                 SP_EBNO_DB, code.R, config)
    T = syms.shape[1]
    pad = (rows or -(-T // ntime) * ntime) - T
    if pad:
        syms = torch.cat([syms, syms.new_zeros(B, pad, code.R)], dim=1)
    return code, config, syms, T


def stream_seed(seed: int, stream: str) -> int:
    return seed * 1000 + list(SP_STREAMS).index(stream)


def dp_frames(pt, seed: int, rank: int, dev):
    """Rank ``rank``'s frame-DP frames: (code, config, symbols, data)."""
    from viterbidecodercpp_torch.utils import testsig
    code = pt.get_code(DP_CODE)
    config = pt.get_decode_config(pt.DecodeType(DP_MODE), code.R)
    g = torch.Generator(device=dev)
    g.manual_seed(seed * 1000 + 100 + rank)
    tx = torch.randint(0, 2, (DP_B, DP_BITS), generator=g,
                       dtype=torch.uint8, device=dev)
    syms = testsig.awgn_quantize(testsig.modulate_encode(code, tx), g,
                                 DP_EBNO_DB, code.R, config)
    return code, config, syms, tx


def phase6_rank(args) -> None:
    """One rank of phase 6: the layer's main path at full width (time-SP on
    three routes and a 2-D mesh, frame-DP, data-parallel BER points), then
    the kernel-vs-plain checks; writes its results to ``args.work``."""
    import torch.distributed as dist

    import viterbidecodercpp_torch as pt
    from viterbidecodercpp_torch import ber
    from viterbidecodercpp_torch.ops import _build, torch_core
    from viterbidecodercpp_torch.parallel import block_sp, frame_dp, launch
    from viterbidecodercpp_torch.parallel.mesh import make_mesh

    rank, world = args.rank, args.world
    dev = launch.initialize(args.init_method, world, rank,
                            backend=args.backend, device="cuda")
    for name in KERNELS:
        _build.load(name)
    out = {"rank": rank, "device": str(dev),
           "nvcc_seconds": sum(_build.build_seconds.values()), "sp": {}}
    arrays = {}

    def mesh_for(ndata: int):
        if ndata == 1:
            return make_mesh((world,), ("time",), "cuda"), \
                (None, "time", None)
        return make_mesh((ndata, world // ndata), ("data", "time"), "cuda"), \
            ("data", "time", None)

    # -- the main path: every count from here to read_counts() ------------
    reset_counts()
    for label, stream, overlap, ndata, route in SP_CASES:
        if world % ndata or world == ndata:
            continue
        mesh, axes = mesh_for(ndata)
        B, nbits = SP_STREAMS[stream][2:]
        code, config, syms, T = sp_stream(
            pt, stream, nbits, B, world // ndata, stream_seed(args.seed,
                                                              stream), dev)
        spec = torch_core.make_static_spec(code, config)
        tile = launch.local_block(syms, mesh, axes).contiguous()
        del syms
        res = block_sp.decode_stream_sp(spec, mesh, tile, overlap=overlap,
                                        total_rows=T, backend=route,
                                        device=dev)
        timings = {}
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        again = block_sp.decode_stream_sp(
            spec, mesh, tile, overlap=overlap, total_rows=T, backend=route,
            device=dev, timings=timings)
        wall = time.perf_counter() - t0
        require(torch.equal(again.bits, res.bits)
                and int(again.halo_mismatches) == int(res.halo_mismatches),
                f"{label}: a second call decoded differently")
        arrays[label] = np.packbits(res.bits.cpu().numpy(), axis=1)
        out["sp"][label] = {
            "mism": int(res.halo_mismatches), "tile_ms": 1e3 * timings["tile"],
            "exchange_ms": 1e3 * timings["exchange"], "wall_ms": 1e3 * wall,
            "frames": tile.shape[0], "rows": tile.shape[1], "T": T}
        del tile, res, again

    code, config, syms, tx = dp_frames(pt, args.seed, rank, dev)
    bits, errs = frame_dp.decode_dp(code, config, syms, DP_BITS,
                                    reference_bits=tx,
                                    group=dist.group.WORLD, device=dev)
    arrays["frame_dp"] = np.packbits(bits.cpu().numpy(), axis=1)
    out["frame_dp"] = {"errs": int(errs), "own": int((bits != tx).sum())}

    points = []
    for i, ebno in enumerate(BER_DP_EBNO_DB):
        p = ber.measure_point(
            code, config, ebno,
            generator=ber.rank_generator(args.seed, i, rank, dev),
            block_bits=BER_DP_BLOCK, batch=BER_DP_B,
            max_bits=BER_DP_BATCHES * world * BER_DP_B * BER_DP_BLOCK,
            max_errors=BER_DP_MAX_ERRORS, group=dist.group.WORLD, device=dev)
        points.append([p.total_bits, p.total_bit_errors])
    torch.cuda.synchronize()
    out["launches"] = read_counts()

    # -- comparisons (their launches are not counted) ----------------------
    out["ber"] = []
    for i, ebno in enumerate(BER_DP_EBNO_DB):
        q = ber.measure_point(
            code, config, ebno,
            generator=ber.rank_generator(args.seed, i, rank, dev),
            block_bits=BER_DP_BLOCK, batch=BER_DP_B,
            max_bits=BER_DP_BATCHES * BER_DP_B * BER_DP_BLOCK,
            max_errors=BER_DP_MAX_ERRORS, device=dev)
        out["ber"].append({"EbNo_dB": ebno, "group": points[i],
                           "alone": [q.total_bits, q.total_bit_errors]})
    out["check"] = {}
    # the kernels against their plain versions on the main path's own
    # full-width tiles: halo + tile from uniform metrics, per-tile
    # rotations, the last tile's valid mask and end state
    for label, stream, overlap, ndata, route in SP_CASES:
        if label not in out["sp"]:
            continue
        mesh, axes = mesh_for(ndata)
        B, nbits = SP_STREAMS[stream][2:]
        code, config, syms, T = sp_stream(
            pt, stream, nbits, B, world // ndata, stream_seed(args.seed,
                                                              stream), dev)
        spec = torch_core.make_static_spec(code, config)
        tile = launch.local_block(syms, mesh, axes).contiguous()
        del syms
        t0 = time.perf_counter()
        ref = block_sp.decode_stream_sp(spec, mesh, tile, overlap=overlap,
                                        total_rows=T, backend=route,
                                        plain=True, device=dev)
        L = tile.shape[1]
        got = np.unpackbits(arrays[label], axis=1, count=L)
        e = int((got != ref.bits.cpu().numpy()).sum()) + abs(
            int(ref.halo_mismatches) - out["sp"][label]["mism"])
        require(e == 0, f"phase6 rank {rank}: the {route} route's kernels "
                        f"!= their plain versions on the {label} case's "
                        f"full-width tile ({tile.shape[0]} frames x {L} "
                        f"rows, overlap {overlap})")
        out["check"][f"{route}/{label} full width"] = {
            "max_abs_err": e, "mism": int(ref.halo_mismatches),
            "seconds": time.perf_counter() - t0}
        del tile, ref
    mesh, axes = mesh_for(1)
    for route, stream in CHECK_STREAMS.items():
        for pad in CHECK_PADS:
            rows = world * CHECK_L
            K = pt.get_code(SP_STREAMS[stream][0]).K
            code, config, syms, T = sp_stream(
                pt, stream, rows - pad - (K - 1), CHECK_B, world,
                stream_seed(args.seed, stream) + 7 + pad, dev, rows)
            g = torch.Generator(device=dev)
            g.manual_seed(args.seed + pad)
            # random symbols past the true end: only `valid` keeps them out
            syms[:, T:] = torch.randint(-127, 128, syms[:, T:].shape,
                                        generator=g, dtype=torch.int32,
                                        device=dev)
            require(syms.shape[1] == rows, "check stream rows")
            spec = torch_core.make_static_spec(code, config)
            tile = launch.local_block(syms, mesh, axes)
            got = {v: block_sp.decode_stream_sp(
                       spec, mesh, tile, overlap=CHECK_O, total_rows=T,
                       backend=b, plain=p, device=dev)
                   for v, b, p in (("kernels", route, False),
                                   ("plain", route, True),
                                   ("torch", "torch", False))}
            e = max(max_abs_diff(got["kernels"].bits, got[v].bits)
                    + abs(int(got["kernels"].halo_mismatches)
                          - int(got[v].halo_mismatches))
                    for v in ("plain", "torch"))
            require(e == 0, f"phase6 rank {rank}: the {route} route's "
                            f"kernels != their plain versions at B="
                            f"{CHECK_B}, padding {pad}")
            out["check"][f"{route}/B={CHECK_B} padding {pad}"] = {
                "max_abs_err": e, "mism": int(got["kernels"].halo_mismatches)}
    np.savez(os.path.join(args.work, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(args.work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def run_fleet(backend: str, world: int, seed: int, work: str) -> list:
    """Spawn phase 6's ranks and return their results (rank order): gloo
    ranks all on the first card, NCCL ranks one a card."""
    from viterbidecodercpp_torch.parallel import launch
    me = os.path.abspath(__file__)
    launch.spawn_fleet(
        lambda r, init: [sys.executable, me, "--rank", str(r), "--world",
                         str(world), "--init-method", init, "--backend",
                         backend, "--work", work, "--seed", str(seed)],
        world, timeout=600,
        env={"CUDA_VISIBLE_DEVICES": "0"} if backend == "gloo" else None)
    res = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            out = json.load(f)
        with np.load(os.path.join(work, f"rank{r}.npz")) as z:
            out["bits"] = {k: z[k] for k in z.files}
        res.append(out)
    return res


def phase6(pt, dev, card: str, launches: dict, err: dict, seed: int,
           backends=("gloo", "nccl")) -> dict:
    """The parallel layer: spawn the fleets, hold their results against
    the single-process decode of the same streams on this card, print the
    times; returns the JSON line's ``parallel`` entry.  ``backends`` picks
    the fleets (a four-card run of the NCCL fleet alone passes
    ``("nccl",)``)."""
    import tempfile
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    fleets = [("gloo", 4)] + ([("nccl", min(4, cards))] if cards >= 2
                              else [])
    fleets = [f for f in fleets if f[0] in backends]
    print(f"phase6 fleets: {', '.join(f'{w} {b} ranks' for b, w in fleets)}"
          f" ({cards} card(s); gloo ranks share cuda:0 and stage halos "
          f"through host memory"
          f"{'' if cards >= 2 else '; no NCCL fleet on one card'})",
          flush=True)
    results = {}
    for backend, world in fleets:
        with tempfile.TemporaryDirectory() as work:
            t0 = time.perf_counter()
            results[backend] = run_fleet(backend, world, seed, work)
            secs = time.perf_counter() - t0
        ranks = results[backend]
        require(all(r["nvcc_seconds"] == 0 for r in ranks),
                "a rank rebuilt a kernel")
        counts = {k: sum(r["launches"][k] for r in ranks) for k in KERNELS}
        add_counts(launches, counts,
                   sorted({k for route in ROUTE_KERNELS.values()
                           for k in route} | {"awgn_channel"}),
                   f"phase 6's {backend} fleet")
        for r in ranks:
            for key, c in r["check"].items():
                for name in ROUTE_KERNELS[key.split("/")[0]]:
                    err[name] = max(err[name], c["max_abs_err"])
        full = {k: [round(r["check"][k]["seconds"], 3) for r in ranks]
                for k in ranks[0]["check"] if "full width" in k}
        print(f"phase6 {backend} fleet: {world} ranks ran in {secs:.1f} s; "
              f"the kernels inside the layer == its plain versions on every "
              f"rank's full-width tile of the main path's time-SP cases "
              f"(plain decode seconds a rank {full}), and == the plain "
              f"versions and the plain scan at B={CHECK_B}, {CHECK_L} rows "
              f"a tile, overlap {CHECK_O}, padding {list(CHECK_PADS)} rows; "
              f"halo mismatches "
              f"{ {k: c['mism'] for k, c in ranks[0]['check'].items()} }; "
              f"launches { {k: v for k, v in counts.items() if v} }",
              flush=True)

    out = {"fleets": {b: w for b, w in fleets}, "sp": {}}
    for label, stream, overlap, ndata, route in SP_CASES:
        name, mode, B, nbits = SP_STREAMS[stream]
        code, config, syms, T = sp_stream(pt, stream, nbits, B, 1,
                                          stream_seed(seed, stream), dev)
        dec = pt.ViterbiDecoder(code, config, device=dev)
        require(dec.backend == route, f"{label}: the decoder took "
                                      f"{dec.backend}")
        flat = syms.reshape(B, -1)
        del syms
        single, _, _ = dec.decode(flat, nbits)
        single = single.cpu().numpy()
        single_ms = time_ms(lambda: dec.decode(flat, nbits), 3, 1)
        del flat
        for backend, ranks in results.items():
            world = len(ranks)
            if world % ndata or world == ndata:
                continue
            ntime = world // ndata
            Bl = B // ndata
            got = np.zeros((B, ntime * ranks[0]["sp"][label]["rows"]),
                           np.uint8)
            for r in ranks:
                d, t = divmod(r["rank"], ntime)
                L = r["sp"][label]["rows"]
                got[d * Bl:(d + 1) * Bl, t * L:(t + 1) * L] = np.unpackbits(
                    r["bits"][label], axis=1, count=L)
                require(r["sp"][label]["mism"] == 0,
                        f"{label} ({backend}): {r['sp'][label]['mism']} "
                        f"halo mismatches")
            wrong = int((got[:, code.K - 1:code.K - 1 + nbits]
                         != single).sum())
            require(wrong == 0, f"{label} ({backend}): {wrong} bits differ "
                                f"from the single-process decode")
            sp = [r["sp"][label] for r in ranks]
            row = {"frames": B, "rows": T, "overlap": overlap,
                   "mesh": [ndata, ntime], "route": route,
                   "tile_ms": [s["tile_ms"] for s in sp],
                   "exchange_ms": [s["exchange_ms"] for s in sp],
                   "wall_ms": [s["wall_ms"] for s in sp],
                   "single_decode_ms": single_ms}
            out["sp"][f"{label}/{backend}"] = row
            print(f"phase6 ok: time-SP {label} ({route}) {name} {mode} "
                  f"B={B} x {nbits} bits (T={T}), overlap {overlap}, mesh "
                  f"data={ndata} x time={ntime}, {backend}: bits == the "
                  f"single-process decode, 0 halo mismatches; per rank tile "
                  f"{[round(x, 3) for x in row['tile_ms']]} ms, exchange "
                  f"{[round(x, 3) for x in row['exchange_ms']]} ms (CUDA "
                  f"events), whole call "
                  f"{[round(x, 3) for x in row['wall_ms']]} ms (host clock); "
                  f"single-process decode {single_ms:.4f} ms (CUDA events, "
                  f"median of 3); on {card}",
                  flush=True)
        del single

    for backend, ranks in results.items():
        world = len(ranks)
        frames = [dp_frames(pt, seed, r, dev) for r in range(world)]
        code, config = frames[0][:2]
        syms = torch.cat([f[2] for f in frames]).reshape(world * DP_B, -1)
        dec = pt.ViterbiDecoder(code, config, device=dev)
        single, _, _ = dec.decode(syms, DP_BITS)
        got = np.concatenate([np.unpackbits(r["bits"]["frame_dp"], axis=1,
                                            count=DP_BITS) for r in ranks])
        require(np.array_equal(got, single.cpu().numpy()),
                f"frame-DP ({backend}) bits != the single-process decode")
        totals = {r["frame_dp"]["errs"] for r in ranks}
        own = sum(r["frame_dp"]["own"] for r in ranks)
        require(totals == {own} and own > 0,
                f"frame-DP ({backend}): error totals {totals}, the ranks' "
                f"own counts sum to {own}")
        del frames, syms, single
        ber_rows = []
        for i, ebno in enumerate(BER_DP_EBNO_DB):
            group = {tuple(r["ber"][i]["group"]) for r in ranks}
            alone = [sum(r["ber"][i]["alone"][j] for r in ranks)
                     for j in (0, 1)]
            require(group == {tuple(alone)} and alone[0] == BER_DP_BATCHES
                    * world * BER_DP_B * BER_DP_BLOCK,
                    f"BER point at {ebno} dB ({backend}): group totals "
                    f"{group}, the ranks' own points sum to {alone}")
            ber_rows.append({"EbNo_dB": ebno, "bits": alone[0],
                             "errors": alone[1]})
        out[f"frame_dp/{backend}"] = {"errors": own}
        out[f"ber/{backend}"] = ber_rows
        print(f"phase6 ok: frame-DP {DP_CODE} {DP_MODE} {world} x {DP_B} "
              f"frames x {DP_BITS} bits at {DP_EBNO_DB} dB ({backend}): bits "
              f"== the single-process decode, error total {own} == the "
              f"ranks' own counts; BER points group= == the sum of the "
              f"ranks' own points: "
              f"{[(r['EbNo_dB'], r['bits'], r['errors']) for r in ber_rows]}",
              flush=True)
    return out


# -- phase 7: the harness on the card ----------------------------------------
# The fuzzer's fixed cases, seeds 0 .. FUZZ_CASES - 1: deterministic, and
# they reach every category of torch_fuzz_differential.REQUIRED (K=12/13
# rotated block, the K=17 cluster and K = 18..20 among them; K=20 seeds
# launch the global-metric plane ACS).
FUZZ_CASES = 500
# the truncated-walk delta: Cassini SOFT16 at 0.5 dB, 4 batches of 64
# frames x 1024 bits, tiles of 512 rows with 160 rows of warm-up; the
# first batch's plane ACS, exact and truncated walk held to their plain
# versions (tolerance 0)
TRUNC_DELTA = {"bits": 1 << 18, "batch": 64, "block_bits": 1024}
# torch_run_benchmark.py's kernel routes, -T 0.5 a combination, -M 256
# (2048 data bits a frame): (code, decode type, frames)
BENCH_ROWS = (("Voyager", "SOFT8", 1024), ("Cassini", "SOFT16", 512),
              ("K=18", "SOFT16", K18_B))
BENCH_SECONDS, BENCH_BYTES = 0.5, 256


def phase7(dev, launches: dict, card: str) -> dict:
    """The port's harness tools, in this process, through the kernels:
    the run_tests matrix on both routes, run_simple, the Voyager and
    Cassini streams, the truncated-walk BER delta, FUZZ_CASES seeded
    fuzz cases against numpy_ref, then the measurement tools: the
    benchmark's BENCH_ROWS through the JAX package's readers (in a
    temporary directory) and a profile of Voyager decodes.  A failure
    raises; every kernel must have launched.  Returns the JSON line's
    ``harness`` entry."""
    import tempfile

    import viterbidecodercpp_torch as pt
    from tools import (torch_ber_truncated_delta, torch_fuzz_differential,
                       torch_profile_trace, torch_run_benchmark,
                       torch_run_simple, torch_run_streaming, torch_run_tests)
    reset_counts()
    seconds = {}
    t0 = time.perf_counter()
    m = torch_run_tests.run_matrix(dev)
    seconds["run_tests"] = time.perf_counter() - t0
    require(not m["failures"], f"torch_run_tests failed: {m['failures']}")
    require(m["skipped"] == 1 and m["passed"] == m["total"] - 1,
            f"torch_run_tests: {m['passed']}/{m['total']} passed, "
            f"{m['skipped']} skipped")
    require(set(m["routes"]) == {"rotated", "plane", "lane", "torch"},
            f"torch_run_tests took the routes {m['routes']}")
    print(f"phase7 run_tests: {m['passed']}/{m['total'] - m['skipped']} "
          f"passed, {m['skipped']} skipped, routes {m['routes']} "
          f"({seconds['run_tests']:.2f} s)", flush=True)
    t = time.perf_counter()
    r = torch_run_simple.run(dev)
    require(r["bit_errors"] == 0 and r["backend"] == "rotated",
            f"torch_run_simple: {r['bit_errors']} bit errors on the "
            f"{r['backend']} route")
    streams = {}
    for name, route in (("voyager", "rotated"), ("cassini", "plane")):
        s = torch_run_streaming.run(name, dev)
        require(s["bit_errors"] == 0 and s["backend"] == route,
                f"torch_run_streaming {name}: {s['bit_errors']} bit errors "
                f"on the {s['backend']} route")
        streams[name] = s["bit_errors"]
    seconds["simple_and_streams"] = time.perf_counter() - t
    print(f"phase7 run_simple: DAB Radio SOFT16 1024 bytes, "
          f"{r['bit_errors']} bit errors, final metric {r['final_error']}; "
          f"run_streaming voyager (rotated) and cassini (plane): "
          f"{streams} bit errors ({seconds['simple_and_streams']:.2f} s)",
          flush=True)
    t = time.perf_counter()
    d = torch_ber_truncated_delta.measure(dev, **TRUNC_DELTA)
    seconds["truncated_delta"] = time.perf_counter() - t
    bad = torch_ber_truncated_delta.verdict(d)
    require(not bad, f"truncated delta: {bad}")
    print(f"phase7 truncated delta: {d['code']} SOFT16 0.5 dB, {d['bits']} "
          f"bits, block 512 overlap 160: BER exact {d['ber_exact']:.6e} "
          f"({d['errors_exact']}), truncated {d['ber_truncated']:.6e} "
          f"({d['errors_truncated']}), delta "
          f"{d['ber_truncated'] - d['ber_exact']:+.3e}, disagreement "
          f"{d['disagreement']:.3e} ({d['disagree']} bits); the first "
          f"batch's plane ACS, exact and truncated walk equal to their "
          f"plain versions "
          f"({seconds['truncated_delta']:.2f} s)", flush=True)
    f = torch_fuzz_differential.run(FUZZ_CASES, 0, dev)
    seconds["fuzz"] = f["seconds"]
    missing = [c for c in torch_fuzz_differential.REQUIRED
               if not f["counts"].get(c)]
    require(not missing, f"the fuzz cases did not reach {missing}")
    print(f"phase7 fuzz: {f['cases']} seeded cases, 0 mismatches against "
          f"numpy_ref in {f['seconds']:.2f} s "
          f"({f['cases'] / f['seconds']:.2f} cases/s); {f['counts']}",
          flush=True)
    # the measurement tools: the benchmark's rows through the JAX
    # package's unmodified readers, and a profile of Voyager decodes
    t = time.perf_counter()
    rows = []
    for name, mode, B in BENCH_ROWS:
        code = big_code(pt, 18) if name == "K=18" else pt.get_code(name)
        rows += torch_run_benchmark.run([code], [pt.DecodeType(mode)],
                                        ["cuda"], B, BENCH_BYTES,
                                        BENCH_SECONDS, dev)
    routes = [r["simd_type"] for r in rows]
    require(routes == ["ROTATED", "PLANE", "PLANE"],
            f"torch_run_benchmark took the routes {routes}")
    readers = {}
    with tempfile.TemporaryDirectory() as work:
        bench_path = os.path.join(work, "torch_benchmark.json")
        with open(bench_path, "w") as fh:
            json.dump(rows, fh, indent=1)
        for tool in ("parse_benchmark.py", "compare_benchmark.py"):
            proc = subprocess.run(
                [sys.executable, os.path.join("tools", tool), bench_path],
                capture_output=True, text=True, timeout=300)
            require(proc.returncode == 0, f"{tool} refused the benchmark's "
                                          f"rows: {proc.stderr[-2000:]}")
            readers[tool] = proc.stdout
        prof = torch_profile_trace.trace(work, 8, "voyager", dev)
    print(f"phase7 run_benchmark: {len(rows)} rows (kernel routes, "
          f"-T {BENCH_SECONDS}, {BENCH_BYTES * 8} data bits a frame) read by "
          f"parse_benchmark.py and compare_benchmark.py (exit 0), on {card}:"
          f"\n{readers['parse_benchmark.py'].rstrip()}", flush=True)
    seconds["measurement_tools"] = time.perf_counter() - t
    top = "; ".join(f"{k} {ms:.3f} ms x{c}" for k, ms, c in prof["top"][:4])
    print(f"phase7 profile_trace: voyager, {prof['reps']} decodes of "
          f"B={prof['B']} x T={prof['T']} ({prof['route']}), window "
          f"{prof['window_ms']:.3f} ms, device busy "
          f"{prof['device_busy_ms']:.3f} ms, idle share "
          f"{prof['idle_share']:.4f}; top: {top} "
          f"({seconds['measurement_tools']:.2f} s with the benchmark)",
          flush=True)
    torch.cuda.synchronize()
    counts = read_counts()
    add_counts(launches, counts, DECODE_KERNELS, "phase 7 (the harness)")
    seconds["total"] = time.perf_counter() - t0
    print(f"phase7 ok: the harness on the card in {seconds['total']:.2f} s; "
          f"launches {counts} on {card}", flush=True)
    return {"run_tests": {k: m[k] for k in ("total", "passed", "skipped")},
            "stream_bit_errors": streams,
            "truncated_delta": {k: d[k] for k in (
                "bits", "errors_exact", "errors_truncated", "disagree")},
            "fuzz": {"cases": f["cases"], "counts": f["counts"]},
            "benchmark": [{k: r[k] for k in (
                "name", "decode_type", "simd_type", "batch",
                "update_symbols_ns", "chainback_bits_ns")} for r in rows],
            "profile": {k: prof[k] for k in (
                "window_ms", "device_busy_ms", "idle_share")},
            "seconds": seconds}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # phase 6's ranks (the script spawns them itself)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--backend", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--work", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs a CUDA card")
    if args.rank is not None:
        phase6_rank(args)
        return
    import viterbidecodercpp_torch as pt
    from viterbidecodercpp_torch.ops import (_build, chainback, encoder,
                                             lane, plane, rotated, torch_core)
    from viterbidecodercpp_torch.utils import native

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(args.seed)
    t_run = time.perf_counter()

    def mark(what: str) -> None:
        print(f"elapsed {time.perf_counter() - t_run:.1f} s after {what}",
              flush=True)

    # -- phase 1: device and build --------------------------------------
    card = card_line()
    print(card, flush=True)
    print(f"phase1 torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        host_lib = pool.submit(native.ensure_built)
        list(pool.map(_build.load, KERNELS))
        host_lib.result()
    for name in KERNELS:
        print(f"phase1 built {name}: nvcc {_build.build_seconds[name]:.2f} s",
              flush=True)
    print(f"phase1 built the native host chain (native/sigchain.cpp): g++ "
          f"{native.build_seconds:.2f} s", flush=True)
    print(f"phase1 all {len(KERNELS)} kernels and the host chain built and "
          f"loaded in {time.perf_counter() - t0:.2f} s (parallel nvcc, g++)",
          flush=True)

    mark("phase 1")

    # -- phase 2: kernels vs plain across each class --------------------
    err = phase2(pt, torch_core, rotated, chainback, dev, rng)
    err.update(phase2b(pt, torch_core, plane, dev, rng))
    for name, e in phase2c(pt, dev, rng).items():
        err[name] = max(err.get(name, 0), e)
    for name, e in phase2d(pt, torch_core, plane, dev, rng).items():
        err[name] = max(err.get(name, 0), e)

    mark("phase 2")

    # -- phase 3: the flagship path at full size ------------------------
    code = pt.get_code("Voyager")
    B, N = 1024, 2042
    T = N + code.K - 1
    data = rng.randint(0, 2, (B, N)).astype(np.uint8)
    clean = encoder.encode_symbols(code, torch.as_tensor(data, device=dev),
                                   3, -3).cpu().numpy()
    # mild noise: every symbol keeps its sign, so the decode is exact
    noisy = np.clip(clean + rng.randint(-2, 3, clean.shape), -3, 3)
    syms = torch.as_tensor(noisy.reshape(B, T * code.R).astype(np.int32),
                           device=dev)
    dec = pt.ViterbiDecoder(code, "SOFT8", device=dev)
    reset_counts()
    bits, final_err, acc = dec.decode(syms, N)
    torch.cuda.synchronize()
    launches = {}
    add_counts(launches, read_counts(), ("rotated_acs", "chainback"),
               "the main path")
    exact = exact_frames(bits, torch.as_tensor(data, device=dev))
    require(exact == B, f"only {exact} of {B} frames decoded exactly")
    spec = dec.spec
    m0 = torch_core.initial_metrics(spec, B, 0, dev)
    syms3 = syms.reshape(B, T, code.R)
    ref_m, ref_p, ref_acc = torch_core.acs_scan(spec, m0, syms3)
    ref_bits = torch_core.chainback_scan(
        spec, ref_p, torch.zeros(B, dtype=torch.int32, device=dev), N)
    require(torch.equal(bits, ref_bits), "decode bits != plain scan")
    require(torch.equal(final_err, ref_m[0]), "final error != plain scan")
    require(torch.equal(acc, ref_acc), "acc != plain scan")
    state = dec.reset(B)
    cuts = (0, 677, 1301, T)           # chunk lengths not multiples of n
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        state = dec.update(state, syms[:, lo * code.R:hi * code.R])
    ragged = dec.chainback(state, N)
    require(torch.equal(ragged, ref_bits), "ragged-update bits != plain")
    require(torch.equal(state.metrics, ref_m), "ragged metrics != plain")
    require(torch.equal(state.accumulated_error, ref_acc),
            "ragged acc != plain")
    print(f"phase3 ok: Voyager SOFT8 B={B} T={T}: {exact}/{B} frames exact; "
          f"bits, final metrics and acc == plain state-order scan; ragged "
          f"updates of {np.diff(cuts).tolist()} steps agree; launches "
          f"{launches}",
          flush=True)
    del ref_p

    # -- phase 3b: the big-state path at full size ----------------------
    big = pt.get_code("Cassini")
    Bb, Nb = 512, 2048
    Tb = Nb + big.K - 1
    Rb = big.R
    data_b = torch.as_tensor(rng.randint(0, 2, (Bb, Nb)).astype(np.uint8),
                             device=dev)
    clean = encoder.encode_symbols(big, data_b, 127, -127).cpu().numpy()
    # mild noise: every symbol keeps its sign, so the decode is exact
    noisy = np.clip(clean + rng.randint(-60, 61, clean.shape), -127, 127)
    syms_b = torch.as_tensor(noisy.reshape(Bb, Tb * Rb).astype(np.int32),
                             device=dev)
    dec_b = pt.ViterbiDecoder(big, "SOFT16", device=dev)
    require(dec_b.backend == "plane", f"Cassini took the {dec_b.backend} "
                                      f"backend on the card")
    reset_counts()
    bits_b, final_err_b, acc_b = dec_b.decode(syms_b, Nb)
    state_b = dec_b.reset(Bb)
    cuts_b = (0, 701, 1402, Tb)        # chunk lengths not multiples of n
    for lo, hi in zip(cuts_b[:-1], cuts_b[1:]):
        state_b = dec_b.update(state_b, syms_b[:, lo * Rb:hi * Rb])
    ragged_b = dec_b.chainback(state_b, Nb)
    trunc_b = dec_b.chainback(state_b, Nb, mode="truncated")
    torch.cuda.synchronize()
    cassini_kernels = ("plane_acs", "plane_walk", "plane_walk_trunc")
    add_counts(launches, read_counts(), cassini_kernels, "the big-state path")
    exact_b = exact_frames(bits_b, data_b)
    require(exact_b == Bb, f"only {exact_b} of {Bb} Cassini frames decoded "
                           f"exactly")
    spec_b = dec_b.spec
    m0_b = torch_core.initial_metrics(spec_b, Bb, 0, dev)
    syms3_b = syms_b.reshape(Bb, Tb, Rb)
    ref_m, ref_p, ref_acc = torch_core.acs_scan(spec_b, m0_b, syms3_b)
    ref_bits = torch_core.chainback_scan(
        spec_b, ref_p, torch.zeros(Bb, dtype=torch.int32, device=dev), Nb)
    del ref_p
    require(torch.equal(bits_b, ref_bits), "Cassini bits != plain scan")
    require(torch.equal(final_err_b, ref_m[0]),
            "Cassini final error != plain scan")
    require(torch.equal(acc_b, ref_acc), "Cassini acc != plain scan")
    require(torch.equal(ragged_b, ref_bits),
            "Cassini ragged-update bits != plain")
    require(torch.equal(state_b.metrics, ref_m),
            "Cassini ragged metrics != plain")
    require(torch.equal(state_b.accumulated_error, ref_acc),
            "Cassini ragged acc != plain")
    require(torch.equal(trunc_b, ragged_b),
            "Cassini truncated chainback != exact chainback")
    print(f"phase3b ok: Cassini SOFT16 B={Bb} T={Tb}: {exact_b}/{Bb} frames "
          f"exact; bits, final metrics and acc == plain state-order scan; "
          f"ragged updates of {np.diff(cuts_b).tolist()} steps agree; "
          f"truncated chainback (block 512, overlap 128) == exact; launches "
          f"{ {k: launches[k] for k in cassini_kernels} }", flush=True)

    # -- phase 3c: the lane path at full size ----------------------------
    dec_l, syms_l, Nl = phase3c(pt, dev, rng, launches)

    # -- phase 3d: streaming at full size --------------------------------
    streams = phase3d(pt, dev, rng, launches, args.seed)

    # -- phase 3e: K >= 18 at full width -----------------------------------
    big_decodes = phase3e(pt, dev, rng, launches)

    mark("phase 3")

    # -- phase 4: times on the card --------------------------------------
    ends = torch.zeros(B, dtype=torch.int32, device=dev)
    k_out = rotated.acs_rotated(spec, m0, syms3)
    p_out = rotated.acs_rotated_ref(spec, m0, syms3)
    e = max(max_abs_diff(g, w) for g, w in zip(k_out, p_out))
    require(e == 0, "rotated ACS kernel != plain at the main-path shape")
    err["rotated_acs"] = max(err["rotated_acs"], e)
    rots = state.row_rots
    walk = chainback.chainback(spec, k_out[1], ends, N, slot_order=True,
                               rots=rots)
    walk_ref = chainback.chainback_ref(spec, k_out[1], ends, N,
                                       slot_order=True, rots=rots)
    e = max_abs_diff(walk, walk_ref)
    require(e == 0, "walk kernel != plain at the main-path shape")
    err["chainback"] = max(err["chainback"], e)
    ms = {
        "rotated_acs": time_ms(lambda: rotated.acs_rotated(spec, m0, syms3)),
        "chainback": time_ms(lambda: chainback.chainback(
            spec, k_out[1], ends, N, slot_order=True, rots=rots)),
    }
    plain_ms = {
        "rotated_acs": time_ms(
            lambda: rotated.acs_rotated_ref(spec, m0, syms3)),
        "chainback": time_ms(lambda: chainback.chainback_ref(
            spec, k_out[1], ends, N, slot_order=True, rots=rots)),
    }
    decode_ms = time_ms(lambda: dec.decode(syms, N))
    rate = B * T * code.R / (decode_ms / 1e3)
    del k_out, p_out

    # -- phase 4b: the plane kernels at the big-state path's shape --------
    ends_b = torch.zeros(Bb, dtype=torch.int32, device=dev)
    k_out = plane.acs_plane(spec_b, m0_b, syms3_b)
    p_out = plane.acs_plane_ref(spec_b, m0_b, syms3_b)
    e = max(max_abs_diff(g, w) for g, w in zip(k_out, p_out))
    require(e == 0, "plane ACS kernel != plain at the big-state shape")
    err["plane_acs"] = max(err["plane_acs"], e)
    del p_out
    rows_b = k_out[1]
    e = max_abs_diff(plane.walk_plane_frames(spec_b, rows_b, ends_b),
                     plane.walk_plane_frames_ref(spec_b, rows_b, ends_b))
    require(e == 0, "plane walk kernel != plain at the big-state shape")
    err["plane_walk"] = max(err["plane_walk"], e)
    e = max_abs_diff(
        plane.chainback_plane_truncated(spec_b, rows_b, ends_b, Nb),
        plane.chainback_plane_truncated_ref(spec_b, rows_b, ends_b, Nb))
    require(e == 0, "truncated walk kernel != plain at the big-state shape")
    err["plane_walk_trunc"] = max(err["plane_walk_trunc"], e)
    ms["plane_acs"] = time_ms(
        lambda: plane.acs_plane(spec_b, m0_b, syms3_b))
    ms["plane_walk"] = time_ms(
        lambda: plane.walk_plane_frames(spec_b, rows_b, ends_b))
    ms["plane_walk_trunc"] = time_ms(
        lambda: plane.chainback_plane_truncated(spec_b, rows_b, ends_b, Nb))
    plain_ms["plane_acs"] = time_ms(
        lambda: plane.acs_plane_ref(spec_b, m0_b, syms3_b), PLAIN_REPS, 1)
    plain_ms["plane_walk"] = time_ms(
        lambda: plane.walk_plane_frames_ref(spec_b, rows_b, ends_b),
        PLAIN_REPS, 1)
    plain_ms["plane_walk_trunc"] = time_ms(
        lambda: plane.chainback_plane_truncated_ref(spec_b, rows_b, ends_b,
                                                    Nb), PLAIN_REPS, 1)
    decode_ms_b = time_ms(lambda: dec_b.decode(syms_b, Nb))
    rate_b = Bb * Tb * Rb / (decode_ms_b / 1e3)
    del k_out, rows_b

    # -- phase 4c: the lane path's kernels and the streams ----------------
    spec_l = dec_l.spec
    Bl, Rl = syms_l.shape[0], spec_l.R
    Tl = syms_l.shape[1] // Rl
    syms3_l = syms_l.reshape(Bl, Tl, Rl)
    m0_l = torch_core.initial_metrics(spec_l, Bl, 0, dev)
    ends_l = torch.zeros(Bl, dtype=torch.int32, device=dev)
    k_out = lane.acs_lane(spec_l, m0_l, syms3_l)
    p_out = lane.acs_lane_ref(spec_l, m0_l, syms3_l)
    e = max(max_abs_diff(g, w) for g, w in zip(k_out, p_out))
    require(e == 0, "lane ACS kernel != plain at the lane path's shape")
    err["lane_acs"] = max(err["lane_acs"], e)
    e = max_abs_diff(chainback.chainback(spec_l, k_out[1], ends_l, Nl),
                     chainback.chainback_ref(spec_l, k_out[1], ends_l, Nl))
    require(e == 0, "state-order walk kernel != plain at the lane shape")
    err["chainback"] = max(err["chainback"], e)
    ms["lane_acs"] = time_ms(lambda: lane.acs_lane(spec_l, m0_l, syms3_l))
    plain_ms["lane_acs"] = time_ms(
        lambda: lane.acs_lane_ref(spec_l, m0_l, syms3_l), PLAIN_REPS, 1)
    walk_ms_l = time_ms(lambda: chainback.chainback(spec_l, k_out[1],
                                                    ends_l, Nl))
    decode_ms_l = time_ms(lambda: dec_l.decode(syms_l, Nl))
    rate_l = Bl * Tl * Rl / (decode_ms_l / 1e3)
    stream_times = []
    for label, sd, st, block in streams:
        push_ms = time_ms(chained_push(sd, st, block), PUSH_REPS, 5)
        stream_times.append({"stream": label, "route": sd.backend,
                             "push_ms": push_ms,
                             "streamed_symbols_per_s":
                                 block.numel() / (push_ms / 1e3)})
    # -- phase 4e: the plane ACS past K=17 beside its bounds ---------------
    big_times = phase4e(pt, dev, rng, card)
    # -- phase 4f: the channel kernel at the BER cell's batch --------------
    ch = phase4f(pt, dev)
    err["awgn_channel"] = ch["max_abs_err"]
    ms["awgn_channel"] = ch["ms"]
    plain_ms["awgn_channel"] = ch["plain_ms"]
    wide = big_times[f"K={WIDE_K[0]}"]
    ms["plane_acs_global"] = wide["ms"]
    plain_ms["plane_acs_global"] = wide["plain_ms"]
    rows_w = N + code.K - 1                  # the chainback's rows
    nb = Nb + big.K - 1
    tiles = range(0, nb, 512)                # the truncated walk's tiles
    bounds = {
        "rotated_acs": acs_bound(spec.S, B, T, spec.R, spec.W),
        "chainback": walk_bound(rows_w, B, rows_w, 1),
        "plane_acs": acs_bound(spec_b.S, Bb, Tb, Rb, spec_b.W),
        "plane_walk": walk_bound(Tb, Bb, Tb, 0),
        "plane_walk_trunc": walk_bound(
            sum(min(b0 + 512 + 128, nb) - b0 for b0 in tiles), Bb, Nb, 0),
        "lane_acs": acs_bound(spec_l.S, Bl, Tl, Rl, spec_l.W),
        "plane_acs_global": (wide["bound_ms"], wide["bound_by"]),
        "awgn_channel": ch["bound"],
    }
    shapes = {"rotated_acs": f"Voyager SOFT8 B={B} T={T}",
              "chainback": f"Voyager SOFT8 B={B} T={T}",
              "plane_acs": f"Cassini SOFT16 B={Bb} T={Tb}",
              "plane_walk": f"Cassini SOFT16 B={Bb} T={Tb}",
              "plane_walk_trunc": f"Cassini SOFT16 B={Bb} T={Tb}, "
                                  f"block 512 overlap 128",
              "lane_acs": f"Basic K=5 SOFT16 B={Bl} T={Tl}",
              "plane_acs_global": f"K={WIDE_K[0]} SOFT16 B={wide['B']} "
                                  f"T={wide['T']}",
              "awgn_channel": ch["shape"]}
    for name in KERNELS:
        plain_reps = REPS if name in ("rotated_acs", "chainback") \
            else PLAIN_REPS
        bms, by = bounds[name]
        print(f"phase4 {name}: kernel {ms[name]:.4f} ms (median of {REPS}), "
              f"plain {plain_ms[name]:.4f} ms (median of {plain_reps}), "
              f"bound {bms:.6f} ms ({by}), share of the bound "
              f"{bms / ms[name]:.4f}, {shapes[name]}, on {card}", flush=True)
    print(f"phase4 decode: {decode_ms:.4f} ms = {rate:.4e} decoded "
          f"symbols/s (B*T*R / s, Voyager SOFT8 B={B} T={T}) on {card}",
          flush=True)
    print(f"phase4 decode: {decode_ms_b:.4f} ms = {rate_b:.4e} decoded "
          f"symbols/s (B*T*R / s, Cassini SOFT16 B={Bb} T={Tb}) on {card}",
          flush=True)
    print(f"phase4 state-order walk kernel {walk_ms_l:.4f} ms; Basic K=5 "
          f"SOFT16 B={Bl} T={Tl} on {card}", flush=True)
    print(f"phase4 decode: {decode_ms_l:.4f} ms = {rate_l:.4e} decoded "
          f"symbols/s (B*T*R / s, Basic K=5 SOFT16 B={Bl} T={Tl}) on {card}",
          flush=True)
    for t in stream_times:
        print(f"phase4 stream {t['stream']} ({t['route']}): "
              f"{t['push_ms']:.4f} ms per push (median of {PUSH_REPS}) = "
              f"{t['streamed_symbols_per_s']:.4e} streamed symbols/s "
              f"(B*chunk*R / s) on {card}", flush=True)

    mark("phase 4")

    # -- phase 4d: the BER loop's times -----------------------------------
    ber_loop = phase4d(pt, dev, card, launches, err)

    mark("phase 4d")

    # -- phase 5: the BER engine against the reference curves -------------
    ber_points = phase5(pt, dev, launches, err, args.seed)

    # -- phase 5b: DAB FIC punctured decode ---------------------------------
    phase5b(dev, launches)

    mark("phase 5")

    # -- phase 6: the parallel layer -----------------------------------------
    parallel = phase6(pt, dev, card, launches, err, args.seed)

    mark("phase 6")

    # -- phase 7: the harness on the card ------------------------------------
    harness = phase7(dev, launches, card)
    mark("phase 7")

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": ms[name], "plain_ms": plain_ms[name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "bound_share": bounds[name][0] / ms[name],
         # no single PyTorch call computes an ACS, a traceback or the
         # channel
         "library_ms": None}
        for name, (src, tpu) in KERNELS.items()],
        "decode_ms": decode_ms, "decoded_symbols_per_s": rate,
        "cassini_decode_ms": decode_ms_b,
        "cassini_decoded_symbols_per_s": rate_b,
        "lane_decode_ms": decode_ms_l,
        "lane_decoded_symbols_per_s": rate_l,
        "streams": stream_times, "big_decodes": big_decodes,
        "big_plane_times": big_times, "ber_loop": ber_loop,
        "ber_points": {k: ber_points[k] for k in ("bits", "seconds")},
        "parallel": parallel, "harness": harness}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as exc:
        sys.exit(f"chip_smoke FAILED: {exc}")
