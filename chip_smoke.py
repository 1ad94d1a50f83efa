#!/usr/bin/env python3
"""Smoke run of the PyTorch port (viterbidecodercpp_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and exits non-zero:

1. Device: requires ``torch.cuda.is_available()``, prints the card's
   name and power limit (nvidia-smi), builds all six CUDA kernels from
   ``viterbidecodercpp_torch/csrc`` with nvcc for sm_90a, one nvcc
   process per source, all started together (into
   ``viterbidecodercpp_torch/_build/``), and prints the build times.
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
   (bits, valid, final metrics, ring) and have launched its kernels.  Then
   Voyager on an AWGN channel (utils/testsig.py): the bit-error delta of
   windows 64, 128 and 256 against the exact decode of the same symbols.
4. Times on the card (CUDA events, warm-up, median): each kernel and its
   plain version at its path's full-size shape beside its bound (the
   larger of its bytes over the HBM rate and its int32 operations over
   the int32 rate, counted from the shapes; an ACS step counts its 2^R
   branch metrics once a frame) and its share of the bound,
   each whole decode in decoded symbols/s (B*T*R / s), and each stream's
   median ms per push (of 41: a push is host-bound) and streamed
   symbols/s (B*chunk*R / s).

The last line is ``{"ok": true, "device": {...}}``; the line before it
is a JSON object with one entry per kernel (launches on the main paths,
largest difference from the plain version, ms, plain_ms, bound_ms,
bound_by, bound_share, library_ms) and the decode and stream times.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
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
    "plane_walk": ("viterbidecodercpp_torch/csrc/plane_walk.cu",
                   "viterbidecodercpp_tpu/ops/bigstate_pallas.py:535"),
    "plane_walk_trunc": ("viterbidecodercpp_torch/csrc/plane_walk_trunc.cu",
                         "viterbidecodercpp_tpu/ops/bigstate_pallas.py:713"),
    "lane_acs": ("viterbidecodercpp_torch/csrc/lane_acs.cu",
                 "viterbidecodercpp_tpu/ops/acs_pallas.py:125"),
}
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
SWEEP_EBNO_DB = 3.0
SWEEP_WINDOWS = (64, 128, 256)
SWEEP_CHUNK = 32
SWEEP_END_BITS = 64


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


def reset_counts() -> None:
    from viterbidecodercpp_torch.ops import chainback, lane, plane, rotated
    rotated.LAUNCHES = chainback.LAUNCHES = lane.LAUNCHES = 0
    for name in plane.LAUNCHES:
        plane.LAUNCHES[name] = 0


def read_counts() -> dict:
    from viterbidecodercpp_torch.ops import chainback, lane, plane, rotated
    return {"rotated_acs": rotated.LAUNCHES, "chainback": chainback.LAUNCHES,
            "lane_acs": lane.LAUNCHES, **plane.LAUNCHES}


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
              f"ring == the plain stream on the card; launches "
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs a CUDA card")
    import viterbidecodercpp_torch as pt
    from viterbidecodercpp_torch.ops import (_build, chainback, encoder,
                                             lane, plane, rotated, torch_core)

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(args.seed)

    # -- phase 1: device and build --------------------------------------
    card = card_line()
    print(card, flush=True)
    print(f"phase1 torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.load, KERNELS))
    for name in KERNELS:
        print(f"phase1 built {name}: nvcc {_build.build_seconds[name]:.2f} s",
              flush=True)
    print(f"phase1 all {len(KERNELS)} kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (parallel nvcc)", flush=True)

    # -- phase 2: kernels vs plain across each class --------------------
    err = phase2(pt, torch_core, rotated, chainback, dev, rng)
    err.update(phase2b(pt, torch_core, plane, dev, rng))
    for name, e in phase2c(pt, dev, rng).items():
        err[name] = max(err.get(name, 0), e)

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
    add_counts(launches, read_counts(), plane.LAUNCHES, "the big-state path")
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
          f"{ {k: launches[k] for k in plane.LAUNCHES} }", flush=True)

    # -- phase 3c: the lane path at full size ----------------------------
    dec_l, syms_l, Nl = phase3c(pt, dev, rng, launches)

    # -- phase 3d: streaming at full size --------------------------------
    streams = phase3d(pt, dev, rng, launches, args.seed)

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
        push_ms = time_ms(lambda: sd.push(st, block), PUSH_REPS, 5)
        stream_times.append({"stream": label, "route": sd.backend,
                             "push_ms": push_ms,
                             "streamed_symbols_per_s":
                                 block.numel() / (push_ms / 1e3)})
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
    }
    shapes = {"rotated_acs": f"Voyager SOFT8 B={B} T={T}",
              "chainback": f"Voyager SOFT8 B={B} T={T}",
              "plane_acs": f"Cassini SOFT16 B={Bb} T={Tb}",
              "plane_walk": f"Cassini SOFT16 B={Bb} T={Tb}",
              "plane_walk_trunc": f"Cassini SOFT16 B={Bb} T={Tb}, "
                                  f"block 512 overlap 128",
              "lane_acs": f"Basic K=5 SOFT16 B={Bl} T={Tl}"}
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

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": ms[name], "plain_ms": plain_ms[name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "bound_share": bounds[name][0] / ms[name],
         # no single PyTorch call computes an ACS or a traceback
         "library_ms": None}
        for name, (src, tpu) in KERNELS.items()],
        "decode_ms": decode_ms, "decoded_symbols_per_s": rate,
        "cassini_decode_ms": decode_ms_b,
        "cassini_decoded_symbols_per_s": rate_b,
        "lane_decode_ms": decode_ms_l,
        "lane_decoded_symbols_per_s": rate_l,
        "streams": stream_times}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as exc:
        sys.exit(f"chip_smoke FAILED: {exc}")
