#!/usr/bin/env python3
"""Variants of the global-metric plane ACS (csrc/plane_acs_global.cu,
K >= 20), timed in turns on one card.

    python3 tools/torch_global_variants.py [--out FILE] [--seed N]

Each variant is the kernel's source with one edit, built with the
package's nvcc flags into ``viterbidecodercpp_torch/_build/variants/``
and called through ``ops.plane.acs_plane`` in place of the built
kernel (the C entry is the same):

* ``this``: the source as it is;
* ``strided``: block g steps tiles g, g + grid, ... in place of its run
  of consecutive tiles, so a block's tiles at one step lie in different
  frames and its branch-metric table is built for each;
* ``g4``: four slots' loads in flight a thread in place of eight (64
  registers: four blocks an SM);
* ``no_slots``: the slot loop removed - the entry, exit, table builds,
  minima, word stores and barriers alone (wrong outputs);
* ``no_barrier``: the grid barrier between steps removed (wrong outputs).

At each of ``SHAPES`` (chip_smoke.py phase 4e's K=20 and K=21 codes at
B=4, and K=23 B=3, where each block steps several tiles), the exact
variants are checked equal to the plain version, and every variant is
timed (CUDA events, median of 7 after 2 warm-up calls) in turns: each in
order, then in reverse.  Prints ptxas's registers and spills of each
variant and one JSON line (also written to FILE).  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import viterbidecodercpp_torch as pt  # noqa: E402
from viterbidecodercpp_torch.ops import _build, plane, torch_core  # noqa: E402

SHAPES = ((20, 4, 531), (21, 4, 532), (23, 3, 67))
BIG_TAPS = (0o12345, 0o7651)
EXACT = ("this", "strided", "g4")
TILE_LOOP = "for (int i = first; i < last; ++i) {"
STEP_BARRIER = ("    if (fb >= 0) fold_min(lmin, red, c.mins + cell + fb);\n"
                "    grid.sync();\n")


def variants(src: str) -> dict:
    """The variant sources; raises if an edit no longer applies."""
    edits = {
        "strided": (TILE_LOOP, "for (int i = blockIdx.x; i < (B << tpf_log);"
                               " i += gridDim.x) {", 3),
        "g4": ("#define VDT_GROUP_K 8", "#define VDT_GROUP_K 4", 1),
        "no_slots": ("for (int k0 = 0; k0 < 32;", "for (int k0 = 0; k0 < 0;",
                     1),
        "no_barrier": (STEP_BARRIER, STEP_BARRIER.split("\n")[0] + "\n", 1),
    }
    out = {"this": src}
    for name, (old, new, count) in edits.items():
        if src.count(old) != count:
            raise SystemExit(f"torch_global_variants: the {name} edit does "
                             f"not apply to plane_acs_global.cu")
        out[name] = src.replace(old, new)
    return out


def build(name: str, src: str) -> tuple:
    """nvcc the variant with ptxas's report; (name, (library, report))."""
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on the {name} variant:\n"
                         f"{proc.stderr}")
    report = [ln.strip() for ln in proc.stderr.splitlines()
              if "registers" in ln or "spill" in ln]
    return name, (ctypes.CDLL(str(so)), report)


def time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_global_variants: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    src = (_build.CSRC_DIR / "plane_acs_global.cu").read_text()
    srcs = variants(src)
    with ThreadPoolExecutor(len(srcs)) as pool:
        libs = dict(pool.map(lambda kv: build(*kv), srcs.items()))
    load = _build.load

    def use(name):
        # each variant has its own registers, so its own resident blocks,
        # and its own launchers to bind
        plane.RESIDENT_BLOCKS.clear()
        _build.kernel.cache_clear()
        _build.load = (lambda n: libs[name][0] if n == "plane_acs_global"
                       else load(n))

    rng = np.random.RandomState(args.seed)
    dev = torch.device("cuda", 0)
    res = {"card": card,
           "ptxas": {name: report for name, (_, report) in libs.items()},
           "shapes": []}
    try:
        for K, B, T in SHAPES:
            code = pt.CodeSpec(f"K={K}", K, tuple((1 << (K - 1)) | g
                                                  for g in BIG_TAPS))
            spec = torch_core.make_static_spec(
                code, pt.get_decode_config(pt.DecodeType.SOFT16, code.R))
            m0 = torch_core.initial_metrics(spec, B, 0, dev)
            sy = torch.as_tensor(rng.randint(-127, 128, (B, T, code.R))
                                 .astype(np.int32), device=dev)
            want = plane.acs_plane_ref(spec, m0, sy)
            grids = {}
            for name in EXACT:
                use(name)
                got = plane.acs_plane(spec, m0, sy)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise SystemExit(f"torch_global_variants: {name} != "
                                     f"plain at K={K} B={B} T={T}")
                grids[name] = plane.global_grid(
                    spec.S, B, next(iter(plane.RESIDENT_BLOCKS.values())))
            del want, got
            times = {}
            for name in [*srcs, *reversed(srcs)]:
                use(name)
                times.setdefault(name, []).append(
                    time_ms(lambda: plane.acs_plane(spec, m0, sy)))
            res["shapes"].append({"K": K, "B": B, "T": T, "grids": grids,
                                  "ms": times})
            print(f"K={K} B={B} T={T}: {json.dumps(res['shapes'][-1])}",
                  flush=True)
            del m0, sy
            torch.cuda.empty_cache()
    finally:
        _build.load = load
        _build.kernel.cache_clear()
        plane.RESIDENT_BLOCKS.clear()
    line = json.dumps(res)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
