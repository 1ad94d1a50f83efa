#!/usr/bin/env python3
"""A/B of the port's kernels against an earlier tree's, on one card.

    python3 tools/torch_kernel_ab.py --parent DIR [--path rotated|plane|lane]
                                     [--out FILE]

DIR is a checkout of the earlier tree (for example ``git archive`` of the
parent commit, unpacked); its ``viterbidecodercpp_torch`` is imported
under another name, builds its own kernels into its own ``_build``, and
runs next to this tree's in one process.  On one CUDA card, with
``--path rotated`` (the default: the flagship path), the script

* checks both trees give the same ACS outputs, walk bits and decoded bits;
* times both in turns - earlier, this, this, earlier - (CUDA events,
  median of 7 after 2 warm-up calls; pushes median of 41 after 5) at the
  main path's shape, Voyager SOFT8 B=1024 T=2048: the rotated ACS, the
  slot-order walk and ``ViterbiDecoder.decode``; and the lane path's
  state-order walk (Basic K=5, B=512, 2052 rows) and the Voyager SOFT16
  (B=1024, window 256, chunk 64) and Basic K=5 SOFT16 (B=1024, window
  160, chunk 32) stream pushes;
* sweeps the batch of both trees' ACS at T=2048, and times both trees' ACS
  and walk at every n of the rotated class (random K=7..13 R=1/2 codes,
  SOFT8, B=1024, T=2048);
* profiles five of this tree's Voyager decodes with ``torch.profiler``:
  device time per kernel and the device's idle share of the window;
* prints ptxas's register and spill counts of both trees' two sources.

With ``--path plane`` (the big-state path, Cassini K=15 R=1/6 SOFT16) it

* checks both trees give the same plane ACS outputs (B=512, T=2062),
  exact walk bits, truncated walk bits (block 512, overlap 128) and
  decoded bits;
* times both in turns - earlier, this, this, earlier - at B=512 T=2062:
  the plane ACS, the exact plane walk and the truncated walk (on the
  ACS's rows, from random end states) and ``ViterbiDecoder.decode`` (2048
  data bits a frame); the push of a full stream (window 280, chunk 56) in
  three rounds of turns (it is host-bound and spreads);
* sweeps both trees' exact walk over B in {1, 132, 512, 2048} at T=2062
  (random words filled on the card; B=2048 is an 8.6 GB buffer) and over
  K = 14, 16 and 17 (random codes, B=512, T=2062), checked equal;
* sweeps the batch of both trees' plane ACS at T=2062 over B in {1, 132,
  264, 265, 512}: two frames share an SM, so B=265 starts a second wave;
* times both trees' plane ACS in turns on random K=17, 18 and 19 codes
  (clusters of 2, 4 and 8 blocks a frame), SOFT16, T=2064, at one frame,
  a full card and (K=17) two waves; checked equal; a code the earlier
  tree refuses is timed on this tree alone;
* prints ptxas's register and spill counts of both trees' plane_acs.cu,
  plane_walk.cu and plane_walk_trunc.cu.

With ``--path lane`` (the lane path, Basic K=5 R=1/2 SOFT16) it

* checks both trees give the same lane ACS outputs (B=512, T=2052) and
  decoded bits;
* times both in turns - earlier, this, this, earlier - at B=512 T=2052:
  the lane ACS and ``ViterbiDecoder.decode`` (2048 data bits a frame);
* sweeps the batch of both trees' lane ACS at T=2052 over ``SWEEP_B``;
* times both trees' lane ACS at every n of the class (random K=2..6 R=1/2
  codes) and at R in {3, 5, 9} (random K=5 codes), B=512, T=2052, each
  checked equal;
* times the push again in three rounds of turns, and both trees' lane ACS
  at the push's shape (B=1024, T=32, clamped symbols) in three rounds:
  the push is host-bound and its turns spread more than its kernel's;
* profiles five of this tree's Basic K=5 decodes with ``torch.profiler``;
* prints ptxas's register and spill counts of both trees' lane_acs.cu
  and chainback.cu.

It prints one JSON line (also written to FILE).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import viterbidecodercpp_torch as this  # noqa: E402
import viterbidecodercpp_torch.ops._build  # noqa: E402,F401 (this.ops._build)

SOURCES = {"rotated": ("rotated_acs", "chainback"),
           "plane": ("plane_acs", "plane_walk", "plane_walk_trunc"),
           "lane": ("lane_acs", "chainback")}
SWEEP_B = (1, 32, 132, 264, 528, 1024, 2048, 4096)
PLANE_SWEEP_B = (1, 132, 264, 265, 512)
WALK_SWEEP_B = (1, 132, 512, 2048)
WALK_SWEEP_K = (14, 16, 17)
# (K, B): 66, 30 and 15 clusters of 2, 4 and 8 blocks fill an H100
CLUSTER_SWEEP = ((17, 1), (17, 66), (17, 132), (18, 1), (18, 64), (19, 1),
                 (19, 16))
TURNS = ("earlier", "this", "this", "earlier")


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


def load_package(root: Path, name: str):
    """Import ``root/viterbidecodercpp_torch`` as package ``name``."""
    pkg = root / "viterbidecodercpp_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    for sub in ("ops.rotated", "ops.chainback", "ops.plane", "ops.lane",
                "ops.torch_core", "ops._build"):
        importlib.import_module(f"{name}.{sub}")
    return mod


def ptxas_report(build, sources) -> dict:
    """Registers and spills per kernel of ``sources`` of the tree whose
    ``ops._build`` module is ``build``, each after the line naming its
    (mangled) entry function."""
    def one(name):
        proc = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             "/dev/null", str(build.CSRC_DIR / f"{name}.cu")],
            capture_output=True, text=True, check=True)
        return name, [ln.strip() for ln in proc.stderr.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling entry" in ln]

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, sources))


def spec_of(pkg, code, mode="SOFT8"):
    return pkg.ops.torch_core.make_static_spec(
        code, pkg.get_decode_config(pkg.DecodeType(mode), code.R))


def same(a, b, what):
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise SystemExit(f"torch_kernel_ab: {what}: this tree != the "
                         f"earlier tree")


def in_turns(fns: dict, reps: int = 7, warmup: int = 2,
             rounds: int = 1) -> dict:
    out = {}
    for who in TURNS * rounds:
        out.setdefault(who, []).append(time_ms(fns[who], reps, warmup))
    return out


def primed_push(pkg, name, B, window, chunk, rng):
    """A push of one block into a stream whose ring is full."""
    code = pkg.get_code(name)
    sd = pkg.StreamingDecoder(code, "SOFT16", window=window, chunk=chunk,
                              device="cuda")
    state = sd.reset(B)
    block = torch.as_tensor(rng.randint(-127, 128, (B, chunk * code.R))
                            .astype(np.int32), device="cuda")
    for _ in range(window // chunk + 1):
        state, _, _ = sd.push(state, block)
    return lambda: sd.push(state, block)


def profile_decode(dec, syms, nbits) -> dict:
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        dec.decode(syms, nbits)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            dec.decode(syms, nbits)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    per = {}
    for e in prof.key_averages():
        # an aten:: operator's self device time is that of the kernels it
        # launched, which appear under their own names: count those only
        if e.key.startswith("aten::"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            per[e.key] = per.get(e.key, 0.0) + us / 5
    busy = sum(per.values())
    return {"window_ms_per_decode": window_us / 5e3,
            "device_busy_ms_per_decode": busy / 1e3,
            "idle_share": 1 - busy * 5 / window_us,
            "device_us_per_decode": dict(sorted(per.items(),
                                                key=lambda kv: -kv[1]))}


def plane_ab(pk: dict, rng) -> dict:
    """The big-state path of both trees: Cassini SOFT16 B=512 T=2062."""
    res = {}
    B, N = 512, 2048
    code = this.get_code("Cassini")
    T, R = N + code.K - 1, code.R
    specs = {w: spec_of(p, p.get_code("Cassini"), "SOFT16")
             for w, p in pk.items()}
    syms = torch.as_tensor(rng.randint(-127, 128, (B, T, R))
                           .astype(np.int32), device="cuda")
    m0 = this.ops.torch_core.initial_metrics(specs["this"], B, 0, "cuda")
    acs = {w: (lambda p=p, s=specs[w]: p.ops.plane.acs_plane(s, m0, syms))
           for w, p in pk.items()}
    same(acs["this"](), acs["earlier"](), "Cassini plane ACS")
    flat = syms.reshape(B, T * R)
    decs = {w: p.ViterbiDecoder(p.get_code("Cassini"), "SOFT16",
                                device="cuda") for w, p in pk.items()}
    decode = {w: (lambda d=d: d.decode(flat, N)) for w, d in decs.items()}
    same(decode["this"](), decode["earlier"](), "Cassini decode")
    rows = acs["this"]()[1]
    ends = torch.as_tensor(rng.randint(0, specs["this"].S, B)
                           .astype(np.int32), device="cuda")
    walk = {w: (lambda p=p, s=specs[w]: p.ops.plane.walk_plane_frames(
        s, rows, ends)) for w, p in pk.items()}
    same([walk["this"]()], [walk["earlier"]()], "Cassini plane walk")
    trunc = {w: (lambda p=p, s=specs[w]: p.ops.plane.chainback_plane_truncated(
        s, rows, ends, N)) for w, p in pk.items()}
    same([trunc["this"]()], [trunc["earlier"]()], "Cassini truncated walk")
    pushes = {w: primed_push(p, "Cassini", B, 280, 56, rng)
              for w, p in pk.items()}
    res["cassini_soft16_b512_t2062"] = {
        "acs_ms": in_turns(acs), "walk_ms": in_turns(walk),
        "trunc_walk_ms": in_turns(trunc), "decode_ms": in_turns(decode),
        "push_w280_c56_ms": in_turns(pushes, reps=41, warmup=5, rounds=3)}
    print(f"plane: {json.dumps(res['cassini_soft16_b512_t2062'])}",
          flush=True)
    del rows
    res["walk_batch_sweep_t2062"] = walk_sweep(pk, rng)
    sweep = []
    for b in PLANE_SWEEP_B:
        sb = syms[:b].contiguous()
        mb = m0[:, :b].contiguous()
        fb = {w: (lambda p=p, s=specs[w]: p.ops.plane.acs_plane(s, mb, sb))
              for w, p in pk.items()}
        same(fb["this"](), fb["earlier"](), f"plane ACS B={b}")
        sweep.append({"B": b, "this_ms": time_ms(fb["this"]),
                      "earlier_ms": time_ms(fb["earlier"])})
        print(f"plane sweep: {json.dumps(sweep[-1])}", flush=True)
    res["plane_acs_batch_sweep_t2062"] = sweep
    res["plane_acs_clusters_t2064"] = cluster_sweep(pk, rng)
    return res


def cluster_sweep(pk: dict, rng) -> list:
    """Both trees' plane ACS on random K=17..19 R=1/2 codes (clusters of 2,
    4 and 8 blocks a frame), SOFT16, T=2064, at each (K, B) of
    CLUSTER_SWEEP, in turns, checked equal; where the earlier tree refuses
    the code (its plane class ended at K=17) this tree's alone."""
    T = 2064
    out = []
    for K in sorted({k for k, _ in CLUSTER_SWEEP}):
        G = tuple(int(rng.randint(0, 1 << K)) | 1 | (1 << (K - 1))
                  for _ in range(2))
        sk = {w: spec_of(p, p.CodeSpec(f"K={K}", K, G), "SOFT16")
              for w, p in pk.items()}
        top = max(b for k, b in CLUSTER_SWEEP if k == K)
        syms = torch.as_tensor(rng.randint(-127, 128, (top, T, 2))
                               .astype(np.int32), device="cuda")
        m0 = this.ops.torch_core.initial_metrics(sk["this"], top, 0, "cuda")
        for b in (b for k, b in CLUSTER_SWEEP if k == K):
            sb = syms[:b].contiguous()
            mb = m0[:, :b].contiguous()
            fb = {w: (lambda p=p, s=sk[w]: p.ops.plane.acs_plane(s, mb, sb))
                  for w, p in pk.items()}
            try:
                same(fb["this"](), fb["earlier"](), f"K={K} plane ACS B={b}")
                times = in_turns(fb)
            except ValueError:      # outside the earlier tree's plane class
                times = {"this": [time_ms(fb["this"]) for _ in range(2)]}
            out.append({"K": K, "B": b,
                        **{f"{w}_ms": v for w, v in times.items()}})
            print(f"cluster sweep: {json.dumps(out[-1])}", flush=True)
            del sb, mb
    return out


def walk_sweep(pk: dict, rng) -> list:
    """Both trees' exact walk on random words filled on the card: Cassini
    at each B of WALK_SWEEP_B, and random K=14, 16, 17 codes at B=512."""
    T = 2062
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.randint(1 << 30)))
    cases = [(15, b) for b in WALK_SWEEP_B] + [(K, 512) for K in WALK_SWEEP_K]
    out = []
    for K, b in cases:
        G = tuple(int(rng.randint(0, 1 << K)) | 1 | (1 << (K - 1))
                  for _ in range(2))
        sk = {w: spec_of(p, p.get_code("Cassini") if K == 15
                         else p.CodeSpec(f"K={K}", K, G), "SOFT16")
              for w, p in pk.items()}
        words = torch.randint(-2 ** 31, 2 ** 31 - 1,
                              (b, T, sk["this"].S // 4096, 128),
                              dtype=torch.int32, device="cuda", generator=gen)
        st = torch.randint(0, sk["this"].S, (b,), dtype=torch.int32,
                           device="cuda", generator=gen)
        fw = {w: (lambda p=p, s=sk[w]: p.ops.plane.walk_plane_frames(
            s, words, st)) for w, p in pk.items()}
        same([fw["this"]()], [fw["earlier"]()], f"plane walk K={K} B={b}")
        out.append({"K": K, "B": b, "buffer_gb": words.numel() * 4 / 1e9,
                    **{f"{w}_ms": v for w, v in in_turns(fw).items()}})
        print(f"plane walk sweep: {json.dumps(out[-1])}", flush=True)
        del words
    return out


def lane_ab(pk: dict, rng) -> dict:
    """The lane path of both trees: Basic K=5 SOFT16 B=512 T=2052, the
    push, the ACS batch sweep, every n and four rates of the class and a
    profile of this tree's decode."""
    res = {}
    name = "Basic K=5 R=1/2"
    B, N = 512, 2048
    code = this.get_code(name)
    T, R = N + code.K - 1, code.R
    specs = {w: spec_of(p, p.get_code(name), "SOFT16") for w, p in pk.items()}
    syms = torch.as_tensor(rng.randint(-127, 128, (B, T, R))
                           .astype(np.int32), device="cuda")
    m0 = this.ops.torch_core.initial_metrics(specs["this"], B, 0, "cuda")
    acs = {w: (lambda p=p, s=specs[w]: p.ops.lane.acs_lane(s, m0, syms))
           for w, p in pk.items()}
    same(acs["this"](), acs["earlier"](), "Basic K=5 lane ACS")
    flat = syms.reshape(B, T * R)
    decs = {w: p.ViterbiDecoder(p.get_code(name), "SOFT16", device="cuda")
            for w, p in pk.items()}
    decode = {w: (lambda d=d: d.decode(flat, N)) for w, d in decs.items()}
    same(decode["this"](), decode["earlier"](), "Basic K=5 decode")
    res["basic_k5_soft16_b512_t2052"] = {
        "acs_ms": in_turns(acs), "decode_ms": in_turns(decode)}
    print(f"lane: {json.dumps(res['basic_k5_soft16_b512_t2052'])}",
          flush=True)

    # the push, and its lane ACS alone at the push's shape, in three rounds
    pushes = {w: primed_push(p, name, 1024, 160, 32, rng)
              for w, p in pk.items()}
    sp = torch.as_tensor(rng.randint(-127, 128, (1024, 32, R))
                         .astype(np.int32), device="cuda")
    mp = this.ops.torch_core.initial_metrics(specs["this"], 1024, 0, "cuda")
    acs_p = {w: (lambda p=p, s=specs[w]: p.ops.lane.acs_lane(s, mp, sp))
             for w, p in pk.items()}
    same(acs_p["this"](), acs_p["earlier"](), "lane ACS B=1024 T=32")
    res["basic_k5_soft16_push_b1024_w160_c32"] = {
        "push_ms": in_turns(pushes, reps=41, warmup=5, rounds=3),
        "acs_b1024_t32_ms": in_turns(acs_p, reps=41, warmup=5, rounds=3)}
    print(f"lane push: "
          f"{json.dumps(res['basic_k5_soft16_push_b1024_w160_c32'])}",
          flush=True)

    sweep = []
    for b in SWEEP_B:
        sb = torch.as_tensor(rng.randint(-127, 128, (b, T, R))
                             .astype(np.int32), device="cuda")
        mb = this.ops.torch_core.initial_metrics(specs["this"], b, 0, "cuda")
        fb = {w: (lambda p=p, s=specs[w]: p.ops.lane.acs_lane(s, mb, sb))
              for w, p in pk.items()}
        same(fb["this"](), fb["earlier"](), f"lane ACS B={b}")
        sweep.append({"B": b, "this_ms": time_ms(fb["this"]),
                      "earlier_ms": time_ms(fb["earlier"])})
        print(f"lane sweep: {json.dumps(sweep[-1])}", flush=True)
    res["lane_acs_batch_sweep_t2052"] = sweep

    by_code = []
    for K, Rk in ((2, 2), (3, 2), (4, 2), (5, 2), (6, 2), (5, 3), (5, 5),
                  (5, 9)):
        G = tuple(int(rng.randint(0, 1 << K)) | 1 | (1 << (K - 1))
                  for _ in range(Rk))
        sk = {w: spec_of(p, p.CodeSpec(f"K={K} R=1/{Rk}", K, G), "SOFT16")
              for w, p in pk.items()}
        syk = torch.as_tensor(rng.randint(-127, 128, (B, T, Rk))
                              .astype(np.int32), device="cuda")
        mk = this.ops.torch_core.initial_metrics(sk["this"], B, 0, "cuda")
        fa = {w: (lambda p=p, s=sk[w]: p.ops.lane.acs_lane(s, mk, syk))
              for w, p in pk.items()}
        same(fa["this"](), fa["earlier"](), f"lane ACS K={K} R={Rk}")
        by_code.append({"K": K, "R": Rk, "this_ms": time_ms(fa["this"]),
                        "earlier_ms": time_ms(fa["earlier"])})
        print(f"lane by_code: {json.dumps(by_code[-1])}", flush=True)
    res["lane_acs_by_code_b512_t2052"] = by_code

    res["profile_this_decode"] = profile_decode(decs["this"], flat, N)
    print(f"profile: {json.dumps(res['profile_this_decode'])}", flush=True)
    return res


def rotated_ab(pk: dict, rng) -> dict:
    """The flagship path of both trees: Voyager SOFT8 B=1024 T=2048, the
    lane walk and two pushes, the ACS batch sweep, every n of the class
    and a profile of this tree's decode."""
    res = {}
    # the main path's shape, in turns
    B, N = 1024, 2042
    code = this.get_code("Voyager")
    T, R = N + code.K - 1, code.R
    specs = {w: spec_of(p, p.get_code("Voyager")) for w, p in pk.items()}
    syms = torch.as_tensor(rng.randint(-3, 4, (B, T, R)).astype(np.int32),
                           device="cuda")
    m0 = this.ops.torch_core.initial_metrics(specs["this"], B, 0, "cuda")
    acs = {w: (lambda p=p, s=specs[w]: p.ops.rotated.acs_rotated(s, m0, syms))
           for w, p in pk.items()}
    rows = acs["this"]()
    same(rows, acs["earlier"](), "Voyager ACS")
    rots = torch.as_tensor((np.arange(T) + 1) % (code.K - 1),
                           dtype=torch.int32, device="cuda")
    ends = torch.as_tensor(rng.randint(0, 64, B).astype(np.int32),
                           device="cuda")
    walk = {w: (lambda p=p, s=specs[w]: p.ops.chainback.walk_rows(
        s, rows[1], ends, slot_order=True, rots=rots)) for w, p in pk.items()}
    same([walk["this"]()], [walk["earlier"]()], "Voyager walk")
    flat = syms.reshape(B, T * R)
    decs = {w: p.ViterbiDecoder(p.get_code("Voyager"), "SOFT8",
                                device="cuda") for w, p in pk.items()}
    decode = {w: (lambda d=d: d.decode(flat, N)) for w, d in decs.items()}
    same(decode["this"](), decode["earlier"](), "Voyager decode")
    res["voyager_soft8_b1024_t2048"] = {
        "acs_ms": in_turns(acs), "walk_ms": in_turns(walk),
        "decode_ms": in_turns(decode)}
    print(f"main: {json.dumps(res['voyager_soft8_b1024_t2048'])}",
          flush=True)

    # the lane path's walk and the two host-bound pushes
    lane_spec = {w: spec_of(p, p.get_code("Basic K=5 R=1/2"), "SOFT16")
                 for w, p in pk.items()}
    lrows, lB = 2052, 512
    words = torch.as_tensor(rng.randint(0, 1 << 16, (lrows, 1, lB))
                            .astype(np.int32), device="cuda")
    starts = torch.as_tensor(rng.randint(0, 16, lB).astype(np.int32),
                             device="cuda")
    lwalk = {w: (lambda p=p, s=lane_spec[w]: p.ops.chainback.walk_rows(
        s, words, starts)) for w, p in pk.items()}
    same([lwalk["this"]()], [lwalk["earlier"]()], "lane walk")
    res["lane_walk_b512_rows2052_ms"] = in_turns(lwalk)
    for label, name, b, window, chunk in (
            ("voyager_push_ms", "Voyager", 1024, 256, 64),
            ("basic_k5_push_ms", "Basic K=5 R=1/2", 1024, 160, 32)):
        pushes = {w: primed_push(p, name, b, window, chunk, rng)
                  for w, p in pk.items()}
        res[label] = in_turns(pushes, reps=41, warmup=5)
    keys = ("lane_walk_b512_rows2052_ms", "voyager_push_ms",
            "basic_k5_push_ms")
    print(f"lane walk and pushes: {json.dumps({k: res[k] for k in keys})}",
          flush=True)

    # batch sweep of both trees' ACS
    sweep = []
    for b in SWEEP_B:
        sb = torch.as_tensor(rng.randint(-3, 4, (b, T, R)).astype(np.int32),
                             device="cuda")
        mb = this.ops.torch_core.initial_metrics(specs["this"], b, 0, "cuda")
        fb = {w: (lambda p=p, s=specs[w]: p.ops.rotated.acs_rotated(s, mb,
                                                                    sb))
              for w, p in pk.items()}
        same(fb["this"](), fb["earlier"](), f"ACS B={b}")
        sweep.append({"B": b, "this_ms": time_ms(fb["this"]),
                      "earlier_ms": time_ms(fb["earlier"])})
        print(f"sweep: {json.dumps(sweep[-1])}", flush=True)
    res["acs_batch_sweep_t2048"] = sweep

    # every n of the class
    by_n = []
    for K in range(7, 14):
        G = tuple(int(rng.randint(0, 1 << K)) | 1 | (1 << (K - 1))
                  for _ in range(2))
        sk = {w: spec_of(p, p.CodeSpec(f"K={K}", K, G)) for w, p in pk.items()}
        S = sk["this"].S
        syk = torch.as_tensor(rng.randint(-3, 4, (B, T, 2)).astype(np.int32),
                              device="cuda")
        mk = this.ops.torch_core.initial_metrics(sk["this"], B, 0, "cuda")
        fa = {w: (lambda p=p, s=sk[w]: p.ops.rotated.acs_rotated(s, mk, syk))
              for w, p in pk.items()}
        rk = fa["this"]()
        same(rk, fa["earlier"](), f"ACS K={K}")
        rot_k = torch.as_tensor((np.arange(T) + 1) % (K - 1),
                                dtype=torch.int32, device="cuda")
        ek = torch.as_tensor(rng.randint(0, S, B).astype(np.int32),
                             device="cuda")
        fw = {w: (lambda p=p, s=sk[w]: p.ops.chainback.walk_rows(
            s, rk[1], ek, slot_order=True, rots=rot_k))
            for w, p in pk.items()}
        same([fw["this"]()], [fw["earlier"]()], f"walk K={K}")
        by_n.append({
            "K": K, "S": S, "W": sk["this"].W,
            "acs_design": this.ops.rotated.kernel_design(S, 2),
            "walk_design": this.ops.chainback.walk_design(sk["this"].W),
            "acs_this_ms": time_ms(fa["this"]),
            "acs_earlier_ms": time_ms(fa["earlier"]),
            "walk_this_ms": time_ms(fw["this"]),
            "walk_earlier_ms": time_ms(fw["earlier"])})
        print(f"by_n: {json.dumps(by_n[-1])}", flush=True)
        del rk, mk, syk
    res["by_n_b1024_t2048"] = by_n

    res["profile_this_decode"] = profile_decode(decs["this"], flat, N)
    print(f"profile: {json.dumps(res['profile_this_decode'])}", flush=True)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--path", choices=tuple(SOURCES), default="rotated")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs a CUDA card")
    rng = np.random.RandomState(args.seed)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    old = load_package(args.parent.resolve(), "viterbidecodercpp_torch_ab")
    pk = {"earlier": old, "this": this}
    sources = SOURCES[args.path]
    with ThreadPoolExecutor(2 * len(sources) + 2) as pool:
        ptxas = {w: pool.submit(ptxas_report, p.ops._build, sources)
                 for w, p in pk.items()}
        builds = [pool.submit(p.ops._build.load, n)
                  for p in (old, this) for n in sources]
        for f in builds:
            f.result()
        res = {"card": card, "path": args.path,
               "ptxas": {w: f.result() for w, f in ptxas.items()}}
    paths = {"rotated": rotated_ab, "plane": plane_ab, "lane": lane_ab}
    res.update(paths[args.path](pk, rng))

    line = json.dumps(res)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
