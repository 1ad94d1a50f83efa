"""One long stream decoded over several cards: the time axis of B streams
tiled over a ``time`` mesh of ``ranks`` processes, one a card (NCCL;
gloo on the CPU), each rank calling ``block_sp.decode_stream_sp`` back to
back; every rank takes part in every call.

The benchmark's process spawns the ranks (this file run as a script) with
``parallel.launch.spawn_fleet`` and reads each rank's result line.  Each
rank makes the whole stream from the seed and takes its tile with
``launch.local_block``.  The harness adds no synchronisation inside the
window: at set-up rank 0 times ``probe`` calls and broadcasts the time a
call, from which every rank takes the same count of calls for the window
(about ``--seconds`` of them); rank 0 counts them and closes its window
with a device synchronise.

Params: ``frames`` (B), ``stream_bits`` (data bits a stream, tail
terminated), ``ranks``, ``overlap``, ``warmup`` (calls before the
window), ``probe`` (calls timed at set-up to size the window),
``timed_calls`` (calls with ``timings`` in a traced run, after
the profiled window), ``check_frames`` (streams compared, drawn from the
seed), ``timeout`` (seconds for the whole fleet).

Compared with the plain reference, exactly: the decoded data bits of
every sampled stream over all tiles of the window's last call.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

TOKEN = "SP_RANK_RESULT "


def run(run) -> dict:
    from viterbidecodercpp_torch.parallel import launch

    p = run.cell.params
    world = int(p["ranks"])
    here = str(Path(__file__).resolve())

    def cmd(rank, init_method):
        return [sys.executable, here, "--bench-dir", str(run.cell.bench_dir),
                "--workload", run.cell.name, "--seed", str(run.seed),
                "--seconds", repr(run.seconds), "--trace", str(int(run.trace)),
                "--device", run.device, "--t-start", repr(run.t_start),
                "--init-method", init_method, "--world", str(world),
                "--rank", str(rank)]

    outs = launch.spawn_fleet(cmd, world, timeout=float(p["timeout"]))
    ranks = []
    for r, out in enumerate(outs):
        lines = out.splitlines()
        hits = [ln for ln in lines if ln.startswith(TOKEN)]
        if not hits:
            raise RuntimeError(f"rank {r} printed no result:\n{out}")
        ranks.append(json.loads(hits[-1][len(TOKEN):]))
        rest = [ln for ln in lines if not ln.startswith(TOKEN)]
        if rest:
            print(f"--- rank {r} ---\n" + "\n".join(rest), file=sys.stderr)
    r0 = ranks[0]
    print(f"sp_decode: halo mismatches (the program's convergence count, "
          f"every stream and boundary, last call) {r0['halo_mismatches']}",
          file=sys.stderr)
    rec = {k: r0[k] for k in ("attempted", "setup_s", "window_s", "symbols",
                              "checks", "shape")}
    rec["failed"] = 0
    rec["device"] = {"kind": r0["kind"], "count": world,
                     "memory_peak_bytes": max(r["memory_peak_bytes"]
                                              for r in ranks)}
    rec["modules"] = sorted({m for r in ranks for m in r["modules"]})
    if run.trace:
        traces = [r["trace"] for r in ranks]
        rec["trace"] = dict(traces[0])
        rec["trace"]["busy_s"] = sum(t["busy_s"] for t in traces) / world
        rec["trace"]["idle_share"] = max(t["idle_share"] for t in traces)
        rec["sp_timings"] = [r["timings"] for r in ranks]
    return rec


def control(run, metric_bits: int) -> list:
    """The comparison's numbers with the reference at ``metric_bits``-bit
    metrics in the program's place, over the run's whole stream and
    sampled streams (made on this process's device; no ranks)."""
    import torch

    from bench_port import harness
    from bench_port.reference import viterbi as ref

    cfg, p = run.cell.config, run.cell.params
    _, _, tr, arr, T = _stream(run, torch.device(run.device),
                               int(p["ranks"]))
    frames = harness.sample_frames(run.rng(1), arr.shape[0],
                                   int(p["check_frames"]))
    syms = arr.index_select(0, torch.as_tensor(frames, device=arr.device))[
        :, :T].cpu().numpy().astype(np.int64)
    del arr
    low = ref.trellis(cfg["K"], cfg["G"], cfg["decode_type"], cfg["arith"],
                      metric_bits)
    nbits = T - (tr.K - 1)
    got, _, _ = ref.decode(low, syms, nbits)
    want, _, _ = ref.decode(tr, syms, nbits)
    return [["bit_mismatches", int((got != want).sum())]]


def _stream(run, dev, world):
    """(code, config, padded (B, T', R) stream, T) made from the seed."""
    import torch

    import viterbidecodercpp_torch as vp
    from bench_port import channel
    from bench_port.reference import viterbi as ref

    cfg, p = run.cell.config, run.cell.params
    K, G = int(cfg["K"]), tuple(cfg["G"])
    R, B, nbits = len(G), int(p["frames"]), int(p["stream_bits"])
    code = vp.CodeSpec(cfg["code"], K, G)
    dconf = vp.get_decode_config(vp.DecodeType(cfg["decode_type"]), R,
                                 arith=cfg["arith"])
    tr = ref.trellis(K, G, cfg["decode_type"], cfg["arith"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(run.seed)
    dtype = getattr(torch, cfg["symbol_dtype"])
    T = nbits + K - 1
    Tp = -(-T // world) * world
    arr = torch.zeros((B, Tp, R), dtype=dtype, device=dev)
    step = 128                         # frames a block of the generator
    for f0 in range(0, B, step):
        n = min(step, B - f0)
        data = torch.randint(0, 2, (n, nbits), generator=gen,
                             dtype=torch.uint8, device=dev)
        arr[f0:f0 + n, :T] = channel.channel(
            channel.encode(K, G, data), gen, float(cfg["ebno_db"]), tr.high,
            tr.low, dtype).reshape(n, T, R)
    return code, dconf, tr, arr, T


def _rank(args) -> None:
    sys.path.insert(0, str(Path(args.bench_dir).resolve().parent))
    import torch
    import torch.distributed as dist

    from bench_port import harness, profiling
    from bench_port.reference import viterbi as ref
    from viterbidecodercpp_torch.ops import torch_core
    from viterbidecodercpp_torch.parallel import block_sp, launch
    from viterbidecodercpp_torch.parallel.mesh import make_mesh

    cell = harness.find_cell(args.workload, Path(args.bench_dir))
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                      args.device, args.t_start)
    p = cell.params
    world, rank = args.world, args.rank
    dev = launch.initialize(args.init_method, world, rank,
                            device=args.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    run.mark(f"rank {rank} joined the process group")
    try:
        mesh = make_mesh((world,), ("time",), dev.type)
        code, dconf, tr, arr, T = _stream(run, dev, world)
        sync()
        run.mark(f"rank {rank} made the stream")
        B, R = arr.shape[0], arr.shape[2]
        frames = harness.sample_frames(run.rng(1), B,
                                       int(p["check_frames"]))
        idx = torch.as_tensor(frames, device=dev)
        ref_syms = (arr.index_select(0, idx)[:, :T].cpu().numpy()
                    if rank == 0 else None)
        tile = launch.local_block(arr, mesh, (None, "time", None)) \
            .contiguous()
        del arr
        spec = torch_core.make_static_spec(code, dconf)
        overlap = int(p["overlap"])

        def call(timings=None):
            return block_sp.decode_stream_sp(
                spec, mesh, tile, overlap=overlap, total_rows=T, device=dev,
                timings=timings)

        def loop(n):
            """``n`` calls back to back; returns the last one's result."""
            res = None
            for _ in range(n):
                res = call()
            return res

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        for _ in range(int(p["warmup"])):
            call()
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        loop(int(p["probe"]))
        sync()
        per_call = torch.tensor([(time.perf_counter() - t0)
                                 / int(p["probe"])], dtype=torch.float64,
                                device=dev)
        dist.broadcast(per_call, src=0)
        per_call = float(per_call.item())

        def calls_in(seconds: float) -> int:
            return max(1, round(seconds / per_call))

        dist.barrier()
        run.mark(f"rank {rank} warmed up ({p['warmup']} + {p['probe']} "
                 f"calls, {per_call * 1e3:.3f} ms a call)")
        setup_s = time.time() - run.t_start
        calls = calls_in(run.seconds)
        t0 = time.perf_counter()
        res = loop(calls)
        sync()
        window_s = time.perf_counter() - t0
        out = {"attempted": calls, "setup_s": setup_s, "window_s": window_s,
               "symbols": calls * B * T * R,
               "shape": {"S": spec.S, "B": B, "T": T, "R": R,
                         "tile": tile.shape[1], "ranks": world}}
        if run.trace:
            def window(seconds):
                n = calls_in(seconds)
                loop(n)
                return {"calls": n}

            out["trace"] = profiling.trace_window(call, window)
            timed = []
            for _ in range(int(p["timed_calls"])):
                t = {}
                call(t)
                timed.append(t)
            out["timings"] = timed
        out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                    if cuda else 0)
        out["kind"] = torch.cuda.get_device_name() if cuda else "cpu"

        # -- the comparison, once the window has closed ------------------
        # the program's own count of halo rows its two decodes disagree
        # on, over every stream and boundary (reported, not judged)
        out["halo_mismatches"] = int(res.halo_mismatches)
        mine = res.bits.index_select(0, idx).contiguous()
        parts = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(parts, mine)
        del tile, res
        if rank == 0:
            got = torch.cat(parts, dim=1).cpu().numpy()[:, :T]
            nbits = T - (code.K - 1)
            want, _, _ = ref.decode(tr, ref_syms.astype(np.int64), nbits)
            nbit = int((got[:, code.K - 1:] != want).sum())
            print(f"sp_decode: {calls} calls in {window_s:.4f} s; compared "
                  f"{len(frames)} streams x {nbits} bits with the "
                  f"reference", file=sys.stderr)
            out["checks"] = [["bit_mismatches", nbit]]
        out["modules"] = harness.forbidden_modules()
        print(TOKEN + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def _main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="one rank of the sp_decode "
                                 "traffic (started by the benchmark)")
    ap.add_argument("--bench-dir", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--t-start", type=float, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    _rank(ap.parse_args(argv))


if __name__ == "__main__":
    _main()
