#!/usr/bin/env python3
"""Frame-DP scaling on the PyTorch port (the twin of tools/run_scaling.py,
the >= 80 %-linear-scaling protocol of BASELINE.md).

Measures the aggregate frame-DP decode rate over every rank of a run
(``parallel/frame_dp.decode_dp``: frames split over one ``data`` axis, one
error sum a call, so the only cross-rank traffic is a scalar), and the
rate of rank 0 alone on its share of the frames:

    efficiency = rate(all ranks) / (ranks x rate(rank 0 alone))

is printed only when every rank drives a card of its own.  Ranks that
share a card (``--dist-backend gloo``) take turns on it: their rate is
printed, labelled as such, with no efficiency.  CPU ranks (``--simulate
N``) check the measurement path; their numbers describe the host.

    # N ranks on this host's cards (NCCL: one rank per card)
    python3 tools/torch_run_scaling.py --spawn N [--dist-backend gloo]
    # one rank of a fleet across hosts, started on every host
    python3 tools/torch_run_scaling.py --init-method tcp://host0:1234 \\
        --world-size W --rank R          # LOCAL_RANK picks the card
    # N gloo ranks on the CPU
    python3 tools/torch_run_scaling.py --simulate N

Output: one JSON line from rank 0: {"metric": "dp_symbols_per_s",
"ranks": W, "cards": C, "value": rate, "single_rank": rate0, ...}.
Times: host clock around each call, which ends in the error sum's host
read; the median of 2 x --reps calls of each fleet size, taken in turns
(rank 0 alone, all ranks, all ranks, rank 0 alone), each turn after two
warm-up calls.
"""

import argparse
import json
import os
import socket
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import viterbidecodercpp_torch as pt  # noqa: E402
from viterbidecodercpp_torch.ops import encoder  # noqa: E402
from viterbidecodercpp_torch.parallel import frame_dp, launch  # noqa: E402


def worker(args) -> None:
    dev = launch.initialize(args.init_method, args.world_size, args.rank,
                            backend=args.dist_backend,
                            device="cpu" if args.cpu else "cuda")
    world = args.world_size
    code = pt.get_code(args.code)
    config = pt.get_decode_config(pt.DecodeType(args.decode), code.R)
    mesh = launch.make_hybrid_mesh(dcn={"data": world},
                                   device_type=dev.type)
    group = mesh.get_group("data")
    B = args.batch * world
    rng = np.random.RandomState(0)
    data = torch.as_tensor(rng.randint(0, 2, (B, args.bits)).astype(np.uint8))
    mine = launch.local_block(data, mesh, ("data", None)).to(dev)
    syms = encoder.encode_symbols(code, mine, config.soft_decision_high,
                                  config.soft_decision_low)
    T = syms.shape[1]

    def call(g):
        _, errs = frame_dp.decode_dp(code, config, syms, args.bits,
                                     reference_bits=mine, group=g,
                                     device=dev)
        return int(errs)

    def timed(g, n: int) -> list:
        """Seconds of n calls over group g, after two warm-up calls."""
        times = []
        for i in range(n + 2):
            t0 = time.perf_counter()
            errs = call(g)
            if i >= 2:
                times.append(time.perf_counter() - t0)
            if errs:
                raise SystemExit("the scaling decode had bit errors")
        return times

    # rank 0 alone on its share (its sum over a group of one) while the
    # others wait, and all ranks together, in turns (alone, all, all,
    # alone): the calls are short and host-bound, so one pass of each
    # would compare two moments of the host as much as two fleet sizes
    alone = dist.new_group([0])
    singles, alls = [], []
    for turn in ("alone", "all", "all", "alone"):
        if turn == "all":
            alls += timed(group, args.reps)
        elif args.rank == 0:
            singles += timed(alone, args.reps)
        dist.barrier()
    single = statistics.median(singles) if args.rank == 0 else None
    dt = statistics.median(alls)
    where = [None] * world
    dist.all_gather_object(where, (socket.gethostname(), str(dev)))
    if args.rank == 0:
        cards = len(set(where)) if dev.type == "cuda" else 0
        symbols = B * T * code.R
        row = {
            "metric": "dp_symbols_per_s", "ranks": world, "cards": cards,
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "backend": dist.get_backend(),
            "code": code.name, "decode": args.decode,
            "frames_per_rank": args.batch, "trellis_steps": T,
            "value": symbols / dt, "per_rank": symbols / dt / world,
            "median_call_s": dt, "calls": len(alls),
            "single_rank": args.batch * T * code.R / single,
            "single_rank_call_s": single,
        }
        if dev.type != "cuda":
            row["note"] = ("CPU ranks: checks the measurement path; the "
                           "rates describe the host, not a card")
        elif cards < world:
            row["note"] = (f"{world} ranks share {cards} card(s) and take "
                           f"turns on them: an aggregate rate, not a "
                           f"scaling measurement")
        else:
            row["efficiency"] = row["value"] / (world * row["single_rank"])
        print(json.dumps(row), flush=True)
    dist.destroy_process_group()


def spawn(args, n: int, cpu: bool) -> None:
    if args.dist_backend == "nccl":
        cards = 0 if cpu else torch.cuda.device_count()
        if n > cards:
            sys.exit(f"--dist-backend nccl runs one rank per card: {n} "
                     f"ranks, {cards} card(s); use --dist-backend gloo for "
                     f"CPU ranks or ranks that share a card")
    me = os.path.abspath(__file__)
    flags = ["--batch", str(args.batch), "--bits", str(args.bits),
             "--reps", str(args.reps), "--code", args.code,
             "--decode", args.decode, "--dist-backend", args.dist_backend,
             "--world-size", str(n)] + (["--cpu"] if cpu else [])
    try:
        outs = launch.spawn_fleet(
            lambda r, init: [sys.executable, me, *flags, "--rank", str(r),
                             "--init-method", init],
            n, timeout=args.timeout, success_token='"metric"')
    except RuntimeError as exc:
        sys.exit(f"scaling run failed: {exc}")
    for line in outs[0].splitlines():          # rank 0's JSON line
        if line.startswith("{"):
            print(line, flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__.split("\n\n", 1)[1])
    ap.add_argument("--simulate", type=int, default=0, metavar="N",
                    help="spawn N gloo ranks on the CPU")
    ap.add_argument("--spawn", type=int, default=0, metavar="N",
                    help="spawn N ranks on this host's cards")
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--dist-backend", default=None,
                    choices=["nccl", "gloo"],
                    help="nccl (one rank per card; the default on cards) "
                         "or gloo (ranks that share a card; CPU ranks)")
    # rank plumbing: --simulate's ranks run on the CPU
    ap.add_argument("--cpu", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--batch", type=int, default=1024,
                    help="frames per rank")
    ap.add_argument("--bits", type=int, default=2048,
                    help="data bits per frame")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--code", default="Voyager")
    ap.add_argument("--decode", default="SOFT8")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds for a spawned fleet")
    args = ap.parse_args(argv)
    cpu = args.cpu or bool(args.simulate)
    if args.dist_backend is None:
        args.dist_backend = "gloo" if cpu else "nccl"
    if args.simulate:
        spawn(args, args.simulate, cpu=True)
    elif args.spawn:
        spawn(args, args.spawn, cpu=False)
    else:
        if None in (args.init_method, args.world_size, args.rank):
            ap.error("give --simulate N, --spawn N, or --init-method, "
                     "--world-size and --rank")
        worker(args)


if __name__ == "__main__":
    main()
