#!/usr/bin/env python3
"""AWGN BER sweep on the PyTorch port (the twin of tools/run_snr_ber.py,
parity with examples/run_snr_ber.cpp).

Identical Eb/No math (run_snr_ber.cpp:319-325) and stopping rules
(318-396); each batch is generated, sent through the channel, decoded and
counted on the card (viterbidecodercpp_torch/ber.py).  Emits the
reference's JSON schema (run_snr_ber.cpp:402-441) and its stderr progress
lines.

    python3 tools/torch_run_snr_ber.py -c 0 -d soft16          # on the card
    python3 tools/torch_run_snr_ber.py -c 0 -d soft16 --cpu    # on the CPU

Flags mirror the reference: -L traceback bytes, -n max error bits,
-D max points, -S seed, -k bit-budget scale, -T per-point wall-clock
timeout (run_snr_ber.cpp:361-379), -c/-d/-s filters, -l registry list
(cli_filters.h:143-186), -B frames per batch, --host-chain for the native
mt19937 channel.  ``-s cuda`` decodes with the CUDA kernels (the
default on the card), ``-s torch`` with the plain scan (the default with
``--cpu``); ``simd_type`` records which ran.

``--dp N`` runs every point data-parallel over N ranks spawned here (``-B``
frames a rank a batch, budgets summed over the ranks; ``ber.py``'s
``group=``), one rank per card with ``--dist-backend nccl`` (the default
on cards), or over gloo: ranks that share cards, or CPU ranks with
``--cpu``:

    python3 tools/torch_run_snr_ber.py -c 2 -d soft8 --dp 4 --dist-backend gloo
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import viterbidecodercpp_torch as pt
from viterbidecodercpp_torch import ber


def print_code_list(file=None):
    """Print the common-code registry like cli_print_codes
    (cli_filters.h:68-86): ID | name | K R | coefficients."""
    file = file or sys.stderr
    width = max(len(c.name) for c in pt.COMMON_CODES)
    print(f"ID | {'Name':>{width}} |  K  R | Coefficients", file=file)
    for i, code in enumerate(pt.COMMON_CODES):
        coeffs = ",".join(str(g) for g in code.G)
        print(f"{i:2d} | {code.name:>{width}} | {code.K:2d} {code.R:2d} | "
              f"[{coeffs}]", file=file)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-L", type=int, default=256, help="traceback bytes/frame")
    ap.add_argument("-n", type=int, default=10000, help="max error bits/point")
    ap.add_argument("-D", type=int, default=24, help="max data points")
    ap.add_argument("-S", type=int, default=0, help="random seed")
    ap.add_argument("-k", type=float, default=1.0, help="bit budget scale")
    ap.add_argument("-T", type=float, default=None,
                    help="per-point wall-clock timeout in seconds")
    ap.add_argument("-B", type=int, default=256, help="frames per batch")
    ap.add_argument("-c", type=int, default=None, help="code index filter")
    ap.add_argument("-d", default=None, choices=["soft16", "soft8", "hard8"])
    ap.add_argument("-s", default=None, choices=["cuda", "torch"],
                    help="decoder: the CUDA kernels (default on the card) "
                         "or the plain torch scan (default with --cpu)")
    ap.add_argument("-l", action="store_true",
                    help="list the common-code registry and exit")
    ap.add_argument("-o", default=None, help="output file (default stdout)")
    ap.add_argument("--host-chain", action="store_true",
                    help="generate the channel on the native C++ runtime "
                         "(mt19937, reference-identical maths) instead of "
                         "on the device")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--dp", type=int, default=None, metavar="N",
                    help="run each point data-parallel over N ranks (-B "
                         "frames a rank, budgets summed over the ranks)")
    ap.add_argument("--dist-backend", default=None,
                    choices=["nccl", "gloo"],
                    help="--dp's backend: nccl (one rank per card; the "
                         "default on cards) or gloo (ranks that share a "
                         "card; CPU ranks, the default with --cpu)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.l:
        print_code_list()
        return 0
    if args.T is not None and args.T <= 0:
        print(f"Timeout must be > 0, got {args.T}", file=sys.stderr)
        return 1
    if args.s is None:
        args.s = "torch" if args.cpu else "cuda"
    if args.s == "cuda" and args.cpu:
        print("-s cuda runs the CUDA kernels on the card: drop --cpu or "
              "use -s torch", file=sys.stderr)
        return 1

    if args.dist_backend is None:
        args.dist_backend = "gloo" if args.cpu else "nccl"
    if args.dp is not None and args.rank is None:
        return spawn_dp(args, sys.argv[1:] if argv is None else list(argv))

    device = "cpu" if args.cpu else "cuda"
    backend = "auto" if args.s == "cuda" else "torch"
    group = None
    if args.dp is not None:
        import torch.distributed as dist
        from viterbidecodercpp_torch.parallel import launch
        device = launch.initialize(args.init_method, args.dp, args.rank,
                                   backend=args.dist_backend, device=device)
        group = dist.group.WORLD
    quiet = bool(args.rank)            # ranks past 0 print nothing
    rows = []
    for ci, code in enumerate(pt.COMMON_CODES):
        if args.c is not None and ci != args.c:
            continue
        for dt in pt.DECODE_TYPES:
            if args.d and dt.value.lower() != args.d:
                continue
            config = pt.get_decode_config(dt, code.R)
            res = ber.sweep(code, config, seed=args.S,
                            max_points=args.D,
                            block_bits=args.L * 8, batch=args.B,
                            max_errors=args.n, bits_scale=args.k,
                            backend=backend, host_chain=args.host_chain,
                            timeout_seconds=args.T, device=device,
                            group=group)
            for i, p in enumerate(res.points):
                if quiet:
                    continue
                print(f"name='{code.name}',K={code.K},R={code.R},"
                      f"decode={dt.value},iter={i},EbNo_dB={p.EbNo_dB:.1f},"
                      f"BER={p.ber:.3e}", file=sys.stderr)
            rows.append({
                "name": code.name,
                "decode_type": dt.value,
                "simd_type": (args.s.upper()
                              + ("+HOSTCHAIN" if args.host_chain else "")),
                "K": code.K,
                "R": code.R,
                "G": list(code.G),
                "EbNo_dB": [p.EbNo_dB for p in res.points],
                "ber": [p.ber for p in res.points],
                "total_bits": [p.total_bits for p in res.points],
                "total_bit_errors": [p.total_bit_errors for p in res.points],
            })
    if group is not None:
        dist.destroy_process_group()
    if quiet:
        return 0
    out = json.dumps(rows, indent=1)
    if args.o:
        with open(args.o, "w") as f:
            f.write(out)
    else:
        print(out)
    return 0


def spawn_dp(args, argv) -> int:
    """Run this tool as ``args.dp`` ranks here; rank 0 writes the JSON
    (to ``-o``, else to a file that is printed) and its progress lines."""
    import torch
    from viterbidecodercpp_torch.parallel import launch

    if args.host_chain:
        print("--dp and --host-chain are mutually exclusive: the host chain "
              "generates the channel on one process's CPU", file=sys.stderr)
        return 1
    if args.dist_backend == "nccl":
        cards = 0 if args.cpu else torch.cuda.device_count()
        if args.dp > cards:
            print(f"--dist-backend nccl runs one rank per card: {args.dp} "
                  f"ranks, {cards} card(s); use --dist-backend gloo for CPU "
                  f"ranks or ranks that share a card", file=sys.stderr)
            return 1
    with tempfile.TemporaryDirectory() as tmp:
        out = args.o or os.path.join(tmp, "ber.json")
        rest = list(argv)
        if args.o is None:
            rest += ["-o", out]
        me = os.path.abspath(__file__)
        try:
            outs = launch.spawn_fleet(
                lambda r, init: [sys.executable, me, *rest, "--rank", str(r),
                                 "--init-method", init],
                args.dp, timeout=24 * 3600)
        except RuntimeError as exc:
            print(f"data-parallel sweep failed: {exc}", file=sys.stderr)
            return 1
        print(outs[0], end="", file=sys.stderr)
        if args.o is None:
            with open(out) as f:
                print(f.read())
    return 0


if __name__ == "__main__":
    sys.exit(main())
