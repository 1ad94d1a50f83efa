#!/usr/bin/env python3
"""Full correctness matrix on the PyTorch port (the twin of
tools/run_tests.py, parity with examples/run_tests.cpp).

{SOFT16, SOFT8, HARD8} x the 8 registry codes x {saturating, wrapping} x
the routes: the kernel route the decoder picks for the code
(``decoder.select_backend``: rotated, plane or lane) and the plain scan
(``backend="torch"``).  Each case encodes random bytes noiselessly with
the port's ``ops/numpy_ref.py`` (2 frames, 64 bytes, 16 for K >= 15) and
requires 0 bit errors (run_tests.cpp:129-142).  The reference's one
known-bad combination, wrapping SOFT8 Cassini, is skipped with its
reason (run_tests.cpp:63-65): the port reproduces the same modular
overflow.

    python3 tools/torch_run_tests.py          # both routes on the card
    python3 tools/torch_run_tests.py --cpu    # the plain scan on the CPU

Exit code 0 iff every case that is not skipped passes.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np
import torch

import viterbidecodercpp_torch as pt
from viterbidecodercpp_torch.decoder import select_backend
from viterbidecodercpp_torch.ops import numpy_ref, torch_core

GREEN, RED, YELLOW, RESET = "\033[32m", "\033[31m", "\033[33m", "\033[0m"
ARITHS = ("saturating", "wrapping")

# (arith, decode type, code name) -> reason  (run_tests.cpp:63-65)
SKIP = {
    ("wrapping", pt.DecodeType.SOFT8, "Cassini"):
        "Overflow in metrics due to high code rate and non saturating "
        "arithmetic",
}


def run_matrix(device, log=None) -> dict:
    """Run every case on ``device``: the kernel route and ``"torch"`` on a
    card, ``"torch"`` alone on the CPU.  ``log`` takes one line a case.
    Returns the counts, the failures and the routes taken."""
    device = torch.device(device)
    log = log or (lambda line: None)
    total = passed = skipped = 0
    failures, routes = [], set()
    rng = np.random.RandomState(0)
    for decode_type in pt.DECODE_TYPES:
        for code in pt.COMMON_CODES:
            nbytes = 16 if code.K >= 15 else 64
            data = rng.randint(0, 256, (2, nbytes), dtype=np.uint8)
            for arith in ARITHS:
                config = pt.get_decode_config(decode_type, code.R,
                                              arith=arith)
                backends = ["torch"]
                if device.type == "cuda":
                    spec = torch_core.make_static_spec(code, config)
                    backends.insert(0, select_backend(spec, device))
                reason = SKIP.get((arith, decode_type, code.name))
                if reason:
                    # one combination, whichever routes it would take
                    total += 1
                    skipped += 1
                    log(f"{YELLOW}SKIP{RESET} {decode_type.value:7s} "
                        f"{code.name:16s} {arith:10s} "
                        f"{'+'.join(backends):13s} - {reason}")
                    continue
                syms = np.stack([
                    numpy_ref.encode_bytes(code, d,
                                           config.soft_decision_high,
                                           config.soft_decision_low)
                    for d in data]).reshape(2, -1)
                for backend in backends:
                    total += 1
                    routes.add(backend)
                    dec = pt.ViterbiDecoder(code, config, backend=backend,
                                            device=device)
                    bits, _, _ = dec.decode(torch.as_tensor(syms), nbytes * 8)
                    out = np.packbits(bits.cpu().numpy(), axis=-1,
                                      bitorder="big")
                    ok = np.array_equal(out, data)
                    passed += int(ok)
                    mark = (f"{GREEN}PASS{RESET}" if ok
                            else f"{RED}FAIL{RESET}")
                    log(f"{mark} {decode_type.value:7s} {code.name:16s} "
                        f"{arith:10s} {backend:7s}")
                    if not ok:
                        failures.append((decode_type.value, code.name, arith,
                                         backend))
    return {"total": total, "passed": passed, "skipped": skipped,
            "failures": failures, "routes": sorted(routes)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain scan on the CPU instead of both "
                         "routes on the card")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_run_tests: no CUDA card (torch.cuda.is_available() "
                 "is false); pass --cpu to run on the CPU")
    r = run_matrix("cpu" if args.cpu else "cuda", log=print)
    print(f"\n{r['passed']}/{r['total'] - r['skipped']} passed, "
          f"{r['skipped']} skipped (routes: {', '.join(r['routes'])})")
    if r["failures"]:
        print(f"{RED}FAILURES:{RESET}", r["failures"])
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
