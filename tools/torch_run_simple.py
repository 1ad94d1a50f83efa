#!/usr/bin/env python3
"""Minimal end-to-end demo on the PyTorch port (the twin of
tools/run_simple.py, parity with examples/run_simple.cpp).

DAB Radio K=7 R=1/4 SOFT16, 1024 input bytes, noiseless channel, encoded
with the port's ``ops/encoder.py``; prints the route, the bit errors, the
final path metric and the accumulated renorm error, and exits 1 unless
the decode is exact (run_simple.cpp:90-93).

    python3 tools/torch_run_simple.py          # on the card
    python3 tools/torch_run_simple.py --cpu    # on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np
import torch

import viterbidecodercpp_torch as pt
from viterbidecodercpp_torch.ops import encoder

NBYTES = 1024


def run(device) -> dict:
    """Encode, decode and count the bit errors on ``device``."""
    code = pt.get_code("DAB Radio")
    dec = pt.ViterbiDecoder(code, pt.DecodeType.SOFT16, device=device)
    config = dec.config
    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, (1, NBYTES), dtype=np.uint8)
    bits = encoder.bytes_to_bits(torch.as_tensor(data, device=device))
    syms = encoder.encode_symbols(code, bits, config.soft_decision_high,
                                  config.soft_decision_low).reshape(1, -1)
    out_bits, err, acc = dec.decode(syms, NBYTES * 8)
    return {"code": code, "backend": dec.backend,
            "bit_errors": int((out_bits != bits).sum()),
            "final_error": int(err[0]), "accumulated_error": int(acc[0])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_run_simple: no CUDA card (torch.cuda.is_available() "
                 "is false); pass --cpu to run on the CPU")
    r = run("cpu" if args.cpu else "cuda")
    code = r["code"]
    print(f"code={code.name} K={code.K} R={code.R} backend={r['backend']}")
    print(f"decoded {NBYTES} bytes, bit errors: {r['bit_errors']}")
    print(f"final path metric: {r['final_error']}, "
          f"accumulated renorm error: {r['accumulated_error']}")
    if r["bit_errors"] != 0:
        print("FAILED: noiseless decode must be exact")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
