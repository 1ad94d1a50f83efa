#!/usr/bin/env python3
"""Bounded-latency streaming decode demo on the PyTorch port (the twin of
tools/run_streaming.py).

Feeds a noisy continuous stream through ``StreamingDecoder.push`` in
fixed chunks and checks the emitted bits against the data sent (fixed
decision delay of ``window`` trellis steps).  ``--code voyager`` streams
K=7 through the rotated route (window 256, chunk 64, 8 frames x 512
bytes, uniform noise +-25); ``--code cassini`` streams K=15 through the
plane route (window 280, chunk 56, 32 frames x 128 bytes, noise +-60).
Symbols are encoded with the port's ``ops/numpy_ref.py``.  Exit 1 on any
bit error.

    python3 tools/torch_run_streaming.py --code voyager          # on the card
    python3 tools/torch_run_streaming.py --code voyager --cpu    # on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np
import torch

import viterbidecodercpp_torch as pt
from viterbidecodercpp_torch.ops import numpy_ref

# code -> (registry name, window, chunk, frames, bytes a frame, noise)
STREAMS = {"voyager": ("Voyager", 256, 64, 8, 512, 25),
           "cassini": ("Cassini", 280, 56, 32, 128, 60)}


def run(name: str, device) -> dict:
    """Stream one of :data:`STREAMS` on ``device``; returns the route, the
    shape and the bit errors."""
    code_name, window, chunk, batch, nbytes, noise = STREAMS[name]
    code = pt.get_code(code_name)
    sd = pt.StreamingDecoder(code, "SOFT16", window=window, chunk=chunk,
                             device=device)
    rng = np.random.RandomState(1)
    data = rng.randint(0, 256, (batch, nbytes), dtype=np.uint8)
    syms = np.stack([numpy_ref.encode_bytes(code, d, 127, -127)
                     for d in data]).astype(np.int64)
    syms = np.clip(syms + rng.randint(-noise, noise + 1, syms.shape),
                   -127, 127)
    total_bits = nbytes * 8
    T = total_bits + code.K - 1
    pad = window + chunk
    stream_syms = np.zeros((batch, (T + pad) * code.R), np.int32)
    stream_syms[:, :T * code.R] = syms
    stream_syms = torch.as_tensor(stream_syms, device=sd.device)

    state = sd.reset(batch)
    emitted = []
    for i in range((T + pad) // chunk):
        blk = stream_syms[:, i * chunk * code.R:(i + 1) * chunk * code.R]
        state, bits, valid = sd.push(state, blk)
        if valid:
            emitted.append(bits)
    stream = torch.cat(emitted, dim=1).cpu().numpy()
    got = stream[:, code.K - 1:code.K - 1 + total_bits]
    expect = np.unpackbits(data, axis=1, bitorder="big")
    return {"code": code, "backend": sd.backend, "batch": batch,
            "total_bits": total_bits, "chunk": chunk, "window": window,
            "pushes": (T + pad) // chunk,
            "bit_errors": int((got != expect).sum())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--code", default="voyager", choices=sorted(STREAMS))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_run_streaming: no CUDA card "
                 "(torch.cuda.is_available() is false); pass --cpu to run "
                 "on the CPU")
    r = run(args.code, "cpu" if args.cpu else "cuda")
    print(f"streamed {r['batch']} x {r['total_bits']} bits in "
          f"{r['chunk']}-bit chunks, decision delay {r['window']} steps, "
          f"backend={r['backend']}: {r['bit_errors']} bit errors")
    if r["bit_errors"]:
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
