#!/usr/bin/env python3
"""Statistical acceptance demo for the truncated chainback on the PyTorch
port (the twin of tools/ber_truncated_delta.py).

Decodes AWGN-noisy frames (the port's ``utils/testsig.py`` channel, the
Eb/No maths of run_snr_ber.cpp:319-325) once a batch on the plane route,
then walks the same decoder state twice - ``chainback(mode="exact")`` and
``chainback(mode="truncated", block, overlap)`` - and reports BER exact,
BER truncated, their delta and the exact-vs-truncated disagreement rate.
With overlap >= ~10 K the delta is expected to be ~0.  The code must take
the plane route (K = 14..17), the only one with a truncated walk.

    python3 tools/torch_ber_truncated_delta.py                  # on the card
    python3 tools/torch_ber_truncated_delta.py --cpu --bits 256 --batch 2 \\
        --block-bits 128                                         # on the CPU

Exit 1 when the disagreement reaches 1e-3 or the truncated walk's errors
exceed the exact walk's by more than max(64, 2 %).  Before that, the
first batch goes through the plain versions of the three kernels on the
same device (the plane ACS from the reset metrics,
the exact and the truncated walk over the kernel's decisions): metrics,
decision words, renorm totals and both walks' bits must be equal, or the
tool raises.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np
import torch

import viterbidecodercpp_torch as pt
from viterbidecodercpp_torch.ops import plane
from viterbidecodercpp_torch.utils import testsig


class PlainMismatch(AssertionError):
    """A kernel disagreed with its plain version on a batch."""


def check_plain(dec, st0, st, syms, ends, nbits: int, rx_e, rx_t,
                block: int, overlap: int) -> None:
    """Hold one batch's plane ACS, exact walk and truncated walk to their
    plain versions on the same inputs (tolerance 0): the ACS from the
    reset state ``st0``'s metrics over ``syms``, both walks over the
    decisions ``st`` holds (``nbits`` data bits, the tail after them).
    Raises :class:`PlainMismatch`."""
    spec, n = dec.spec, dec.spec.K - 1
    B = syms.shape[0]
    x = torch.clamp(syms.to(torch.int32), spec.soft_low,
                    spec.soft_high).reshape(B, -1, spec.R)
    m, packed, acc = plane.acs_plane_ref(
        spec, st0.metrics, x, out=torch.zeros_like(st.decisions))
    rows = nbits + n
    exact = plane.walk_plane_frames_ref(
        spec, st.decisions[:, :rows], ends, rots=st.row_rots[:rows])[:, n:]
    trunc = plane.chainback_plane_truncated_ref(
        spec, st.decisions, ends, nbits, st.row_rots, block, overlap)
    for what, got, want in (
            ("plane ACS metrics", st.metrics, m),
            ("plane ACS decision words", st.decisions[:, :x.shape[1]],
             packed),
            ("plane ACS renorm totals", st.accumulated_error, acc),
            ("exact plane walk bits", rx_e, exact),
            ("truncated plane walk bits", rx_t, trunc)):
        if not torch.equal(got, want):
            raise PlainMismatch(f"{what} differ from the plain version "
                                f"({int((got != want).sum())} entries)")


def measure(device, code: str = "Cassini", mode: str = "SOFT16",
            ebno: float = 0.5, bits: int = 1 << 21, batch: int = 64,
            block_bits: int = 1024, block: int = 512, overlap: int = 160,
            seed: int = 0, log=None) -> dict:
    """Accumulate at least ``bits`` data bits in batches of ``batch``
    frames of ``block_bits``; returns the error and disagreement counts.
    The first batch is held to the kernels' plain versions
    (:func:`check_plain`).  Raises ValueError for a code that
    does not take the plane route."""
    log = log or (lambda line: None)
    spec_code = pt.get_code(code)
    dec = pt.ViterbiDecoder(spec_code, mode, traceback_length=block_bits,
                            device=device)
    if dec.backend != "plane":
        raise ValueError(f"{spec_code.name} takes the {dec.backend} route, "
                         f"not the plane route; mode='truncated' is "
                         f"plane-only")
    dev = dec.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ends = torch.zeros(batch, dtype=torch.int32, device=dev)
    tot = np.zeros(3, np.int64)
    done = 0
    log(f"[trunc-delta] {spec_code.name} {mode} Eb/No={ebno} dB "
        f"block={block} overlap={overlap} (~10K={10 * spec_code.K}) "
        f"target={bits} bits")
    while done < bits:
        tx = torch.randint(0, 2, (batch, block_bits), generator=g,
                           device=dev, dtype=torch.uint8)
        floats = testsig.modulate_encode(spec_code, tx, True)
        syms = testsig.awgn_quantize(floats, g, ebno, spec_code.R, dec.spec)
        st0 = dec.reset(batch)
        st = dec.update(st0, syms.reshape(batch, -1))
        rx_e = dec.chainback(st, block_bits)
        rx_t = dec.chainback(st, block_bits, mode="truncated", block=block,
                             overlap=overlap)
        if not done:
            check_plain(dec, st0, st, syms, ends, block_bits, rx_e, rx_t,
                        block, overlap)
            log("  batch 1: plane ACS, exact and truncated walk equal to "
                "their plain versions")
        counts = torch.stack([testsig.count_bit_errors(rx_e, tx),
                              testsig.count_bit_errors(rx_t, tx),
                              testsig.count_bit_errors(rx_e, rx_t)])
        tot += counts.cpu().numpy().astype(np.int64)
        done += batch * block_bits
        log(f"  {done} bits: exact={tot[0]} trunc={tot[1]} "
            f"disagree={tot[2]}")
    return {"code": spec_code.name, "bits": done, "errors_exact": int(tot[0]),
            "errors_truncated": int(tot[1]), "disagree": int(tot[2]),
            "ber_exact": tot[0] / done, "ber_truncated": tot[1] / done,
            "disagreement": tot[2] / done}


def verdict(r: dict) -> list:
    """The acceptance failures (empty: pass): the truncated walk may
    differ from the exact walk on a vanishing fraction of bits, and must
    not be materially worse against the data."""
    bad = []
    if r["disagreement"] >= 1e-3:
        bad.append("disagreement far beyond the merge guarantee")
    if r["errors_truncated"] > r["errors_exact"] + max(
            64, int(0.02 * r["errors_exact"])):
        bad.append("truncated BER materially worse than exact")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--code", default="Cassini")
    ap.add_argument("--mode", default="SOFT16")
    ap.add_argument("--ebno", type=float, default=0.5,
                    help="Eb/No in dB (0.5 => Cassini SOFT16 BER ~7e-3)")
    ap.add_argument("--bits", type=int, default=1 << 21,
                    help="total data bits to accumulate")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--block-bits", type=int, default=1024,
                    help="data bits per frame")
    ap.add_argument("--block", type=int, default=512,
                    help="truncated-walk tile rows")
    ap.add_argument("--overlap", type=int, default=160,
                    help="truncated-walk warm-up rows (>= ~10*K)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_ber_truncated_delta: no CUDA card "
                 "(torch.cuda.is_available() is false); pass --cpu to run "
                 "on the CPU")
    try:
        r = measure("cpu" if args.cpu else "cuda", args.code, args.mode,
                    args.ebno, args.bits, args.batch, args.block_bits,
                    args.block, args.overlap, args.seed,
                    log=lambda line: print(line, flush=True))
    except ValueError as exc:
        sys.exit(f"torch_ber_truncated_delta: {exc}")
    done = r["bits"]
    print(f"[trunc-delta] BER exact     = {r['ber_exact']:.6e} "
          f"({r['errors_exact']} errs)")
    print(f"[trunc-delta] BER truncated = {r['ber_truncated']:.6e} "
          f"({r['errors_truncated']} errs)")
    print(f"[trunc-delta] delta         = "
          f"{r['ber_truncated'] - r['ber_exact']:+.3e} "
          f"({r['errors_truncated'] - r['errors_exact']:+d} bits over "
          f"{done})")
    print(f"[trunc-delta] exact-vs-trunc disagreement = "
          f"{r['disagreement']:.3e} ({r['disagree']} bits)")
    bad = verdict(r)
    if bad:
        print(f"[trunc-delta] FAIL: {'; '.join(bad)}")
        return 1
    print("[trunc-delta] PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
