#!/usr/bin/env python3
"""DAB FIC punctured decode on the PyTorch port (the twin of
tools/run_punctured_decoder.py, parity with run_punctured_decoder.cpp).

Mother code K=7 R=1/4 {109, 79, 83, 109} (ETSI EN 300 401 clause 11.1.1),
puncture sequence 21 x PI_16 + 3 x PI_15 + PI_X tail (clause 11.2,
run_punctured_decoder.cpp:72-76).  Encodes 96 random bytes (768 data
bits) on the device, punctures, re-inflates with the neutral mid-point
symbol and decodes with every decode regime; requires 0 bit errors
(run_punctured_decoder.cpp:170-190) and exits non-zero otherwise.

    python3 tools/torch_run_punctured_decoder.py          # on the card
    python3 tools/torch_run_punctured_decoder.py --cpu    # on the CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np
import torch

import viterbidecodercpp_torch as pt
from viterbidecodercpp_torch import puncture
from viterbidecodercpp_torch.ops import encoder

GREEN, RED, RESET = "\033[32m", "\033[31m", "\033[0m"


def decode_dab_fic(device, seed: int = 0) -> list:
    """Puncture, re-inflate and decode one DAB FIC frame in each regime
    on ``device``; returns (regime, backend, kept symbols, all symbols,
    bit errors, data bits, traceback error) per regime."""
    code = pt.CodeSpec("DAB FIC mother", 7, (109, 79, 83, 109))
    sched = puncture.dab_fic_schedule(code)
    total_data_bits = 32 * (21 + 3)
    mask = puncture.schedule_mask(sched)
    if mask.size != (total_data_bits + code.K - 1) * code.R:
        raise AssertionError("DAB FIC schedule covers the wrong symbol count")
    rng = np.random.RandomState(seed)
    data = torch.as_tensor(rng.randint(0, 256, (1, total_data_bits // 8),
                                       dtype=np.uint8), device=device)
    bits_tx = encoder.bytes_to_bits(data)
    out = []
    for dt in pt.DECODE_TYPES:
        config = pt.get_decode_config(dt, code.R)
        dec = pt.ViterbiDecoder(code, config,
                                traceback_length=total_data_bits,
                                device=device)
        full = encoder.encode_symbols(code, bits_tx,
                                      config.soft_decision_high,
                                      config.soft_decision_low)
        # transmitter: drop the punctured symbols
        tx = puncture.puncture_np(full.reshape(1, -1).cpu().numpy(), mask)
        # receiver: re-inflate with the neutral unpunctured value 0
        rx = encoder.depuncture(torch.as_tensor(tx, device=device), mask,
                                neutral=0)
        bits, err, acc = dec.decode(rx, total_data_bits)
        errors = int((bits != bits_tx).sum())
        out.append((dt.value, dec.backend, int(mask.sum()), mask.size, errors,
                    total_data_bits, int(err[0]) + int(acc[0])))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    total = passed = 0
    for regime, backend, kept, syms, errors, nbits, tb_err in decode_dab_fic(
            "cpu" if args.cpu else "cuda"):
        ok = errors == 0
        total += 1
        passed += int(ok)
        mark = f"{GREEN}PASS{RESET}" if ok else f"{RED}FAIL{RESET}"
        print(f"{mark} {regime:7s} backend={backend} "
              f"punctured {syms}->{kept} symbols "
              f"(effective rate 1/4 -> {syms / kept:.3f}/4), "
              f"bit errors {errors}/{nbits}, traceback_error={tb_err}")
    print(f"\n{passed}/{total} passed")
    return 0 if passed == total else 1


if __name__ == "__main__":
    sys.exit(main())
