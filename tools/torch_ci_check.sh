#!/bin/sh
# CI-style gate of the PyTorch port, on the pattern of tools/ci_check.sh.
#
#   tools/torch_ci_check.sh              - the port's CPU tests
#                                          (tests/test_torch_*.py, bit-exact
#                                          against the JAX package) and the
#                                          harness tools with --cpu
#   tools/torch_ci_check.sh --cuda [M]   - on a machine with a CUDA card:
#                                          chip_smoke.py, the harness tools
#                                          on the card, M minutes of the
#                                          differential fuzzer (default 5)
#                                          and the kernel routes'
#                                          benchmark piped into
#                                          parse_benchmark.py.  Writes a
#                                          dated CUDA_MATRIX.md, so "green
#                                          on the card at <revision>" is a
#                                          committed fact.
#
# VDT_REVISION names the revision in CUDA_MATRIX.md where the checkout
# has no git history (default: git rev-parse --short HEAD).
set -e
cd "$(dirname "$0")/.."

if [ "$1" = "--cuda" ]; then
    minutes=${2:-5}
    python3 -c "import sys, torch; sys.exit(0 if torch.cuda.is_available() else 1)" \
        || { echo "torch_ci_check --cuda: no CUDA card"; exit 3; }
    trace=${TMPDIR:-/tmp}/vdt_torch_trace
    t0=$(date +%s)
    python3 chip_smoke.py
    smoke_s=$(( $(date +%s) - t0 ))
    echo "torch_ci_check --cuda: chip_smoke.py took $smoke_s s of command"
    python3 tools/torch_run_simple.py
    python3 tools/torch_run_tests.py
    python3 tools/torch_run_streaming.py --code voyager
    python3 tools/torch_run_streaming.py --code cassini
    python3 tools/torch_run_punctured_decoder.py
    python3 tools/torch_ber_truncated_delta.py
    python3 tools/torch_profile_trace.py "$trace" 8 voyager
    python3 tools/torch_profile_trace.py "$trace" 4 cassini
    python3 tools/torch_fuzz_differential.py --minutes "$minutes"
    python3 tools/torch_run_benchmark.py -s cuda -T 0.5 \
        | python3 tools/parse_benchmark.py -

    rev=${VDT_REVISION:-$(git rev-parse --short HEAD 2>/dev/null || echo unknown)}
    if git rev-parse HEAD >/dev/null 2>&1 \
            && [ -n "$(git status --porcelain | head -1)" ]; then
        rev="$rev(+dirty)"
    fi
    {
        echo "# CUDA matrix status"
        echo
        echo "Written by tools/torch_ci_check.sh --cuda after a fully green"
        echo "run on the card: chip_smoke.py (every kernel bit-exact against"
        echo "its plain version, every main path at full width), the"
        echo "harness tools on the card (run_simple, run_tests, both"
        echo "streams, run_punctured_decoder, the truncated-walk delta,"
        echo "both profile traces), $minutes minutes of"
        echo "torch_fuzz_differential.py against the NumPy oracle, and"
        echo "torch_run_benchmark.py -s cuda -T 0.5 read by"
        echo "parse_benchmark.py."
        echo
        echo "- last passed: $(date -u +%Y-%m-%dT%H:%M:%SZ) @ $rev"
        echo "- chip_smoke.py: $smoke_s s of command"
        echo "- device: $(python3 -c 'import torch; print(torch.cuda.get_device_name(0), "x", torch.cuda.device_count())')"
        echo "- card: $(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | head -1)"
        echo "- torch: $(python3 -c 'import torch; print(torch.__version__, "cuda", torch.version.cuda)')"
    } > CUDA_MATRIX.md
    echo "torch_ci_check --cuda: ALL GREEN (artifact: CUDA_MATRIX.md)"
else
    trace=${TMPDIR:-/tmp}/vdt_torch_trace_cpu
    python3 -m pytest tests/test_torch_*.py -q
    python3 tools/torch_run_simple.py --cpu
    python3 tools/torch_run_tests.py --cpu
    python3 tools/torch_run_streaming.py --cpu --code voyager
    python3 tools/torch_run_punctured_decoder.py --cpu
    python3 tools/torch_fuzz_differential.py --cpu --cases 30
    python3 tools/torch_run_benchmark.py --cpu -c 0 -d soft8 -B 2 -M 4 -T 0.1 \
        | python3 tools/parse_benchmark.py -
    python3 tools/torch_profile_trace.py "$trace" 2 voyager --cpu -B 2 -T 64
    echo "torch_ci_check: ALL GREEN"
fi
