"""viterbidecodercpp_torch - the PyTorch/CUDA port of the JAX package.

Batched Viterbi decoding with the JAX package's contract (reset /
update / chainback / get_error / decode, the same decoder state and
checkpoint format) and fixed-latency streaming (StreamingDecoder), held
bit-for-bit against it.  Hot loops run as CUDA kernels written for Hopper:
ops/rotated.py and ops/chainback.py for 64 <= S <= 4096, ops/plane.py for
S > 4096, ops/lane.py and ops/chainback.py for S <= 32.  Plain
torch versions of each kernel serve CPU tensors.  utils/testsig.py holds
the AWGN channel model, utils/native.py the native host chain,
puncture.py the puncture schedules and ber.py the BER engine (Eb/No
sweeps).  Imports torch and numpy, never jax.
"""

from .codes import (
    COMMON_CODES,
    DAB_PI_TABLE,
    DAB_PI_X,
    CodeSpec,
    PunctureSpec,
    branch_table,
    get_code,
    parity,
)
from .config import DECODE_TYPES, DecodeType, DecoderConfig, get_decode_config
from .decoder import DecoderState, ViterbiDecoder
from .streaming import StreamingDecoder, StreamingState

__version__ = "0.1.0"

__all__ = [
    "CodeSpec",
    "PunctureSpec",
    "COMMON_CODES",
    "DAB_PI_TABLE",
    "DAB_PI_X",
    "branch_table",
    "get_code",
    "parity",
    "DecoderConfig",
    "DecodeType",
    "DECODE_TYPES",
    "get_decode_config",
    "ViterbiDecoder",
    "DecoderState",
    "StreamingDecoder",
    "StreamingState",
    "__version__",
]
