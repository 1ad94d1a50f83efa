"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` holds one kernel and a plain ``extern "C"``
launcher that returns ``cudaGetLastError()``.  At first use the source
is compiled for Hopper with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

into ``viterbidecodercpp_torch/_build/`` (ignored by git), keyed on a
hash of the source, every ``csrc/*.cuh`` header and the flags, and loaded
with ``ctypes``.  Nothing
here runs at import time: the CPU tests import every module on a machine
without nvcc.

Every kernel wrapper launches the same way: :func:`check_cuda` on its
int32 inputs, :func:`kernel` for the launcher bound once, and
:func:`launch`, which passes the device's current stream last, raises on
the launcher's CUDA error and counts the launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from .. import trace

__all__ = ["load", "digest", "kernel", "launch", "check_cuda", "BUILD_DIR",
           "CSRC_DIR", "build_seconds"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# Seconds spent in nvcc by this process, per kernel source (0 when the
# library was already built).
build_seconds: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels are built from csrc/ at first use")


def digest(name: str) -> str:
    """Build key of ``csrc/<name>.cu``: its bytes, the headers' (any
    source may include one) and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing and load it."""
    src = CSRC_DIR / f"{name}.cu"
    lib = BUILD_DIR / f"{name}-{digest(name)}.so"
    build_seconds[name] = 0.0
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # build beside the target and rename: concurrent builds (test
        # workers) never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        build_seconds[name] = time.perf_counter() - t0
    return ctypes.CDLL(str(lib))


@functools.lru_cache(maxsize=None)
def kernel(name: str, symbol: str, argtypes: tuple):
    """``symbol`` of ``csrc/<name>.cu``'s library, bound once: it takes
    ``argtypes`` and returns an int (a ``cudaError_t``)."""
    fn = getattr(load(name), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


def launch(fn, kernel_name: str, device: torch.device, *args) -> None:
    """Call ``fn(*args, stream)`` on ``device``, ``stream`` its current CUDA
    stream: a launcher that starts one kernel and returns its CUDA error.
    Raises ``RuntimeError`` naming the kernel on an error; counts the
    launch as ``launches.<kernel_name>``."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel_name} kernel launch failed: CUDA error "
                           f"{err}")
    trace.count("launches." + kernel_name)


def check_cuda(**tensors) -> None:
    """Raise ``ValueError`` unless every tensor given (None skips) is
    contiguous int32, as the kernels read them."""
    for name, x in tensors.items():
        if x is not None and (x.dtype != torch.int32
                              or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 on CUDA, got "
                             f"{x.dtype}, contiguous={x.is_contiguous()}")
