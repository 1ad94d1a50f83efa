"""ctypes bindings for the native host-side signal-chain runtime (the
port's own copy of the JAX package's ``utils/native.py``).

The C++ library (``native/sigchain.cpp`` at the root of the checkout)
provides the host runtime: multithreaded convolutional encoding, the
fused encode->AWGN->quantise channel chain of the reference BER harness
(run_snr_ber.cpp:337-359) with its mt19937 noise, puncturing and
depuncturing (helpers/puncture_code_helpers.h) and popcount bit-error
scoring (helpers/test_helpers.h:95-104).

It differs from the JAX module in how the library is found:

* At first use the source is compiled with

      g++ -O3 -std=c++17 -fPIC -shared -pthread -march=native

  into ``viterbidecodercpp_torch/_build/`` (ignored by git), keyed on a
  hash of the source, the flags and the host CPU (``-march=native``
  targets it), and loaded with ``ctypes``.  Nothing runs at import time.
* A failed build raises ``RuntimeError`` carrying g++'s stderr: there is
  no NumPy fallback, whose ``random_bytes`` would give other bytes than
  the native generator.
* There is no environment override of the library's path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence

import numpy as np

__all__ = [
    "ensure_built",
    "NativeEncoder",
    "count_bit_errors_bytes",
    "count_bit_errors_bits",
    "random_bytes",
    "puncture",
    "depuncture",
]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "sigchain.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
             "-march=native")
ABI_VERSION = 1

# Seconds this process spent in g++ (0 when the library was already built).
build_seconds = 0.0


def _host_cpu() -> bytes:
    """What ``-march=native`` depends on: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(lines[:2])
    except OSError:
        return platform.processor().encode()


def _digest() -> str:
    if not SOURCE.exists():
        raise RuntimeError(f"native runtime source {SOURCE} is missing: the "
                           f"host chain builds it from a source checkout")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_host_cpu())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.vdt_abi_version.restype = c.c_int
    lib.vdt_encoder_create.restype = c.c_void_p
    lib.vdt_encoder_create.argtypes = [c.c_int, c.c_int,
                                       c.POINTER(c.c_uint64)]
    lib.vdt_encoder_destroy.argtypes = [c.c_void_p]
    lib.vdt_encode_soft_i16.argtypes = [
        c.c_void_p, c.POINTER(c.c_uint8), c.c_size_t, c.c_size_t, c.c_int,
        c.c_int16, c.c_int16, c.c_int, c.POINTER(c.c_int16)]
    lib.vdt_encode_bits.argtypes = [
        c.c_void_p, c.POINTER(c.c_uint8), c.c_size_t, c.c_size_t, c.c_int,
        c.c_int, c.POINTER(c.c_uint8)]
    lib.vdt_encode_awgn_quantize_i16.argtypes = [
        c.c_void_p, c.POINTER(c.c_uint8), c.c_size_t, c.c_size_t, c.c_int,
        c.c_double, c.c_int16, c.c_int16, c.c_uint64, c.c_int,
        c.POINTER(c.c_int16)]
    lib.vdt_puncture_i16.restype = c.c_size_t
    lib.vdt_puncture_i16.argtypes = [
        c.POINTER(c.c_int16), c.c_size_t, c.POINTER(c.c_uint8),
        c.POINTER(c.c_int16)]
    lib.vdt_depuncture_i16.restype = c.c_size_t
    lib.vdt_depuncture_i16.argtypes = [
        c.POINTER(c.c_int16), c.c_size_t, c.c_size_t, c.POINTER(c.c_uint8),
        c.c_int16, c.POINTER(c.c_int16)]
    lib.vdt_count_bit_errors_bytes.restype = c.c_uint64
    lib.vdt_count_bit_errors_bytes.argtypes = [
        c.POINTER(c.c_uint8), c.POINTER(c.c_uint8), c.c_size_t]
    lib.vdt_count_bit_errors_bits.restype = c.c_uint64
    lib.vdt_count_bit_errors_bits.argtypes = [
        c.POINTER(c.c_uint8), c.POINTER(c.c_uint8), c.c_size_t]
    lib.vdt_random_bytes.argtypes = [c.c_uint64, c.POINTER(c.c_uint8),
                                     c.c_size_t]
    return lib


@functools.lru_cache(maxsize=None)
def ensure_built() -> ctypes.CDLL:
    """Compile the library if its build is missing, load it and return
    it; raises ``RuntimeError`` (with g++'s stderr) if it cannot."""
    global build_seconds
    lib = BUILD_DIR / f"libvdtsigchain-{_digest()}.so"
    if not lib.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found on PATH: the native host "
                               "runtime is built from native/sigchain.cpp "
                               "at first use")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # build beside the target and rename: concurrent builds (test
        # workers) never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        build_seconds = time.perf_counter() - t0
    out = _bind(ctypes.CDLL(str(lib)))
    if out.vdt_abi_version() != ABI_VERSION:
        raise RuntimeError(f"{lib} has ABI version {out.vdt_abi_version()}, "
                           f"expected {ABI_VERSION}")
    return out


def _u8(a):
    return np.ascontiguousarray(a, dtype=np.uint8)


def _i16(a):
    return np.ascontiguousarray(a, dtype=np.int16)


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeEncoder:
    """Batched convolutional encoder + channel chain over C++ threads.

    Mirrors the reference encoders (convolutional_encoder_lookup.h:15-82 /
    convolutional_encoder_shift_register.h:14-63) and signal-chain helpers
    (helpers/test_helpers.h:17-64, run_snr_ber.cpp:337-359).
    """

    def __init__(self, K: int, G: Sequence[int], *, n_threads: int = 0):
        self._lib = lib = ensure_built()
        self.K = int(K)
        self.G = tuple(int(g) for g in G)
        self.R = len(self.G)
        self.n_threads = int(n_threads)
        g_arr = (ctypes.c_uint64 * self.R)(*self.G)
        self._h = lib.vdt_encoder_create(self.K, self.R, g_arr)
        if not self._h:
            raise ValueError(f"invalid encoder parameters K={K} G={G}")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.vdt_encoder_destroy(h)
            self._h = None

    def _frame_syms(self, n_bytes: int, terminate: bool) -> int:
        T = 8 * n_bytes + (self.K - 1 if terminate else 0)
        return T * self.R

    def encode_soft(self, data: np.ndarray, high: int, low: int, *,
                    terminate: bool = True) -> np.ndarray:
        """(B, n_bytes) uint8 -> (B, T*R) int16 symbols in {low, high}."""
        data = np.atleast_2d(_u8(data))
        B, n_bytes = data.shape
        out = np.empty((B, self._frame_syms(n_bytes, terminate)), np.int16)
        self._lib.vdt_encode_soft_i16(
            self._h, _ptr(data, ctypes.c_uint8), B, n_bytes,
            int(terminate), high, low, self.n_threads,
            _ptr(out, ctypes.c_int16))
        return out

    def encode_bits(self, data: np.ndarray, *,
                    terminate: bool = True) -> np.ndarray:
        """(B, n_bytes) uint8 -> (B, T*R) uint8 encoded bits."""
        data = np.atleast_2d(_u8(data))
        B, n_bytes = data.shape
        out = np.empty((B, self._frame_syms(n_bytes, terminate)), np.uint8)
        self._lib.vdt_encode_bits(
            self._h, _ptr(data, ctypes.c_uint8), B, n_bytes,
            int(terminate), self.n_threads, _ptr(out, ctypes.c_uint8))
        return out

    def encode_awgn_quantize(self, data: np.ndarray, EbNo_dB: float,
                             high: int, low: int, *, seed: int = 0,
                             terminate: bool = True) -> np.ndarray:
        """Fused encode -> BPSK -> AWGN -> quantise (run_snr_ber.cpp chain).

        Noise is mt19937/normal_distribution seeded ``seed + frame_index``,
        so results are reproducible and thread-count independent.
        """
        data = np.atleast_2d(_u8(data))
        B, n_bytes = data.shape
        out = np.empty((B, self._frame_syms(n_bytes, terminate)), np.int16)
        self._lib.vdt_encode_awgn_quantize_i16(
            self._h, _ptr(data, ctypes.c_uint8), B, n_bytes,
            int(terminate), float(EbNo_dB), high, low, int(seed),
            self.n_threads, _ptr(out, ctypes.c_int16))
        return out


def count_bit_errors_bytes(a: np.ndarray, b: np.ndarray) -> int:
    """Popcount of XOR over byte arrays (test_helpers.h:95-104)."""
    a, b = _u8(a).ravel(), _u8(b).ravel()
    if a.size != b.size:
        raise ValueError("size mismatch")
    return int(ensure_built().vdt_count_bit_errors_bytes(
        _ptr(a, ctypes.c_uint8), _ptr(b, ctypes.c_uint8), a.size))


def count_bit_errors_bits(a: np.ndarray, b: np.ndarray) -> int:
    """Mismatch count over 0/1 bit arrays."""
    a, b = _u8(a).ravel(), _u8(b).ravel()
    if a.size != b.size:
        raise ValueError("size mismatch")
    return int(ensure_built().vdt_count_bit_errors_bits(
        _ptr(a, ctypes.c_uint8), _ptr(b, ctypes.c_uint8), a.size))


def random_bytes(seed: int, n: int) -> np.ndarray:
    """Deterministic test bytes from mt19937_64 (generate_random_bytes
    equivalent)."""
    out = np.empty(n, np.uint8)
    ensure_built().vdt_random_bytes(int(seed), _ptr(out, ctypes.c_uint8), n)
    return out


def puncture(syms: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Drop symbols where mask==0 (encode_punctured_data semantics)."""
    syms, mask = _i16(syms).ravel(), _u8(mask).ravel()
    if syms.size != mask.size:
        raise ValueError("mask length must equal symbol count")
    out = np.empty(int(mask.astype(bool).sum()), np.int16)
    n = ensure_built().vdt_puncture_i16(_ptr(syms, ctypes.c_int16),
                                        syms.size,
                                        _ptr(mask, ctypes.c_uint8),
                                        _ptr(out, ctypes.c_int16))
    return out[:n]


def depuncture(kept: np.ndarray, mask: np.ndarray,
               neutral: int = 0) -> np.ndarray:
    """Re-inflate kept symbols to the full lattice, inserting ``neutral``
    at punctured positions (decode_punctured_symbols semantics); a short
    input pads with ``neutral``."""
    kept, mask = _i16(kept).ravel(), _u8(mask).ravel()
    out = np.empty(mask.size, np.int16)
    ensure_built().vdt_depuncture_i16(
        _ptr(kept, ctypes.c_int16), kept.size, mask.size,
        _ptr(mask, ctypes.c_uint8), ctypes.c_int16(neutral),
        _ptr(out, ctypes.c_int16))
    return out
