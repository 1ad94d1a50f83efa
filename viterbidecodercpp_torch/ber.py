"""BER measurement on the device (the run_snr_ber engine; the port of the
JAX package's ``ber.py``).

The reference measures BER with a host loop: generate a block, encode,
add noise, decode, count errors, repeat until a bit budget or an error
budget is hit (run_snr_ber.cpp:335-379).  Here each batch of frames is
generated, encoded, sent through the AWGN channel, quantised, decoded
and counted on the device (``utils/testsig.py`` and
:class:`~viterbidecodercpp_torch.decoder.ViterbiDecoder`, whose routing
picks the rotated, lane or plane kernels); the host reads one error
count a batch to apply the stopping rule.

With ``group=`` (a ``torch.distributed`` process group) a point runs
data-parallel, the port of the JAX ``mesh=`` path: every rank draws
``batch`` frames a batch from its own generator (:func:`rank_generator`),
and one ``all_reduce(SUM)`` a batch carries the batch's errors and the
timeout flag, so every rank takes the same number of batches and the
budgets are global (a batch is world x batch x block_bits bits).

Stopping semantics are the JAX package's, which mirror get_test_range /
run_test (run_snr_ber.cpp:220-233, 318-396): per point, run batches while
``bits < max_bits and errors < max_errors`` (checked before every batch
on the running totals), with the same int32 cap on both budgets; with
``timeout_seconds`` the clock is read between slices of
``4 * batch * block_bits`` bits; per sweep, advance Eb/No in 0.5 dB
steps from 0 until a zero-error point or the point cap.

Randomness comes from explicit ``torch.Generator``s on the device in
place of ``jax.random`` keys, so curves agree with the JAX package's in
distribution, not bit for bit; the host chain
(:func:`measure_point_host_chain`) uses the native mt19937 channel and
agrees exactly.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import trace
from .codes import CodeSpec
from .config import DecoderConfig
from .decoder import ViterbiDecoder, resolve_device
from .parallel.mesh import all_reduce
from .utils import testsig

__all__ = ["BerPoint", "SweepResult", "default_max_bits", "measure_point",
           "measure_point_host_chain", "sweep", "point_generator",
           "rank_generator", "capped_budgets", "draw_batch",
           "decode_errors"]


@dataclasses.dataclass
class BerPoint:
    EbNo_dB: float
    ber: float
    total_bits: int
    total_bit_errors: int


@dataclasses.dataclass
class SweepResult:
    code: CodeSpec
    points: List[BerPoint]

    @property
    def EbNo_dB(self):
        return [p.EbNo_dB for p in self.points]

    @property
    def ber(self):
        return [p.ber for p in self.points]


def default_max_bits(code: CodeSpec, scale: float = 1.0) -> int:
    """Bit budget per point: 1e9 / (R * 2^(K-1)) (run_snr_ber.cpp:220-233)."""
    runtime_scale = code.R * (1 << (code.K - 1))
    return int(math.ceil(scale * (1e9 / runtime_scale)))


def _seeded(entropy, device) -> torch.Generator:
    words = np.random.SeedSequence([int(x) for x in entropy]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(words[0]) << 32 | int(words[1]))
    return g


def point_generator(seed: int, index: int, device="cuda") -> torch.Generator:
    """The generator of point ``index`` of a sweep seeded ``seed``: its
    own stream, so a point does not depend on how many batches the
    points before it drew."""
    return _seeded((seed, index), device)


def rank_generator(seed: int, index: int, rank: int,
                   device="cuda") -> torch.Generator:
    """The generator of rank ``rank`` at point ``index`` of a
    data-parallel sweep seeded ``seed``: one stream a (point, rank), from
    ``SeedSequence([seed, index, rank])``."""
    return _seeded((seed, index, rank), device)


def capped_budgets(max_bits: int, max_errors: int, step: int
                   ) -> Tuple[int, int]:
    """The JAX package's int32 cap on both budgets: its device counters
    are int32, so the thresholds stay one batch of ``step`` bits (all
    ranks' frames, world x batch x block_bits, on a data-parallel point)
    below INT32_MAX, and the totals (multiples of ``step``) are the same
    for the same budgets."""
    cap = (1 << 31) - 1 - step
    return min(int(max_bits), cap), min(int(max_errors), cap)


def draw_batch(code: CodeSpec, config: DecoderConfig, EbNo_dB: float,
               generator: torch.Generator, batch: int, block_bits: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch of the channel on the generator's device: (batch,
    block_bits) uint8 data bits, and their (batch, T, R) int32 soft
    symbols (encoded with the K-1 tail, AWGN at ``EbNo_dB``, quantised
    to the config's soft range)."""
    tx = torch.randint(0, 2, (batch, block_bits), generator=generator,
                       dtype=torch.uint8, device=generator.device)
    syms = testsig.awgn_quantize(testsig.modulate_encode(code, tx),
                                 generator, EbNo_dB, code.R, config)
    return syms, tx


def decode_errors(dec: ViterbiDecoder, syms: torch.Tensor, tx: torch.Tensor
                  ) -> torch.Tensor:
    """The decode-and-count half of a batch: (B, T, R) soft symbols of
    (B, N) data bits ``tx`` -> their bit errors, a 0-d int32 tensor on
    the decoder's device (no host read)."""
    B, N = tx.shape
    rx, _, _ = dec.decode(syms.reshape(B, -1), N)
    return testsig.count_bit_errors(rx, tx)


def measure_point(code: CodeSpec, config: DecoderConfig, EbNo_dB: float, *,
                  generator: torch.Generator, block_bits: int = 2048,
                  batch: int = 256, max_bits: int, max_errors: int = 10_000,
                  backend: str = "auto",
                  timeout_seconds: Optional[float] = None,
                  device="cuda", group=None) -> BerPoint:
    """Measure one (code, config, Eb/No) BER point on ``device``.

    Each batch draws ``batch`` frames of ``block_bits`` data bits from
    ``generator`` (a ``torch.Generator`` on ``device``), encodes them
    with the K-1 tail, adds AWGN, quantises to the config's soft range
    and decodes them with one ``ViterbiDecoder(code, config,
    traceback_length=block_bits, backend=backend, device=device)``.

    ``timeout_seconds`` adds the reference's third per-point stopping
    rule (run_snr_ber.cpp:361-379): the point also ends when its wall
    clock expires, read between slices of four batches.

    ``group``: run the point data-parallel over the group's ranks (every
    rank calls it with its own ``generator``, e.g. :func:`rank_generator`;
    ``batch`` frames a rank).  Each batch's errors are summed over the
    ranks in one ``all_reduce``, which also carries the timeout flag (any
    rank's clock ends the point on every rank: the ranks must agree on
    the stop, or one would wait forever in a collective the others left).
    The budgets and the returned totals are global.
    """
    dev = resolve_device(device)
    if generator.device != dev:
        raise ValueError(f"the generator lies on {generator.device}, the "
                         f"point runs on {dev}")
    dec = ViterbiDecoder(code, config, traceback_length=block_bits,
                         backend=backend, device=dev)
    world = 1
    if group is not None:
        world = dist.get_world_size(group)
    step = world * batch * block_bits
    max_bits, max_errors = capped_budgets(max_bits, max_errors, step)
    t0 = time.perf_counter()

    def expired() -> bool:
        return (timeout_seconds is not None
                and time.perf_counter() - t0 > timeout_seconds)

    def run(stop_bits: int, bits: int, errors: int) -> Tuple[int, int, bool]:
        # the JAX while_loop's cond and body, one host read a batch
        fired = False
        # a fired flag ends the point on every rank, whichever rank's
        # clock (or none, without a timeout of its own) set it
        while bits < stop_bits and errors < max_errors and not fired:
            syms, tx = draw_batch(code, config, EbNo_dB, generator, batch,
                                  block_bits)
            e = decode_errors(dec, syms, tx)
            if group is None:
                with trace.host_read("ber.counts"):
                    errors += int(e)
            else:
                flag = int(bits + step >= stop_bits and expired())
                counts = all_reduce(torch.stack(
                    [e.to(torch.int64),
                     torch.full((), flag, dtype=torch.int64, device=dev)]),
                    group)
                with trace.host_read("ber.counts"):
                    e, fired = counts.tolist()
                errors += e
                fired = fired > 0
            bits += step
        if group is None:
            fired = expired()
        return bits, errors, fired

    if timeout_seconds is None:
        bits_done, errors, _ = run(max_bits, 0, 0)
    else:
        slice_bits = 4 * step
        bits_done = errors = 0
        while True:
            bits_done, errors, fired = run(
                min(max_bits, bits_done + slice_bits), bits_done, errors)
            if bits_done >= max_bits or errors >= max_errors or fired:
                break
    return BerPoint(EbNo_dB=float(EbNo_dB),
                    ber=errors / bits_done if bits_done else 0.0,
                    total_bits=bits_done, total_bit_errors=errors)


def measure_point_host_chain(code: CodeSpec, config: DecoderConfig,
                             EbNo_dB: float, *, seed: int = 0,
                             block_bits: int = 2048, batch: int = 256,
                             max_bits: int, max_errors: int = 10_000,
                             timeout_seconds: Optional[float] = None,
                             backend: str = "auto",
                             device="cuda") -> BerPoint:
    """BER point with the *host* signal chain: the native C++ runtime
    generates data and runs encode -> AWGN -> quantise with mt19937
    noise exactly like the reference harness (run_snr_ber.cpp:317-359),
    the symbols go to ``device`` for the decode and the bits come back
    for the byte count.  The same seed gives the same point as the JAX
    package's function (the decoders are bit-exact)."""
    from .utils import native

    dev = resolve_device(device)
    enc = native.NativeEncoder(code.K, code.G)
    dec = ViterbiDecoder(code, config, traceback_length=block_bits,
                         backend=backend, device=dev)
    nbytes = block_bits // 8
    bits_done = 0
    errors = 0
    frame = 0
    t0 = time.perf_counter()
    while bits_done < max_bits and errors < max_errors:
        if (timeout_seconds is not None
                and time.perf_counter() - t0 > timeout_seconds):
            # third stopping rule (run_snr_ber.cpp:361-379)
            break
        data = native.random_bytes(seed * 1_000_003 + frame,
                                   batch * nbytes).reshape(batch, nbytes)
        syms = enc.encode_awgn_quantize(
            data, EbNo_dB, config.soft_decision_high,
            config.soft_decision_low, seed=seed * 7_000_003 + frame)
        out, _, _ = dec.decode(torch.from_numpy(syms).to(dev), block_bits)
        got = np.packbits(out.cpu().numpy(), axis=-1, bitorder="big")
        errors += native.count_bit_errors_bytes(got, data)
        bits_done += batch * block_bits
        frame += batch
    return BerPoint(EbNo_dB=float(EbNo_dB),
                    ber=errors / bits_done if bits_done else 0.0,
                    total_bits=bits_done, total_bit_errors=int(errors))


def sweep(code: CodeSpec, config: DecoderConfig, *, seed: int = 0,
          EbNo_start: float = 0.0, EbNo_step: float = 0.5,
          max_points: int = 24, block_bits: int = 2048, batch: int = 256,
          max_bits: Optional[int] = None, max_errors: int = 10_000,
          bits_scale: float = 1.0, backend: str = "auto",
          host_chain: bool = False,
          timeout_seconds: Optional[float] = None,
          device="cuda", group=None) -> SweepResult:
    """Eb/No sweep, stopping at the first zero-error point
    (run_snr_ber.cpp:318-396).  Point i draws from
    ``point_generator(seed, i, device)``; ``host_chain`` generates the
    channel on the native C++ runtime instead (seed ``seed + i``, as the
    JAX package does); ``timeout_seconds`` bounds each point's wall clock
    (the -T stopping rule); ``group`` runs every point data-parallel over
    the group's ranks (see :func:`measure_point`), rank r of the group
    drawing point i from ``rank_generator(seed, i, r, device)``."""
    device = resolve_device(device)
    if max_bits is None:
        max_bits = default_max_bits(code, bits_scale)
    if group is not None and host_chain:
        raise ValueError("group (data-parallel points) and host_chain are "
                         "mutually exclusive: the host chain generates "
                         "the channel on this process's CPU")
    points = []
    for i in range(max_points):
        EbNo = EbNo_start + i * EbNo_step
        if host_chain:
            p = measure_point_host_chain(
                code, config, EbNo, seed=seed + i, block_bits=block_bits,
                batch=batch, max_bits=max_bits, max_errors=max_errors,
                timeout_seconds=timeout_seconds, backend=backend,
                device=device)
        else:
            gen = (point_generator(seed, i, device) if group is None else
                   rank_generator(seed, i, dist.get_rank(group), device))
            p = measure_point(code, config, EbNo, generator=gen,
                              block_bits=block_bits, batch=batch,
                              max_bits=max_bits, max_errors=max_errors,
                              backend=backend,
                              timeout_seconds=timeout_seconds, device=device,
                              group=group)
        points.append(p)
        if p.total_bit_errors == 0:
            break
    return SweepResult(code=code, points=points)
