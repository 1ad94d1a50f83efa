"""Frame data-parallel decoding over ranks (the port of the JAX package's
``parallel/frame_dp.py``).

Frames are independent, so each rank decodes its own block of frames
with the port's :class:`~viterbidecodercpp_torch.decoder.ViterbiDecoder`
(whose routing sends them through the rotated, plane or lane kernels,
as frame_dp.py:46-74 does) and the ranks meet once a call: one
``all_reduce(SUM)`` of the bit-error count.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..codes import CodeSpec
from ..config import DecoderConfig
from ..decoder import ViterbiDecoder, resolve_device
from .mesh import all_reduce

__all__ = ["decode_dp", "dryrun"]


def decode_dp(code: CodeSpec, config: DecoderConfig, symbols_local,
              total_bits: int, *, group=None, reference_bits=None,
              backend: str = "auto", device="cuda"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode this rank's frames, (B_local, T, R) or (B_local, T*R) soft
    symbols, on ``device``.

    Returns (bits (B_local, total_bits) uint8, the bit errors against
    ``reference_bits`` (B_local, total_bits) summed over ``group``'s ranks
    (the default group for None), a 0-d int64 tensor; 0 without a
    reference, as the JAX function gives).  Every rank of the group must
    call it.  Without an initialised process group the sum is this
    rank's own count.
    """
    dev = resolve_device(device)
    dec = ViterbiDecoder(code, config, backend=backend, device=dev)
    syms = torch.as_tensor(symbols_local, device=dev)
    B = syms.shape[0]
    bits, _, _ = dec.decode(syms.reshape(B, -1), total_bits)
    if reference_bits is None:
        errs = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        ref = torch.as_tensor(reference_bits, device=dev)
        errs = (bits != ref).sum()
    return bits, all_reduce(errs, group)


def dryrun(world: int, *, device="cuda") -> None:
    """One frame-DP, data-parallel BER and time-SP step on a ``world``-rank
    process group (every rank calls it; the port of the JAX package's
    ``dryrun``): frames over a ``data`` axis, a BER point with
    its budgets summed over the ranks, one stream over a ``time`` axis
    (``block_sp.dryrun``) and, for an even world of 4 or more, the same
    stream on a (2, world/2) data x time mesh.  Raises on any mismatch."""
    import torch.distributed as dist

    from .. import ber
    from ..codes import get_code
    from ..config import DecodeType, get_decode_config
    from ..ops import encoder, torch_core
    from . import block_sp
    from .launch import local_block
    from .mesh import make_mesh

    dev = resolve_device(device)
    if dist.get_world_size() != world:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, not {world}")
    code = get_code("Voyager")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    hi, lo = config.soft_decision_high, config.soft_decision_low

    # --- frame-DP leg -----------------------------------------------------
    mesh = make_mesh((world,), ("data",), dev.type)
    rng = np.random.RandomState(0)
    B, nbits = 2 * world, 64
    data = torch.as_tensor(rng.randint(0, 2, (B, nbits)).astype(np.uint8))
    syms = encoder.encode_symbols(code, data, hi, lo)
    mine = local_block(syms, mesh, ("data", None, None))
    ref = local_block(data, mesh, ("data", None))
    _, errs = decode_dp(code, config, mine, nbits, reference_bits=ref,
                        group=mesh.get_group("data"), device=dev)
    if int(errs) != 0:
        raise AssertionError(f"frame-DP decode had {int(errs)} bit errors")

    # --- data-parallel BER leg: budgets summed over the ranks -------------
    p = ber.measure_point(
        code, config, 4.0,
        generator=ber.rank_generator(0, 0, dist.get_rank(), dev),
        block_bits=128, batch=2, max_bits=world * 2 * 128,
        max_errors=10_000, group=mesh.get_group("data"), device=dev)
    if p.total_bits < world * 2 * 128:
        raise AssertionError(f"data-parallel BER point stopped early: {p}")

    # --- time-SP leg ------------------------------------------------------
    if world >= 2:
        block_sp.dryrun(world, device=dev)

    # --- 2-D leg: frame-DP x time-SP on one mesh ----------------------------
    if world >= 4 and world % 2 == 0:
        ntime = world // 2
        mesh2 = make_mesh((2, ntime), ("data", "time"), dev.type)
        nbits2 = 128 * ntime
        T2 = nbits2 + code.K - 1
        pad_T2 = -(-T2 // ntime) * ntime
        d2 = torch.as_tensor(rng.randint(0, 2, (2, nbits2)).astype(np.uint8))
        arr2 = torch.zeros((2, pad_T2, code.R), dtype=torch.int32)
        arr2[:, :T2] = encoder.encode_symbols(code, d2, hi, lo)
        tile = local_block(arr2, mesh2, ("data", "time", None))
        out = block_sp.decode_stream_sp(
            torch_core.make_static_spec(code, config), mesh2, tile,
            overlap=64, total_rows=T2, device=dev)
        if int(out.halo_mismatches) != 0:
            raise AssertionError("2-D mesh: the halo diagnostic reported "
                                 f"{int(out.halo_mismatches)} mismatches")
        # row t of the stream carries data bit t - (K-1)
        L = tile.shape[1]
        rows = torch.arange(L) + mesh2.get_local_rank("time") * L
        keep = (rows >= code.K - 1) & (rows < T2)
        want = local_block(d2, mesh2, ("data", None))
        nerr = int((out.bits.cpu()[:, keep]
                    != want[:, rows[keep] - (code.K - 1)]).sum())
        if nerr:
            raise AssertionError(f"2-D mesh decode had {nerr} bit errors")
