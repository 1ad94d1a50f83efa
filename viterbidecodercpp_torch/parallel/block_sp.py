"""Time-block sequence parallelism: one long stream across ranks (the port
of the JAX package's ``parallel/block_sp.py``).

The stream's time axis tiles over a mesh's ``time`` axis.  Each rank runs
the ACS over its tile after a *warm-up* region of ``overlap`` steps of
symbols received from its left neighbour, then walks its decision rows
back after a *warm-down* region of ``overlap`` decision rows received
from its right neighbour.  Survivor paths merge within ~5K steps, so with
an overlap of a few hundred steps the interior decode equals the
sequential decode with overwhelming probability, and the halo diagnostic
(:class:`SpResult`) counts the boundaries where it did not.

Boundary semantics are the JAX package's:
  * rank 0 of the time axis runs its own rows only, from the true reset
    metrics; every other rank runs halo + tile from ``spec.init_other``
    in every state (the metrics the ACS starts from without a prior);
  * the last rank walks its own rows from ``end_state`` with rows past
    ``total_rows`` masked (``valid``); every other rank walks own + halo
    rows from state 0 and discards the halo bits.

Routes, as the JAX package picks them with ``use_pallas`` (here by
``decoder.select_backend``):
  * plane (S > 4096): plane ACS (``phase0=0``) over the extended
    tile, plane walk with ``rots`` and, on the last tile, ``valid``;
  * rotated (64 <= S <= 4096): rotated ACS, slot-order walk with ``rots``
    and ``valid``;
  * lane (S <= 32): lane ACS, state-order walk with ``valid`` (the JAX
    package walks this route with a scan; the bits are the same);
  * torch: the plain state-order scan (``ops/torch_core.py``) and the
    plain state-order walk, on any device; ``auto`` takes it where no
    kernel class applies (on the CPU).

Every call runs the ACS from local age 0, so extended-tile row e walks
with rotation (e + 1) mod n: own rows with (base + i + 1) mod n (base 0
on time-rank 0, ``overlap`` elsewhere) and halo rows, which always come
from a non-first neighbour's first ``overlap`` own rows, with
(overlap + i + 1) mod n.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from ..decoder import resolve_device, select_backend
from ..ops import chainback, lane, plane, rotated, torch_core
from ..ops.torch_core import StaticSpec
from .mesh import all_reduce, axis_size, shift

__all__ = ["decode_stream_sp", "SpResult", "dryrun"]


class SpResult(tuple):
    """(bits, halo_mismatches): this rank's decoded tile and the
    convergence diagnostic.

    ``halo_mismatches`` counts disagreements over the duplicated halo
    bits: the oldest min(overlap, K-1) rows of every interior tile
    boundary are decoded twice, by their owner and by the left
    neighbour's warm-down walk, so an overlap too short to converge shows
    as a nonzero count instead of silently wrong interior bits.  It is
    summed over every rank of the mesh; 0 means every boundary converged.
    """

    __slots__ = ()

    def __new__(cls, bits, halo_mismatches):
        return tuple.__new__(cls, (bits, halo_mismatches))

    @property
    def bits(self) -> torch.Tensor:
        return self[0]

    @property
    def halo_mismatches(self) -> torch.Tensor:
        return self[1]


def _acs(route: str, plain: bool, spec: StaticSpec, metrics, symbols):
    """Decision rows of one ACS call: (T, W, B) on the rotated, lane and
    torch routes, (B, T, WRr, 128) on the plane route."""
    if route == "plane":
        fn = plane.acs_plane_ref if plain else plane.acs_plane
    elif route == "rotated":
        fn = rotated.acs_rotated_ref if plain else rotated.acs_rotated
    elif route == "lane":
        fn = lane.acs_lane_ref if plain else lane.acs_lane
    else:
        fn = torch_core.acs_scan
    return fn(spec, metrics, symbols)[1]


def _walk(route: str, plain: bool, spec: StaticSpec, rows, start, rots,
          valid) -> torch.Tensor:
    """(B, N) uint8 path bits of a walk over N decision rows."""
    if route == "plane":
        fn = plane.walk_plane_frames_ref if plain else plane.walk_plane_frames
        return fn(spec, rows, start, rots=rots, valid=valid)
    fn = chainback.walk_rows_ref if plain or route == "torch" \
        else chainback.walk_rows
    slot = route == "rotated"
    bits = fn(spec, rows, start, slot_order=slot,
              rots=rots if slot else None, valid=valid)
    return bits.t().contiguous()


def decode_stream_sp(spec: StaticSpec, mesh, symbols_tile, *, overlap: int,
                     end_state: int = 0, total_rows: Optional[int] = None,
                     backend: str = "auto", plain: bool = False,
                     device="cuda", timings: Optional[dict] = None
                     ) -> SpResult:
    """Decode this rank's tile of one stream whose time axis is split over
    the mesh's ``time`` axis (and its frames over ``data``, when the mesh
    has that axis).  Every rank of the mesh must call it.

    Args:
      symbols_tile: this rank's (B/data, L, R) int32 block of the
        (B, T, R) stream, T = L x time (``launch.local_block``); pad the
        stream's tail with any symbols to make T divide, see
        ``total_rows``.
      overlap: warm-up / warm-down rows (use >= 32 (K-1)), at most L.
      end_state: trellis state after the final transition (0 when
        tail-terminated).
      total_rows: the stream's true row count before padding (default T):
        the last tile's walk starts at its last true row.  Padding must
        be shorter than one tile minus the overlap.
      backend: ``auto``, ``rotated``, ``plane``, ``lane`` or ``torch``
        (see the module docstring); ``plain`` runs the route's kernels'
        plain versions (the on-card reference).
      timings: a dict that receives the seconds of the call's ``tile``
        work (ACS and walks) and ``exchange`` (halos, the tile check and
        the diagnostic's sum, waits for the neighbours included): CUDA
        events on a card, synchronising the device at each span's ends;
        None for no timing and no added synchronisation.

    Returns :class:`SpResult`: (B/data, L) uint8 path bits, row t of the
    stream carrying data bit t - (K-1), and the mismatch count summed over
    the mesh (0-d int64 on ``device``).  Raises ValueError, on every rank,
    when the ranks' tiles differ in shape (the stream does not split
    evenly) and when the padding reaches past one tile minus the overlap.

    With tracing on (``viterbidecodercpp_torch.trace``) the call is a span
    ``sp.decode_stream_sp`` over spans ``sp.exchange`` (detail: the
    stage) and ``sp.tile`` (``acs``, ``walk``); ``timings`` and tracing
    are independent.
    """
    with trace.span("sp.decode_stream_sp"):
        return _decode(spec, mesh, symbols_tile, overlap, end_state,
                       total_rows, backend, plain, device, timings)


def _decode(spec, mesh, symbols_tile, overlap, end_state, total_rows,
            backend, plain, device, timings) -> SpResult:
    dev = resolve_device(device)
    route = select_backend(spec, dev, backend)
    sym = torch.as_tensor(symbols_tile, device=dev)
    if sym.dim() != 3 or sym.shape[2] != spec.R:
        raise ValueError(f"symbols_tile must be (B, L, R={spec.R}), got "
                         f"{tuple(sym.shape)}")
    # the decoder's input contract: clamped to the soft range, so every
    # route agrees on symbols outside it
    sym = torch.clamp(sym.to(torch.int32), spec.soft_low,
                      spec.soft_high).contiguous()
    tgroup = mesh.get_group("time")
    ntime, idx = axis_size(mesh, "time"), mesh.get_local_rank("time")
    names = mesh.mesh_dim_names
    groups = [tgroup] + ([mesh.get_group("data")] if "data" in names
                         else [])
    Bl, L, _ = sym.shape

    # the halos have the neighbours' shapes: every tile must match
    with _span(timings, "exchange", dev, "tile_shape"):
        shape = torch.tensor([L, -L, Bl, -Bl], dtype=torch.int64,
                             device=dev)
        shape = all_reduce(shape, tgroup, dist.ReduceOp.MAX)
        with trace.host_read("sp.tile_shape"):
            shape = shape.tolist()
    if shape[0] != -shape[1] or shape[2] != -shape[3]:
        raise ValueError(
            f"the time axis' tiles differ: lengths {-shape[1]}..{shape[0]}, "
            f"frames {-shape[3]}..{shape[2]}; a stream of T rows must split "
            f"evenly over the {ntime} tiles (pad its tail, see total_rows)")
    T = L * ntime
    O = min(int(overlap), L)
    if O < 1:
        raise ValueError(f"overlap must be >= 1, got {overlap}")
    if total_rows is None:
        total_rows = T
    if ntime > 1 and total_rows <= (ntime - 1) * L + O:
        raise ValueError("stream padding may not exceed one tile minus the "
                         "overlap region")
    n = spec.K - 1
    J = min(O, n)
    plane_route = route == "plane"

    # -- ACS: rank 0 from the reset metrics over its own rows; the others
    # from uniform metrics over the left neighbour's last O rows + tile
    with _span(timings, "exchange", dev, "halo_syms"):
        halo_syms = shift(sym[:, L - O:], tgroup, 1)
    with _span(timings, "tile", dev, "acs"):
        if idx == 0:
            m0 = torch_core.initial_metrics(spec, Bl, 0, dev)
            own = _acs(route, plain, spec, m0, sym)
        else:
            m0 = torch.full((spec.S, Bl), spec.init_other, dtype=torch.int32,
                            device=dev)
            ext = _acs(route, plain, spec, m0,
                       torch.cat([halo_syms, sym], dim=1))
            own = ext[:, O:] if plane_route else ext[O:]
        base = 0 if idx == 0 else O
        rots_own = (torch.arange(L, device=dev, dtype=torch.int32)
                    + base + 1) % n

    # -- walk: the others' first O own rows warm each tile down
    with _span(timings, "exchange", dev, "halo_dec"):
        head = own[:, :O] if plane_route else own[:O]
        halo_dec = shift(head.contiguous(), tgroup, -1)
    with _span(timings, "tile", dev, "walk"):
        if idx == ntime - 1:
            grow = torch.arange(L, device=dev) + idx * L
            valid = (grow < total_rows).to(torch.int32)
            start = torch.full((Bl,), end_state, dtype=torch.int32,
                               device=dev)
            bits = _walk(route, plain, spec, own.contiguous(), start,
                         rots_own, valid)
            halo_pred = None
        else:
            rots_halo = (torch.arange(O, device=dev, dtype=torch.int32)
                         + O + 1) % n
            ext_dec = torch.cat([own, halo_dec], dim=1 if plane_route else 0)
            start = torch.zeros(Bl, dtype=torch.int32, device=dev)
            walked = _walk(route, plain, spec, ext_dec, start,
                           torch.cat([rots_own, rots_halo]), None)
            bits, halo_pred = walked[:, :L], walked[:, L:L + J]

    # -- diagnostic: each owner ships its oldest J bits left
    with _span(timings, "exchange", dev, "diagnostic"):
        recv = shift(bits[:, :J].contiguous(), tgroup, -1)
        diff = torch.zeros((), dtype=torch.int64, device=dev)
        if halo_pred is not None:
            diff = (halo_pred != recv).sum()
        for g in groups:
            diff = all_reduce(diff, g)
    return SpResult(bits, diff)


_SPANS = {"exchange": "sp.exchange", "tile": "sp.tile"}


def _span(timings: Optional[dict], name: str, dev: torch.device,
          stage: str):
    """The recorder's span ``sp.<name>`` (detail ``stage``) around a
    ``with`` body, which with ``timings`` also adds the body's seconds to
    ``timings[name]``: CUDA events on a card, the host clock on the CPU,
    the device synchronised at both ends (a span that waits on the host,
    as a staged exchange does, counts its wait)."""
    return trace.timed_span(_SPANS[name], stage, timings, name, dev)


def dryrun(world: int, *, device="cuda") -> None:
    """A small time-SP decode over a ``world``-rank time axis (every rank
    of the default group calls it): a clean tail-terminated Voyager
    stream must decode exactly, with no halo mismatch."""
    from ..codes import get_code
    from ..config import DecodeType, get_decode_config
    from ..ops import encoder
    from .launch import local_block
    from .mesh import make_mesh

    dev = resolve_device(device)
    code = get_code("Voyager")
    config = get_decode_config(DecodeType.SOFT16, code.R)
    spec = torch_core.make_static_spec(code, config)
    mesh = make_mesh((world,), ("time",), dev.type)
    rng = np.random.RandomState(1)
    nbits = 128 * world
    T = nbits + code.K - 1
    pad_T = -(-T // world) * world
    data = torch.as_tensor(rng.randint(0, 2, (1, nbits)).astype(np.uint8))
    arr = torch.zeros((1, pad_T, code.R), dtype=torch.int32)
    arr[:, :T] = encoder.encode_symbols(code, data, config.soft_decision_high,
                                        config.soft_decision_low)
    out = decode_stream_sp(spec, mesh, local_block(arr, mesh,
                                                   (None, "time", None)),
                           overlap=64, total_rows=T, device=dev)
    if int(out.halo_mismatches) != 0:
        raise AssertionError("the halo diagnostic reported "
                             f"{int(out.halo_mismatches)} mismatches")
    L = pad_T // world
    rows = torch.arange(L) + mesh.get_local_rank("time") * L
    keep = (rows >= code.K - 1) & (rows < T)
    nerr = int((out.bits.cpu()[:, keep]
                != data[:, rows[keep] - (code.K - 1)]).sum())
    if nerr:
        raise AssertionError(f"time-SP decode had {nerr} bit errors")
