"""Multi-process execution over ``torch.distributed`` (the port of the JAX
package's ``parallel/launch.py``).

A torch rank is one process driving one device.  Ranks join one process
group (:func:`initialize`), build a mesh of named axes over it
(:func:`make_hybrid_mesh`), and each hands its own block of the work to
the parallel functions (:func:`local_block`): there is no global array to
assemble, so the JAX module's ``global_array`` has no counterpart.

Backends:

  * ``gloo`` on the CPU (the CI stand-in for a fleet: tests spawn CPU
    ranks with :func:`spawn_fleet`);
  * ``nccl`` between cards, one rank per card;
  * ``gloo`` for several ranks that share one card: NCCL refuses two
    ranks on one GPU, so those ranks move their halos and counters
    through host memory (``mesh.all_reduce`` and ``mesh.shift`` stage
    them).  Nothing switches backend by itself: NCCL with more ranks on a
    host than it has cards raises.

Axis placement is the JAX package's: ``data`` (frame-DP, one scalar sum a
call) on the outer, cross-host dimension; ``time`` (halo exchange between
neighbouring tiles) on the inner one, within a host.  Ranks are numbered
host-major (the ranks of a host are consecutive), so a reshape of the
rank order puts the host dimension outermost.

Run a dryrun fleet on the CPU with::

    python -m viterbidecodercpp_torch.parallel.launch --spawn 4 --device cpu

(on the card without ``--device cpu``: NCCL, one rank a card, or
``--backend gloo`` for ranks that share one)

or one rank of a fleet with ``--init-method URL --world-size N --rank R``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..decoder import resolve_device
from .mesh import axis_size

__all__ = ["initialize", "make_hybrid_mesh", "local_block", "spawn_fleet",
           "launch_processes", "dryrun_worker"]

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _rank_device(rank: int, device: str = "cuda") -> torch.device:
    """A rank's device: ``cuda:(local_rank % device_count)``, the local
    rank read from ``LOCAL_RANK`` (else the rank), unless ``device`` is
    ``"cpu"``.  Raises without a card."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    resolve_device("cuda:0")           # raises without a card
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(init_method: str, world_size: int, rank: int, *,
               backend: Optional[str] = None,
               device: str = "cuda") -> torch.device:
    """Join this process to a run of ``world_size`` ranks as ``rank`` and
    return its device (:func:`_rank_device`).

    ``init_method`` is a ``torch.distributed`` URL: ``tcp://host:port``
    across hosts, or ``file:///path`` (a file no other run uses) on one
    machine.  ``backend`` defaults to ``nccl`` on the card and ``gloo`` on
    the CPU.  NCCL takes CUDA tensors, one rank per card: it raises for
    ``device="cpu"`` and when the host runs more ranks
    (``LOCAL_WORLD_SIZE``, else ``world_size``) than it has cards.  CPU
    ranks use one intra-op thread each, so several share a machine.
    """
    dev = _rank_device(rank, device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL moves CUDA tensors only: run CPU ranks "
                             "with backend='gloo'")
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(
                f"NCCL takes one rank per card: {local_world} ranks on this "
                f"host, {cards} card(s); run ranks that share a card with "
                f"backend='gloo' (halos staged through host memory)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dev


def _hybrid_ranks(dcn: Dict[str, int], ici: Dict[str, int], world: int):
    """(axis names, rank array) of a hybrid mesh: DCN axes outer, ICI
    axes inner, over ranks 0..world-1 in host-major order."""
    if not dcn and not ici:
        raise ValueError("give at least one mesh axis")
    names = tuple(dcn) + tuple(ici)
    if len(set(names)) != len(names):
        raise ValueError(f"an axis appears twice: {names}")
    sizes = tuple(dcn.values()) + tuple(ici.values())
    n = int(np.prod(sizes))
    if n != world:
        raise ValueError(f"mesh axes {dict(zip(names, sizes))} need {n} "
                         f"ranks, the process group has {world}")
    return names, np.arange(world).reshape(sizes)


def make_hybrid_mesh(dcn: Optional[Dict[str, int]] = None,
                     ici: Optional[Dict[str, int]] = None,
                     device_type: str = "cuda"):
    """A ``DeviceMesh`` over every rank, with the DCN (cross-host) axes
    outer and the ICI (within a host) axes inner; the sizes' product must
    equal the world size.  Every rank must call it.

    Examples::

        # frame-DP over every rank of every host
        make_hybrid_mesh(dcn={"data": dist.get_world_size()})
        # frames across hosts, one stream's time axis across a host's cards
        make_hybrid_mesh(dcn={"data": 2}, ici={"time": 4})
    """
    from torch.distributed.device_mesh import DeviceMesh

    names, ranks = _hybrid_ranks(dict(dcn or {}), dict(ici or {}),
                                 dist.get_world_size())
    return DeviceMesh(device_type, torch.as_tensor(ranks),
                      mesh_dim_names=names)


def local_block(arr, mesh, axes: Sequence[Optional[str]]):
    """This rank's block of a global array (numpy or torch) under ``mesh``:
    dimension d splits evenly over mesh axis ``axes[d]`` (None: not split)
    and the block at this rank's coordinate is kept.  Raises ValueError
    when a dimension does not divide by its axis size (a stream of T rows
    over a time axis of ntime tiles needs T % ntime == 0: pad the tail,
    see ``block_sp.decode_stream_sp``'s ``total_rows``)."""
    out = arr
    for dim, name in enumerate(axes):
        if name is None:
            continue
        size, idx = axis_size(mesh, name), mesh.get_local_rank(name)
        if out.shape[dim] % size:
            raise ValueError(f"dimension {dim} of length {out.shape[dim]} "
                             f"does not divide over the {size} ranks of "
                             f"axis {name!r}")
        blk = out.shape[dim] // size
        index = (slice(None),) * dim + (slice(idx * blk, (idx + 1) * blk),)
        out = out[index]
    return out


def spawn_fleet(make_cmd, num_processes: int, *, timeout: float = 600.0,
                success_token: Optional[str] = None,
                env: Optional[Dict[str, str]] = None) -> List[str]:
    """Spawn one local process per rank and wait for all; raises
    RuntimeError on any failure, with every rank's output.

    ``make_cmd(rank, init_method)`` returns rank ``rank``'s argv;
    ``init_method`` is a ``file://`` store in a fresh temporary directory,
    so fleets never collide on a port.  The ranks run from the repository
    root with it on ``PYTHONPATH``.  When a rank fails or the ``timeout``
    (seconds, for the whole fleet) passes, the other ranks are killed at
    once: they would wait forever on a collective the failed rank never
    joins.  ``success_token``, when given, must appear in at least one
    rank's output.  ``env`` adds variables to the ranks' environment
    (e.g. ``CUDA_VISIBLE_DEVICES`` to put every rank on one card).
    Returns the ranks' outputs (stdout and stderr)."""
    tmp = tempfile.mkdtemp(prefix="vdt_fleet_")
    init_method = "file://" + os.path.join(tmp, "store")
    env = {**os.environ, **(env or {})}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
            for r in range(num_processes)]
    procs = []
    try:
        for r in range(num_processes):
            procs.append(subprocess.Popen(
                make_cmd(r, init_method), cwd=ROOT, env=env,
                stdout=logs[r], stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        failed, timed_out = [], False
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c is not None for c in codes):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed or timed_out:
        what = (f"rank(s) {failed} failed" if failed
                else f"the fleet did not finish in {timeout} s")
        raise RuntimeError(f"{what}:\n" + "\n".join(
            f"--- rank {r} ---\n{o}" for r, o in enumerate(outs)))
    if success_token is not None and not any(success_token in o
                                             for o in outs):
        raise RuntimeError("no rank reported success:\n" + "\n".join(outs))
    return outs


def dryrun_worker(init_method: str, world_size: int, rank: int, *,
                  backend: Optional[str] = None,
                  device: str = "cuda") -> None:
    """One rank of the multi-process dryrun: joins the run and drives
    every cross-rank pattern of the layer (``frame_dp.dryrun``: frame-DP
    with one error sum, a data-parallel BER point, time-SP with its halo
    exchange, and the 2-D data x time mesh).  Rank 0 prints
    ``MULTIPROCESS OK`` on success."""
    from . import frame_dp

    dev = initialize(init_method, world_size, rank, backend=backend,
                     device=device)
    try:
        frame_dp.dryrun(world_size, device=dev)
        if rank == 0:
            print("MULTIPROCESS OK", flush=True)
    finally:
        dist.destroy_process_group()


def launch_processes(num_processes: int, *, timeout: float = 600.0,
                     backend: Optional[str] = None,
                     device: str = "cuda") -> None:
    """Spawn ``num_processes`` dryrun ranks on this machine and wait for
    all of them; raises on any failure.  ``backend`` as for
    :func:`initialize`."""
    def cmd(rank, init_method):
        return [sys.executable, "-m",
                "viterbidecodercpp_torch.parallel.launch",
                "--init-method", init_method,
                "--world-size", str(num_processes), "--rank", str(rank),
                "--device", device] + (["--backend", backend] if backend
                                       else [])

    spawn_fleet(cmd, num_processes, timeout=timeout,
                success_token="MULTIPROCESS OK")


def _main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="--spawn N runs a whole fleet on this machine; the other "
               "flags run one rank of a fleet started elsewhere")
    ap.add_argument("--spawn", type=int, default=0, metavar="N",
                    help="spawn N ranks here and wait for them")
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl on the card, gloo on the CPU")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="the ranks' device (default: the card)")
    args = ap.parse_args(argv)
    if args.spawn:
        launch_processes(args.spawn, backend=args.backend,
                         device=args.device)
        print(f"{args.spawn}-rank dryrun fleet OK", flush=True)
        return
    if None in (args.init_method, args.world_size, args.rank):
        ap.error("give --spawn N, or --init-method, --world-size and --rank")
    dryrun_worker(args.init_method, args.world_size, args.rank,
                  backend=args.backend, device=args.device)


if __name__ == "__main__":
    _main()
