"""Mesh construction (the port of the JAX package's ``parallel/mesh.py``).

A torch rank is one process on one device, so a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks of an initialised
process group; its named axes are ``"data"`` (frames) and ``"time"`` (one
stream's tiles), as in the JAX package.

The JAX module's ``pvary`` has no counterpart: it marks per-shard
constants as varying over a mesh axis for JAX's varying-axis typing
inside ``shard_map``.  A torch rank runs plain eager code on its own
tensors, so there is no such typing to satisfy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "axis_size", "all_reduce", "shift"]


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over the first prod(axis_sizes) ranks of the initialised
    default process group, in rank order (the last axis varies fastest).
    Every rank of the group must call it; a rank past the mesh gets a
    mesh whose ``get_coordinate()`` is None."""
    if len(axis_sizes) != len(axis_names) or not axis_sizes:
        raise ValueError(f"give one size per axis name, got {axis_sizes} "
                         f"and {axis_names}")
    n = int(np.prod(axis_sizes))
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    ranks = torch.arange(n).reshape(*axis_sizes)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of axis ``name`` (``DeviceMesh.size`` takes a dimension
    index only)."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"the mesh has no {name!r} axis (axes {names})")
    return mesh.mesh.shape[names.index(name)]


# -- collectives over one axis (lax.psum and lax.ppermute) -----------------

def _wire(group, x: torch.Tensor) -> torch.device:
    """Where ``x`` travels: gloo moves only CPU tensors point to point, so
    with gloo a card's tensors are staged through host memory (a chosen
    backend for ranks that share a card: NCCL refuses two ranks on one
    GPU); NCCL and CPU tensors go as they are."""
    if x.device.type != "cpu" and dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return x.device


def all_reduce(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``x`` reduced by ``op`` over the ranks of ``group`` (the default
    group for None), a new tensor on ``x``'s device: one ``all_reduce``
    (with SUM, ``lax.psum``).  Without an initialised process group it is
    ``x`` itself."""
    if group is None and not dist.is_initialized():
        return x
    buf = x.to(_wire(group, x), copy=True)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def shift(x: torch.Tensor, group, step: int):
    """Send ``x`` to the rank ``step`` places further along ``group`` and
    receive the tensor of the rank ``step`` places back, in one
    ``batch_isend_irecv``: ``lax.ppermute`` with the pairs (i, i + step).
    Every rank of the group sends a tensor of ``x``'s shape and dtype.
    Returns what arrived, on ``x``'s device, or None on a rank with no
    source (where ppermute would give zeros)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    wire = _wire(group, x)
    ops, recv = [], None
    if 0 <= i + step < n:
        ops.append(dist.P2POp(dist.isend, x.to(wire).contiguous(),
                              ranks[i + step], group))
    if 0 <= i - step < n:
        # the receive writes every element
        recv = torch.empty(x.shape, dtype=x.dtype, device=wire)
        ops.append(dist.P2POp(dist.irecv, recv, ranks[i - step], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return None if recv is None else recv.to(x.device)
