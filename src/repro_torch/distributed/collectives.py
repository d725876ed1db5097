"""The collectives of the sharded train step and optimizer, over the
default group, with a tally.

Gloo takes only host tensors for an all-gather, so a card tensor is
staged through host memory there (a copy each way, a sync); under NCCL
the card's tensors go as they are. Every call adds to
:data:`COLLECTIVES`: calls, bytes handed in (this rank's input) and the
host seconds inside it.

:func:`sum_over` sums a tensor over the ranks that differ from this one
only on some mesh dims, in a fixed order (an all-gather, then a sum in
rank order on every rank), so that every rank of the group, and every
group of ranks holding the same inputs, gets the same bits. A plain
all-reduce may give each rank its own rounding (DTensor's two
sequential all-reduces over a 2-axis-sharded tensor do), which would
let replicated leaves drift apart.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch
import torch.distributed as dist

COLLECTIVES = {"calls": 0, "bytes": 0, "seconds": 0.0}


def _staged(t: torch.Tensor, group=None) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _tally(t: torch.Tensor, t0: float) -> None:
    COLLECTIVES["seconds"] += time.perf_counter() - t0
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += t.numel() * t.element_size()


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank), stacked in rank
    order: ``(world, *t.shape)`` on ``t``'s device."""
    t0 = time.perf_counter()
    src = t.detach()
    src = (src.cpu() if _staged(t, group) else src).contiguous()
    outs = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, src, group=group)
    out = torch.stack(outs).to(t.device)
    _tally(src, t0)
    return out


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, in place (every rank gets
    the same bits: an all-reduce's result is one buffer, broadcast)."""
    t0 = time.perf_counter()
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    _tally(t, t0)
    return t


def group_ranks(mesh, mesh_dims: Sequence[int]) -> list:
    """The global ranks that share this rank's mesh coordinate on every
    dim but ``mesh_dims``, in row-major order of the mesh."""
    coord = mesh.get_coordinate()
    idx = tuple(slice(None) if k in mesh_dims else c
                for k, c in enumerate(coord))
    return [int(r) for r in mesh.mesh[idx].reshape(-1).tolist()]


def sum_over(t: torch.Tensor, mesh, mesh_dims: Sequence[int]
             ) -> torch.Tensor:
    """``t`` summed over the ranks that differ from this one only on
    ``mesh_dims`` (indices of ``mesh``'s dims), in their rank order: the
    same bits on each of them. ``mesh`` spans the default group."""
    if not mesh_dims:
        return t
    # torch.distributed over the default group, not a JAX mesh collective
    every = all_gather(t)  # aqplint: disable=AQP401(torch), AQP402(torch)
    ranks = group_ranks(mesh, mesh_dims)
    out = every[ranks[0]].clone()
    for r in ranks[1:]:
        out += every[r]
    return out
