"""The shard layout of the divided scan, over a ``torch.distributed`` group.

The port of :mod:`repro.aqp.distributed`. The reference divides the scan
over a JAX device mesh from one controller (``shard_map``); the port runs
it as torch runs a job over several devices: one process a device (a
*rank* of the caller's process group), every rank running the same
``FastFrame.run`` or ``FrameServer`` call on the same scramble and ending
with the same, replicated result. Shard ``d`` is rank ``d``; ``n_shards``
is the group's size. The *computation* of the sharded scan lives in
:mod:`repro_torch.kernels.fused_scan` (the round loops, with the fold's
merge across ranks in :func:`~repro_torch.kernels.fused_scan.
merge_across_shards`). What lives here is what the engine needs to feed
that path:

  * :func:`make_aqp_mesh` — the layout's ranks, resolved from the
    initialized default group (``None`` without a group of >= 2 ranks);
  * :class:`BlockShards` — the divided-scan layout: the *within-block
    row axis* of every ``(nb, block_rows)`` column slab is split into
    ``n_shards`` equal row slices (zero-padded so ``block_rows`` divides
    evenly), the block axis whole on every rank; ``put_blocks`` puts
    this rank's slice of a slab on the frame's device, ``put_replicated``
    a whole array;
  * :func:`make_sharded_fold` — the standalone one-round collective fold
    (this rank's :func:`repro_torch.kernels.ops.grouped_sums`, the merge
    across ranks, :func:`~repro_torch.kernels.ops.moments_from_sums`),
    bit for bit the single-device :func:`~repro_torch.kernels.ops.
    grouped_moments` on exactly representable data.

The layout's invariants are the reference's: every rank sees the whole
block axis, so selection, the cursor, the accounting and the bound math
run on replicated inputs, and the round loop on a rank is the unsharded
one applied to its ``block_rows / n_shards`` row slice of every block;
rows within a block are exchangeable (the scramble shuffles rows into
blocks), so a row slice is as uniform a sample as the block; padding
rows carry ``mask == 0`` / ``values == 0`` / ``gids == 0`` and fold to
exact zeros; what crosses ranks a merge is O(groups) numbers (raw moment
sums, extremes, the histogram when one is folded), and at ``merge_every
= K`` nothing crosses between merges.

The group is the caller's: this module never calls
``init_process_group`` and never picks a backend. Under gloo the
collectives take the card's tensors by staging them through host memory
(so a chunk of rounds is enqueued, not captured); under NCCL a chunk is
captured as one CUDA graph, collectives included.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import fused_scan as kfused
from repro_torch.kernels import ops as kops

__all__ = ["AqpMesh", "BlockShards", "agree_max", "build_block_shards",
           "make_aqp_mesh", "make_sharded_fold", "shard_rows", "world"]


class AqpMesh(NamedTuple):
    """The ranks the scan is divided over: ``group`` (None: the default
    group), its ``shape`` (a multi-axis shape only orders the ranks,
    flattened, as the reference flattens its mesh axes), this process's
    shard index ``rank`` and the group's ``backend``."""

    group: object
    shape: Tuple[int, ...]
    n_shards: int
    rank: int
    backend: str


def world() -> Tuple[int, int]:
    """``(world size, rank)`` of the initialized default group, ``(1,
    0)`` when there is none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_aqp_mesh(mesh_shape: Optional[Tuple[int, ...]] = None
                  ) -> Optional[AqpMesh]:
    """The layout's ranks, from the initialized default group.

    ``mesh_shape=None`` takes every rank as a 1-D layout; an explicit
    shape (e.g. ``EngineConfig.mesh_shape=(2, 2)``) must hold exactly the
    group's ranks and only orders them (flattened: shard ``d`` is rank
    ``d``). Returns ``None`` when there is no group or it has one rank
    (sharding would be pure overhead).

    Raises:
        ValueError: when ``mesh_shape`` asks for another number of ranks
            than the group has. (The reference may take a mesh smaller
            than its devices; one process a device has no such subset.)
    """
    n, rank = world()
    if mesh_shape is None:
        if n < 2:
            return None
        shape = (n,)
    else:
        shape = tuple(int(x) for x in mesh_shape)
        if math.prod(shape) != n:
            raise ValueError(
                f"EngineConfig.mesh_shape={shape} needs {math.prod(shape)} "
                f"devices (one rank each), but the process group has {n} "
                "(start one process a device and initialize the default "
                "group, e.g. with torchrun, before building the frame)")
        if n == 1:
            return None
    return AqpMesh(group=None, shape=shape, n_shards=n, rank=rank,
                   backend=dist.get_backend())


@dataclasses.dataclass(frozen=True)
class BlockShards:
    """Divided-scan layout of a scramble's column slabs over the ranks.

    The within-block row axis (axis 1 of every ``(nb, block_rows, ...)``
    slab) is split into ``n_shards`` equal slices of ``shard_rows`` rows
    each; ``block_rows`` is zero-padded up to ``n_shards * shard_rows``
    so every rank holds an equal-shape slab (padding rows carry ``mask ==
    0`` and fold to exact zeros). The block axis is whole on every rank,
    so selection and the cursor need no per-shard translation. ``device``
    is the frame's (this rank's card, or the CPU)."""

    mesh: AqpMesh
    nb: int               # global block count (whole on every shard)
    block_rows: int       # real rows per block
    n_shards: int
    shard_rows: int       # padded per-shard rows per block
    merge_every: int = 1  # collective cadence K (1 = merge every round)
    device: torch.device = torch.device("cpu")

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def backend(self) -> str:
        return self.mesh.backend

    @property
    def padded_block_rows(self) -> int:
        return self.n_shards * self.shard_rows

    @property
    def info(self) -> kfused.ShardInfo:
        """The kernel-layer view of this layout."""
        return kfused.ShardInfo(group=self.mesh.group,
                                n_shards=self.n_shards, rank=self.rank,
                                shard_rows=self.shard_rows,
                                merge_every=self.merge_every)

    def pad_rows(self, arr: np.ndarray) -> np.ndarray:
        """Zero-pad a ``(nb, block_rows, ...)`` slab's row axis to
        ``padded_block_rows`` (the reference's layout API, which the
        tests hold the layout to; the engine pads with
        :meth:`local_rows`, one rank's slice at a time)."""
        pad = self.padded_block_rows - arr.shape[1]
        if pad == 0:
            return arr
        widths = [(0, 0), (0, pad)] + [(0, 0)] * (arr.ndim - 2)
        return np.pad(arr, widths)

    def local_rows(self, arr: np.ndarray) -> np.ndarray:
        """This rank's ``[rank * shard_rows, (rank + 1) * shard_rows)``
        row slice of every block of a slab, zero-padded past
        ``block_rows`` (only the last ranks' slices reach the padding)."""
        lo = self.rank * self.shard_rows
        hi = lo + self.shard_rows
        part = np.asarray(arr)[:, lo:min(hi, arr.shape[1])]
        pad = self.shard_rows - part.shape[1]
        if pad:
            widths = [(0, 0), (0, pad)] + [(0, 0)] * (part.ndim - 2)
            part = np.pad(part, widths)
        return part

    def put_blocks(self, arr) -> torch.Tensor:
        """This rank's row slice of every block of a slab, on the
        frame's device (a ``(nb, shard_rows, ...)`` tensor)."""
        return torch.from_numpy(np.ascontiguousarray(
            self.local_rows(np.asarray(arr)))).to(self.device)

    def put_replicated(self, arr) -> torch.Tensor:
        """A whole array on the frame's device (every rank holds it; the
        reference's layout API: the engine's replicated buffers go
        through ``FastFrame._put``, to the same device)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)


def build_block_shards(nb: int, mesh: Optional[AqpMesh], block_rows: int,
                       merge_every: int = 1,
                       device=torch.device("cpu")
                       ) -> Optional[BlockShards]:
    """Divided-scan layout of ``nb`` scramble blocks of ``block_rows``
    rows each over ``mesh`` (None passes through: single-device frames
    carry no shard layout). ``merge_every`` is the collective cadence
    the sharded round loops run at (``EngineConfig.merge_every``; 1 =
    the per-round-merge oracle path)."""
    if mesh is None:
        return None
    if merge_every < 1:
        raise ValueError(
            f"merge_every must be >= 1, got {merge_every} (1 merges the "
            "shard folds every round; K > 1 amortizes the collective "
            "over K rounds)")
    n_shards = mesh.n_shards
    return BlockShards(mesh=mesh, nb=nb, block_rows=block_rows,
                       n_shards=n_shards,
                       shard_rows=-(-block_rows // n_shards),
                       merge_every=merge_every,
                       device=torch.device(device))


def make_sharded_fold(group, num_groups: int, center: float,
                      with_hist: bool = False, hist_bins: int = 1024,
                      hist_range: Tuple[float, float] = (0.0, 1.0)):
    """The one-round collective fold over the ranks of ``group`` (None:
    the default group), standalone.

    Returns ``fold(values, gids, mask)``: each rank folds its own rows
    (1-D, or ``(nb, rows)`` slabs) with
    :func:`repro_torch.kernels.ops.grouped_sums` (the raw additive
    ``(count, dsum, dsq)`` about ``center``) and, ``with_hist``, their
    ``(num_groups, hist_bins)`` histogram over ``hist_range``
    (:func:`~repro_torch.kernels.ops.grouped_hist`); the sums and the
    histogram cross ranks in one SUM ``all_reduce``, the extremes in one
    MIN (:func:`~repro_torch.kernels.fused_scan.merge_across_shards`),
    before the shifted-moment conversion. This is the merge the sharded
    round loop performs every round; on exactly representable data it
    equals the single-device :func:`~repro_torch.kernels.ops.
    grouped_moments` bit for bit. Returns the replicated merged
    :class:`~repro_torch.core.state.MomentState` (and the merged
    histogram ``with_hist``). Nothing in it reads the device on the host,
    so under NCCL a call can be captured in a CUDA graph."""
    info = kfused.ShardInfo(group=group, n_shards=0, rank=0, shard_rows=0)

    def fold(values, gids, mask):
        sums, vmin, vmax = kops.grouped_sums(values, gids, mask,
                                             num_groups, center)
        hist = None
        if with_hist:
            hist = kops.grouped_hist(values, gids, mask, num_groups,
                                     hist_range[0], hist_range[1],
                                     nbins=hist_bins).hist
        ((sums, vmin, vmax, hist),) = kfused.merge_across_shards(
            info, [(sums, vmin, vmax, hist)])
        out = kops.moments_from_sums(sums, vmin, vmax, center)
        return out if not with_hist else (out, hist)

    return fold


def shard_rows(group, *arrays):
    """This rank's equal slice of each array's leading axis (the
    counterpart of the reference's placement of row-major arrays sharded
    over the mesh, for :func:`make_sharded_fold`'s callers; the round
    loops slice blocks with :meth:`BlockShards.put_blocks`); the
    leading axis must divide by the group's size."""
    n, rank = (dist.get_world_size(group), dist.get_rank(group))
    out = []
    for a in arrays:
        if a.shape[0] % n:
            raise ValueError(f"{a.shape[0]} rows do not divide over {n} "
                             "ranks")
        m = a.shape[0] // n
        out.append(a[rank * m:(rank + 1) * m])
    return tuple(out)


def agree_max(group, code: int, device=None) -> int:
    """The largest of every rank's ``code``, on every rank (one MAX
    ``all_reduce`` of an int64 on ``device``: the card's under NCCL,
    the host's under gloo). The serving scheduler agrees on a fault
    with it, so every rank takes the same rung of its ladder."""
    if dist.get_backend(group) != "nccl":
        device = torch.device("cpu")
    t = torch.tensor([int(code)], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())
