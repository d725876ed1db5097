"""The collectives of the sharded train step and optimizer, over the
default group, with a tally.

Gloo takes only host tensors for an all-gather, so a card tensor is
staged through host memory there (a copy each way, a sync); under NCCL
the card's tensors go as they are. Every call adds to
:data:`COLLECTIVES`, by kind: calls and bytes handed in (this rank's
input), and the host seconds inside them; :func:`tally` reads it.

:func:`sum_over` sums a tensor over the ranks that differ from this one
only on some mesh dims, in a fixed order (an all-gather, then a sum in
rank order on every rank), so that every rank of the group, and every
group of ranks holding the same inputs, gets the same bits. A plain
all-reduce may give each rank its own rounding (DTensor's two
sequential all-reduces over a 2-axis-sharded tensor do), which would
let replicated leaves drift apart.

:class:`ModelShard` is a rank's place on the ``"model"`` axis in the
sharded serving steps (:mod:`repro_torch.models.zoo`), which are
tensor-parallel over it: a rank holds its ``"model"`` cut of the
parameters, and each layer computes on its cut (heads, MLP columns,
experts, SSM channels or heads, vocab rows), adds the partial sums of a
cut contraction with :meth:`ModelShard.reduce` (an all-reduce over the
mesh's ``"model"`` subgroup), gathers what needs every channel or head
(the sequence rule's softmax partials, Mamba2's B and C, the logits)
with :meth:`ModelShard.gather`, and works on its shard of a cache. What
is cut comes from the specs alone: the step that holds the parameters
names the held leaves that ``sharding.param_specs`` cuts over
``"model"`` (:attr:`ModelShard.held`), and a layer asks
:func:`cut_for` of a leaf. Where nothing is cut (one card, one
``"model"`` rank, or no shard) it runs the same code and reduces and
gathers nothing.

**Precision of the reduce.** The all-reduces run in float32 and the sum
is rounded once to the compute dtype: a rank computes its partial
product with a float32 result (a bfloat16 GEMM that accumulates and
writes float32 on a card, :func:`repro_torch.models.layers.wide_matmul`:
the products of two compute-dtype values are exact there, and the sum
accumulates in float32, as in one card's matmul), the ranks' partials
are added in float32, and the total is rounded once, where one card
rounds its matmul's output (:func:`repro_torch.models.layers.cut_matmul`).
So a bfloat16 step rounds as often as one card; its bits still differ
from one card's by the order of the float32 sums.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: the kinds of :data:`COLLECTIVES`, under ``step_cost``'s names
KINDS = ("all-gather", "all-reduce", "all-to-all")
COLLECTIVES = {**{k: {"count": 0, "bytes": 0} for k in KINDS},
               "seconds": 0.0}


def _staged(t: torch.Tensor, group=None) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _tally(t: torch.Tensor, t0: float, kind: str) -> None:
    n = t.numel() * t.element_size()
    # a host clock read around an eager collective: no device sync
    COLLECTIVES["seconds"] += time.perf_counter() - t0  # aqplint: disable=AQP101(eager host clock)
    COLLECTIVES[kind]["count"] += 1
    COLLECTIVES[kind]["bytes"] += n


def tally(since: Optional[Dict] = None) -> Dict:
    """:data:`COLLECTIVES` as ``{"calls", "bytes", "seconds", "by_kind"}``
    (calls and bytes summed over the kinds), less ``since`` (an earlier
    ``tally()``) where given."""
    by_kind = {k: {f: COLLECTIVES[k][f] - (since["by_kind"][k][f]
                                           if since else 0)
                   for f in ("count", "bytes")} for k in KINDS}
    return {"calls": sum(v["count"] for v in by_kind.values()),
            "bytes": sum(v["bytes"] for v in by_kind.values()),
            "seconds": COLLECTIVES["seconds"] - (since["seconds"]
                                                 if since else 0.0),
            "by_kind": by_kind}


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank), stacked in rank
    order: ``(world, *t.shape)`` on ``t``'s device."""
    t0 = time.perf_counter()  # aqplint: disable=AQP101(eager host clock)
    src = t.detach()
    src = (src.cpu() if _staged(t, group) else src).contiguous()
    outs = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, src, group=group)
    out = torch.stack(outs).to(t.device)
    _tally(src, t0, "all-gather")
    return out


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, in place (every rank gets
    the same bits: an all-reduce's result is one buffer, broadcast)."""
    t0 = time.perf_counter()  # aqplint: disable=AQP101(eager host clock)
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    _tally(t, t0, "all-reduce")
    return t


def all_to_all(t: torch.Tensor, in_splits: Sequence[int],
               out_splits: Sequence[int], group=None) -> torch.Tensor:
    """``t``'s rows cut by ``in_splits`` (rows for each rank of ``group``,
    in rank order) sent to those ranks; returns the rows received, by
    ``out_splits`` from each rank, in rank order."""
    t0 = time.perf_counter()
    src = t.detach()
    src = (src.cpu() if _staged(t, group) else src).contiguous()
    out = src.new_empty((sum(out_splits), *src.shape[1:]))
    dist.all_to_all_single(out, src, list(out_splits), list(in_splits),
                           group=group)
    _tally(src, t0, "all-to-all")
    return out.to(t.device)


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


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place in a sharded serving step: rank ``index`` of the
    ``count`` ranks of ``group`` (the mesh's ``"model"`` subgroup); a
    layer whose parameters are cut holds block ``index`` of the cut
    dim (:meth:`bounds`).
    ``cuts`` names the cache leaves that ``sharding.cache_specs`` cuts
    over them, each with the dim it cuts counted from the leaf's end
    (the attention's ``k`` / ``v``: -3 the sequence, -2 the kv heads).
    ``batch_groups`` are the subgroups of the dp axes that cut the
    batch, outermost first (an MoE layer whose dispatch groups span
    more rows than this rank's gathers its input over them).
    ``held`` names the held parameters that ``sharding.param_specs``
    cuts over the ranks (by ``id``; each with the cut dim counted from
    its end): a layer asks :func:`cut_for`."""
    index: int = 0
    count: int = 1
    group: object = None
    cuts: Mapping[str, int] = dataclasses.field(default_factory=dict)
    batch_groups: Tuple = ()
    held: Mapping[int, int] = dataclasses.field(default_factory=dict)

    def bounds(self, size: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of a dim of ``size`` cut in
        ``count`` equal parts."""
        n = size // self.count
        return self.index * n, (self.index + 1) * n

    def part(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's part of ``t`` along ``dim`` (a view)."""
        lo, hi = self.bounds(t.shape[dim])
        return t.narrow(dim, lo, hi - lo)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` of the group joined along ``dim`` in rank
        order: the whole of what :meth:`part` cut (one all-gather; ``t``
        itself on one rank)."""
        if self.count == 1:
            return t
        # a mesh subgroup of torch.distributed, not a JAX collective
        every = all_gather(t, group=self.group)  # aqplint: disable=AQP402(torch)
        return torch.cat(every.unbind(0), dim=dim)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group's ranks in float32 (one all-reduce;
        ``t`` in float32 on one rank): the partials of a contraction
        this rank holds a cut of, whose caller rounds the sum once (the
        module docstring)."""
        acc = t.to(torch.float32)
        if self.count == 1:
            return acc
        return all_reduce_sum(acc, group=self.group)

    def gather_batch(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s rows of every dp rank, in the global batch's order (an
        all-gather a dp axis, the innermost first)."""
        for g in reversed(self.batch_groups):
            # a mesh subgroup of torch.distributed, not a JAX collective
            every = all_gather(t, group=g)  # aqplint: disable=AQP402(torch)
            t = torch.cat(every.unbind(0), dim=0)
        return t


def cut_for(shard: Optional[ModelShard], w: torch.Tensor
            ) -> Optional[ModelShard]:
    """``shard`` where its step holds a ``"model"`` cut of parameter
    ``w`` (its spec cuts it over more than one rank), else ``None``:
    ``w`` is whole, as a layer with no shard holds it."""
    return shard if shard is not None and id(w) in shard.held else None
