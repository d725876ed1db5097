"""Python wrapper of the CUDA moment-fold kernel ``csrc/block_agg.cu``.

The Hopper counterpart of :func:`repro.kernels.block_agg.block_agg`: per
group, the masked count, the sums of ``v - c`` and ``(v - c)^2`` and the
masked min / max over the rows of the selected blocks. It reads the
``(nb, block_rows)`` slabs where they live and gathers the blocks named
by ``blk`` itself; ``tvalid`` zeroes the mask of padding lanes. Each
group's rows are summed in row order (a stable per-tile sort by bucket
of groups, then a walk with one lane a group, or one warp a group where
groups are large: two launches, no memset), so the result equals the
plain version on the CPU bit for bit.

This wrapper only launches: it takes CUDA tensors and raises on anything
else. :func:`repro_torch.kernels.ops.grouped_sums` chooses between it and
the plain version by the tensors' device. ``block_agg.launches`` counts
the launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

TILE_ROWS = 2048          # rows sorted by one CTA (kTile in the source)
LANE_MODE_ROWS = 64       # lane mode when rows / G is at most this
LANE_BUCKET = 32          # groups of a lane-mode bucket (one warp's)
TABLE_CELLS = 1 << 22     # (tile, bucket) cells of the start table per chunk


def _fail(msg: str, what: str = "block_agg"):
    raise ValueError(f"{what}: {msg}")


class FoldLaunch(NamedTuple):
    """The fold's checked inputs, scratch and outputs (:func:`prepare`)."""

    head: tuple         # launch arguments before ``center``: pointers to
                        # values, gids, mask, blk, tvalid; budget,
                        # block_rows, num_groups
    mode: tuple         # chunk_lanes, lane_mode
    scratch: torch.Tensor  # one chunk's sorted rows and start table
    keep: tuple         # int32 copies of blk / tvalid the pointers name
    out: torch.Tensor   # (5, G) float32: sums, vmin, vmax

    def args(self, center: float) -> tuple:
        """The launch arguments through ``vmax``."""
        base, g = self.out.data_ptr(), self.out.shape[1]
        return (*self.head, float(center), *self.mode, # aqplint: disable=AQP101(center is a Python number, a launch argument: no host sync)
                self.scratch.data_ptr(), base, base + 12 * g, base + 16 * g)

    @property
    def outs(self) -> tuple:
        """``(sums (3, G), vmin (1, G), vmax (1, G))``, views of ``out``."""
        return self.out[:3], self.out[3:4], self.out[4:]


def plan(budget: int, block_rows: int, num_groups: int):
    """The fold's variant and scratch for a call: ``(chunk_lanes,
    lane_mode, buckets, tiles)``. Lane mode (one lane a group, 32 groups
    a bucket) when the rows average at most :data:`LANE_MODE_ROWS` a
    group; else warp mode (one warp a group, a bucket a group). Lanes
    are folded in chunks so that the ``(tiles, buckets + 1)`` start table
    stays within :data:`TABLE_CELLS` entries."""
    lane_mode = budget * block_rows <= LANE_MODE_ROWS * num_groups
    buckets = -(-num_groups // LANE_BUCKET) if lane_mode else num_groups
    tiles_cap = max(1, TABLE_CELLS // (buckets + 1))
    chunk_lanes = max(1, min(budget, tiles_cap * TILE_ROWS // block_rows))
    tiles = -(-chunk_lanes * block_rows // TILE_ROWS)
    return chunk_lanes, int(lane_mode), buckets, tiles # aqplint: disable=AQP101(a Python bool from shapes: no host sync)


def scratch_bytes(buckets: int, tiles: int) -> int:
    """Bytes of one chunk's scratch: 8 bytes a row (value, effective
    mask) and 1 (the group's low bits), padded to 16, then the int16
    ``(tiles, buckets + 1)`` start table (``carve`` in the source)."""
    return (tiles * TILE_ROWS * 9 + 15) // 16 * 16 + tiles * (buckets + 1) * 2


def prepare(values: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
            blk: torch.Tensor, tvalid: torch.Tensor, num_groups: int,
            what: str = "block_agg") -> FoldLaunch:
    """Check the fold's inputs and allocate its outputs and scratch:
    shared by :func:`block_agg` and
    :func:`repro_torch.kernels.fused_fold.fused_fold`. A call runs on
    every round of a query, so the checks build no message unless one
    fails and the call allocates two tensors."""
    dev = values.device
    if dev.type != "cuda":
        _fail(f"needs CUDA tensors, got {dev}", what)
    if values.dim() != 2:
        _fail(f"values must be (nb, block_rows), got {tuple(values.shape)}",
              what)
    for name, t, dt in (("values", values, torch.float32),
                        ("gids", gids, torch.int32),
                        ("mask", mask, torch.float32)):
        if t.device != dev:
            _fail(f"{name} is on {t.device}, not {dev}", what)
        if t.dtype != dt:
            _fail(f"{name} must be {dt}, got {t.dtype}", what)
        if t.shape != values.shape:
            _fail(f"{name} has shape {tuple(t.shape)}, values "
                  f"{tuple(values.shape)}", what)
        if not t.is_contiguous():
            _fail(f"{name} must be contiguous", what)
    if values.numel() >= 2 ** 31:
        _fail(f"{values.numel()} slab rows do not fit an int32 index", what)
    if blk.dim() != 1 or tvalid.shape != blk.shape:
        _fail("blk and tvalid must be 1-D of one length", what)
    if blk.device != dev or tvalid.device != dev:
        _fail("blk and tvalid must be on the slabs' device", what)
    if num_groups < 1:
        _fail(f"num_groups must be >= 1, got {num_groups}", what)
    blk32 = blk if blk.dtype == torch.int32 else blk.to(torch.int32)
    tv32 = tvalid if tvalid.dtype == torch.int32 else tvalid.to(torch.int32)
    blk32, tv32 = blk32.contiguous(), tv32.contiguous()
    budget, block_rows = blk32.shape[0], values.shape[1]
    if budget * block_rows >= 2 ** 31:
        _fail(f"{budget} x {block_rows} rows do not fit an int32 row "
              "index", what)
    chunk_lanes, lane_mode, buckets, tiles = plan(budget, block_rows,
                                                  num_groups)
    scratch = torch.empty(scratch_bytes(buckets, tiles), dtype=torch.uint8,
                          device=dev)
    out = torch.empty((5, num_groups), dtype=torch.float32, device=dev)
    head = (values.data_ptr(), gids.data_ptr(), mask.data_ptr(),
            blk32.data_ptr(), tv32.data_ptr(), budget, block_rows,
            num_groups)
    return FoldLaunch(head, (chunk_lanes, lane_mode), scratch, (blk32, tv32),
                      out)


def traffic(values: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
            budget: int, num_groups: int):
    """``(read, written)`` bytes of one fold of ``budget`` blocks of the
    slabs: the selected blocks' rows of ``values``, ``gids`` and
    ``mask``, the int32 ``blk`` and ``tvalid`` lanes, and the ``(5, G)``
    float32 result."""
    row = sum(t.element_size() for t in (values, gids, mask))
    return budget * values.shape[-1] * row + budget * 8, 5 * num_groups * 4


def block_agg(values: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
              blk: torch.Tensor, tvalid: torch.Tensor, center: float,
              num_groups: int):
    """Fold the rows of blocks ``blk`` of the slabs.

    Args:
      values: ``(nb, block_rows)`` float32 on a CUDA device.
      gids: ``(nb, block_rows)`` int32 group codes in ``[0, num_groups)``.
      mask: ``(nb, block_rows)`` float32 predicate*valid mask.
      blk: ``(budget,)`` int32 block ids into the slabs, in fold order.
      tvalid: ``(budget,)`` int32 (or bool) lane flags; a false lane's
        rows are folded with mask 0.
      center: the centering constant ``c`` (rounded to float32).
      num_groups: G.

    Returns ``(sums (3, G), vmin (1, G), vmax (1, G))`` float32, equal
    bit for bit to :func:`repro_torch.kernels.ref.block_agg_ref` on the
    gathered rows computed on the CPU.
    """
    fl = prepare(values, gids, mask, blk, tvalid, num_groups)
    dev = values.device
    rc = _build.library().repro_block_agg(
        *fl.args(center), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "block_agg launch")
    block_agg.launches += 1
    _build.report("block_agg", *traffic(values, gids, mask, blk.shape[0],
                                        num_groups))
    return fl.outs


block_agg.launches = 0
