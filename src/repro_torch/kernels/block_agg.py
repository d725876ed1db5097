"""Python wrapper of the CUDA moment-fold kernel ``csrc/block_agg.cu``.

The Hopper counterpart of :func:`repro.kernels.block_agg.block_agg`: per
group, the masked count, the sums of ``v - c`` and ``(v - c)^2`` and the
masked min / max over the rows of the selected blocks. It reads the
``(nb, block_rows)`` slabs where they live and gathers the blocks named
by ``blk`` itself; ``tvalid`` zeroes the mask of padding lanes. Each
group's rows are summed in row order (a per-tile sort by group, then one
walk per group), so the result equals the plain version on the CPU bit
for bit.

This wrapper only launches: it takes CUDA tensors and raises on anything
else. :func:`repro_torch.kernels.ops.grouped_sums` chooses between it and
the plain version by the tensors' device. ``block_agg.launches`` counts
the launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

TILE_ROWS = 1024          # rows sorted by one CTA (kTile in the source)
TABLE_CELLS = 1 << 22     # (group, tile) cells of the run table per chunk


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"block_agg: {msg}")


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
    dev = values.device
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    _require(values.dim() == 2, f"values must be (nb, block_rows), got "
             f"{tuple(values.shape)}")
    for name, t, dt in (("values", values, torch.float32),
                        ("gids", gids, torch.int32),
                        ("mask", mask, torch.float32)):
        _require(t.device == dev, f"{name} is on {t.device}, not {dev}")
        _require(t.dtype == dt, f"{name} must be {dt}, got {t.dtype}")
        _require(t.shape == values.shape, f"{name} has shape "
                 f"{tuple(t.shape)}, values {tuple(values.shape)}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(blk.dim() == 1 and tvalid.shape == blk.shape,
             "blk and tvalid must be 1-D of one length")
    _require(blk.device == dev and tvalid.device == dev,
             "blk and tvalid must be on the slabs' device")
    _require(num_groups >= 1, f"num_groups must be >= 1, got {num_groups}")
    blk32 = blk.to(torch.int32).contiguous()
    tv32 = tvalid.to(torch.int32).contiguous()
    budget, block_rows = blk32.shape[0], values.shape[1]
    # lanes folded per launch pair, so the (2, G, tiles) run table stays
    # within TABLE_CELLS; the walk carries the sums across chunks in order
    tiles_cap = max(1, TABLE_CELLS // num_groups)
    chunk_lanes = max(1, min(budget, tiles_cap * TILE_ROWS // block_rows))
    tiles = -(-chunk_lanes * block_rows // TILE_ROWS)
    part = torch.empty((tiles * TILE_ROWS, 4), dtype=torch.float32,
                       device=dev)
    table = torch.empty((2, num_groups, tiles), dtype=torch.int32,
                        device=dev)
    sums = torch.empty((3, num_groups), dtype=torch.float32, device=dev)
    vmin = torch.empty((1, num_groups), dtype=torch.float32, device=dev)
    vmax = torch.empty((1, num_groups), dtype=torch.float32, device=dev)
    rc = _build.library().repro_block_agg(
        values.data_ptr(), gids.data_ptr(), mask.data_ptr(),
        blk32.data_ptr(), tv32.data_ptr(), budget, block_rows, num_groups,
        float(center), chunk_lanes, part.data_ptr(), table.data_ptr(),
        sums.data_ptr(), vmin.data_ptr(), vmax.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "block_agg launch")
    block_agg.launches += 1
    return sums, vmin, vmax


block_agg.launches = 0
