"""Python wrapper of the CUDA fused fold ``csrc/fused_fold.cu``.

The Hopper counterpart of :func:`repro.kernels.fused_scan.fused_fold`:
the moments and extremes of :mod:`.block_agg` plus the per-group DKW
histogram of the same rows, in one pass over the selected blocks of the
``(nb, block_rows)`` slabs. The moments are bit for bit those of
``block_agg`` (the same row-order walk); the walk's CTAs count their
groups' rows with integer adds in shared memory and write each
histogram cell once (the source sizes their counters from ``nbins``,
cutting the bins into slices where they do not fit), so the
histogram is the same on every run and equal to the plain version's.
Bins are on the LOGICAL ``nbins``-bin grid over ``[a, b]``
(:func:`repro_torch.kernels.ref.hist_bins_ref`).

This wrapper only launches: it takes CUDA tensors and raises on anything
else. :func:`repro_torch.kernels.ops.grouped_fold_hist` chooses between
it and the plain version by the tensors' device.
``fused_fold.launches`` counts the launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import block_agg as _block_agg
from repro_torch.kernels.block_agg import _fail, prepare


def traffic(values: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
            budget: int, num_groups: int, nbins: int):
    """``(read, written)`` bytes: :func:`repro_torch.kernels.block_agg.
    traffic`'s and the ``(G, nbins)`` float32 histogram written."""
    read, written = _block_agg.traffic(values, gids, mask, budget,
                                       num_groups)
    return read, written + num_groups * nbins * 4


def fused_fold(values: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
               blk: torch.Tensor, tvalid: torch.Tensor, center: float,
               a: float, b: float, num_groups: int, nbins: int):
    """Fold the rows of blocks ``blk`` of the slabs into moments and a
    histogram.

    Args as :func:`repro_torch.kernels.block_agg.block_agg` (the mask
    must be 0 or 1: a row with ``m != 0`` counts once in the histogram),
    plus the histogram grid: ``nbins`` bins over ``[a, b]``.

    Returns ``(sums (3, G), vmin (1, G), vmax (1, G), hist (G, nbins))``
    float32, equal bit for bit to
    :func:`repro_torch.kernels.ref.fused_fold_ref` on the CPU.
    """
    what = "fused_fold"
    if nbins < 1:
        _fail(f"nbins must be >= 1, got {nbins}", what)
    if num_groups * nbins >= 2 ** 31:
        _fail(f"G * nbins = {num_groups * nbins} does not fit the int32 "
              "cell index", what)
    fl = prepare(values, gids, mask, blk, tvalid, num_groups, what)
    dev = values.device
    hist = torch.empty((num_groups, nbins), dtype=torch.float32, device=dev)
    inv_width = float(nbins) / max(float(b) - float(a), 1e-30) # aqplint: disable=AQP101(the grid's Python numbers: no host sync)
    rc = _build.library().repro_fused_fold(
        *fl.args(center), hist.data_ptr(), nbins, float(a), inv_width, # aqplint: disable=AQP101(a Python number, a launch argument: no host sync)
        dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fused_fold launch")
    fused_fold.launches += 1
    _build.report("fused_fold", *traffic(values, gids, mask, blk.shape[0],
                                         num_groups, nbins))
    return (*fl.outs, hist)


fused_fold.launches = 0
