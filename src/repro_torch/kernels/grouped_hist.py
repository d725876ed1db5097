"""Python wrapper of the CUDA histogram kernel ``csrc/grouped_hist.cu``.

The Hopper counterpart of :func:`repro.kernels.hist.grouped_hist`: per
group, the count of masked rows in each bin of the uniform ``nbins``-bin
grid over ``[a, b]`` (bins on the LOGICAL grid, NaN in bin 0:
:func:`repro_torch.kernels.ref.hist_bins_ref`), over flat rows. Rows are
counted with integer atomics, so the result is the same on every run and
equal to the plain version's bit for bit.

This wrapper only launches: it takes CUDA tensors and raises on anything
else. :func:`repro_torch.kernels.ops.grouped_hist` chooses between it and
the plain version by the tensors' device. ``grouped_hist.launches`` counts
the launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"grouped_hist: {msg}")


def grouped_hist(values: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
                 a: float, b: float, num_groups: int,
                 nbins: int) -> torch.Tensor:
    """Histogram of flat rows.

    Args:
      values: float32 rows on a CUDA device (any shape; read flat).
      gids: int32 group codes of the same shape, in ``[0, num_groups)``.
      mask: float32 0 / 1 mask of the same shape; a row with ``m != 0``
        counts once.
      a, b: the grid's range; ``nbins`` its bin count.
      num_groups: G.

    Returns ``(num_groups, nbins)`` float32 counts.
    """
    dev = values.device
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    for name, t, dt in (("values", values, torch.float32),
                        ("gids", gids, torch.int32),
                        ("mask", mask, torch.float32)):
        _require(t.device == dev, f"{name} is on {t.device}, not {dev}")
        _require(t.dtype == dt, f"{name} must be {dt}, got {t.dtype}")
        _require(t.shape == values.shape, f"{name} has shape "
                 f"{tuple(t.shape)}, values {tuple(values.shape)}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(num_groups >= 1 and nbins >= 1, f"num_groups and nbins must "
             f"be >= 1, got {num_groups}, {nbins}")
    _require(num_groups * nbins < 2 ** 31, f"G * nbins = "
             f"{num_groups * nbins} does not fit the int32 cell index")
    hist = torch.empty((num_groups, nbins), dtype=torch.float32, device=dev)
    inv_width = float(nbins) / max(float(b) - float(a), 1e-30)
    rc = _build.library().repro_grouped_hist(
        values.data_ptr(), gids.data_ptr(), mask.data_ptr(), values.numel(),
        num_groups, nbins, float(a), inv_width, hist.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "grouped_hist launch")
    grouped_hist.launches += 1
    return hist


grouped_hist.launches = 0
