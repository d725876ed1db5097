"""Python wrapper of the CUDA histogram kernel ``csrc/grouped_hist.cu``.

The Hopper counterpart of :func:`repro.kernels.hist.grouped_hist`: per
group, the count of masked rows in each bin of the uniform ``nbins``-bin
grid over ``[a, b]`` (bins on the LOGICAL grid, NaN in bin 0:
:func:`repro_torch.kernels.ref.hist_bins_ref`), over flat rows. Rows are
counted with integer adds, so the result is the same on every run and
equal to the plain version's bit for bit.

:func:`plan` mirrors the source's launch plan (``grouped_hist_plan``):
the regime that the cell space ``G * nbins`` picks, the launches, their
CTAs and shared memory, and the scratch a call needs.

This wrapper only launches: it takes CUDA tensors and raises on anything
else. :func:`repro_torch.kernels.ops.grouped_hist` chooses between it and
the plain version by the tensors' device. ``grouped_hist.launches`` counts
the calls that launched the kernel.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

# The source's constants (csrc/grouped_hist.cu)
THREADS = 1024          # kThreads: the private and the sort kernels' CTA
BUCKET_THREADS = 512    # kBucketThreads: a bucket CTA, two an SM
CLUSTER = 2             # kCluster: private CTAs that pool their copies
STAGE_ROWS = 4096       # kStageRows: rows a CTA loads at once, a sort tile
MAX_CELLS = 57344       # kMaxCells: 224 KB of uint32 counters a CTA
TARGET_BUCKETS = 256    # kTargetBuckets
CHUNK_TILES = 256       # kChunkTiles: tiles a bucket CTA reads at a time
SMEM_PER_CTA = 232448   # the 227 KB of shared memory a CTA may take
H100_SMS = 132


class HistPlan(NamedTuple):
    """One call's launches. ``count`` is the launch that counts in shared
    memory and writes the histogram, ``sort`` the bucketed regime's
    first launch (none for ``n = 0``); ``*_smem`` is dynamic shared
    memory in bytes."""
    regime: str          # "private" or "bucketed"
    launches: int
    count_ctas: int
    count_smem: int
    sort_ctas: int
    sort_smem: int
    bucket_cells: int    # the cells one counting CTA owns
    scratch_bytes: int


def _round4(v: int) -> int:
    return -(-v // 4) * 4


def plan(n: int, num_groups: int, nbins: int,
         resident: int = H100_SMS) -> HistPlan:
    """The source's plan for ``n`` rows, ``num_groups`` groups and
    ``nbins`` bins on a card that holds ``resident`` private CTAs at once
    (one an SM: 132 on an H100). Up to :data:`MAX_CELLS` cells, the
    private regime: one launch, a CTA an SM (fewer for few rows; whole
    clusters of :data:`CLUSTER`), each counting a share of the rows into
    its own copy of every cell, the scratch the per-(device, stream)
    counters. Above, the
    bucketed regime: the sort (a CTA a tile of :data:`STAGE_ROWS` rows)
    then a CTA a bucket of at most :data:`MAX_CELLS` consecutive cells,
    about :data:`TARGET_BUCKETS` of them; the scratch holds 2 bytes a row
    and the (buckets + 1, tiles) start table."""
    if num_groups * nbins <= MAX_CELLS:
        return private_plan(n, num_groups, nbins, resident)
    return bucketed_plan(n, num_groups, nbins)


def private_plan(n: int, num_groups: int, nbins: int,
                 resident: int = H100_SMS) -> HistPlan:
    """:func:`plan`'s private regime (any cell space up to
    :data:`MAX_CELLS`)."""
    cells = num_groups * nbins
    stages = max(1, -(-n // STAGE_ROWS))
    ctas = min(resident // CLUSTER, -(-stages // CLUSTER)) * CLUSTER
    return HistPlan("private", 1, ctas, _round4(cells) * 4, 0, 0, cells,
                    (MAX_CELLS + 4) * 4)


def bucketed_plan(n: int, num_groups: int, nbins: int) -> HistPlan:
    """:func:`plan`'s bucketed regime (any cell space)."""
    cells = num_groups * nbins
    stages = -(-n // STAGE_ROWS)
    bucket_cells = min(MAX_CELLS, _round4(-(-cells // TARGET_BUCKETS)))
    buckets = -(-cells // bucket_cells)
    scratch = stages * STAGE_ROWS * 2 + (buckets + 1) * stages * 2
    return HistPlan("bucketed", 2 if stages else 1, buckets,
                    _round4(bucket_cells) * 4, stages, buckets * 4,
                    bucket_cells, -(-scratch // 16) * 16)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"grouped_hist: {msg}")


# The private regime's uint32 counters and grid-barrier words per
# (device, stream), zeroed once: each call leaves them as it found them
# on the card, so no call resets them and a captured CUDA graph replays
# right.
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _private_counters(dev: torch.device, stream: int) -> torch.Tensor:
    buf = _counters.get((dev.index, stream))
    if buf is None:
        buf = torch.zeros(MAX_CELLS + 4, dtype=torch.int32, device=dev)
        _counters[(dev.index, stream)] = buf
    return buf


def traffic(values: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
            num_groups: int, nbins: int):
    """``(read, written)`` bytes: every row of ``values``, ``gids`` and
    ``mask`` read, the ``(G, nbins)`` float32 histogram written."""
    return (sum(t.numel() * t.element_size() for t in (values, gids, mask)),
            num_groups * nbins * 4)


def grouped_hist(values: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
                 a: float, b: float, num_groups: int,
                 nbins: int) -> torch.Tensor:
    """Histogram of flat rows.

    Args:
      values: float32 rows on a CUDA device (any shape; read flat).
      gids: int32 group codes of the same shape; rows outside
        ``[0, num_groups)`` count nowhere.
      mask: float32 0 / 1 mask of the same shape; a row with ``m != 0``
        counts once.
      a, b: the grid's range; ``nbins`` its bin count.
      num_groups: G.

    Returns ``(num_groups, nbins)`` float32 counts: one launch at most
    :data:`MAX_CELLS` cells, two above (:func:`plan`)."""
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
    n = values.numel()
    p = plan(n, num_groups, nbins)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if p.regime == "private":
        scratch = _private_counters(dev, stream)
    else:
        scratch = torch.empty(p.scratch_bytes, dtype=torch.uint8, device=dev)
    hist = torch.empty((num_groups, nbins), dtype=torch.float32, device=dev)
    inv_width = float(nbins) / max(float(b) - float(a), 1e-30)
    rc = _build.library().repro_grouped_hist(
        values.data_ptr(), gids.data_ptr(), mask.data_ptr(), n, num_groups,
        nbins, float(a), inv_width, hist.data_ptr(), scratch.data_ptr(),
        p.scratch_bytes, dev.index, stream)
    _build.check(rc, "grouped_hist launch")
    grouped_hist.launches += 1
    _build.report("grouped_hist", *traffic(values, gids, mask, num_groups,
                                           nbins))
    return hist


grouped_hist.launches = 0
