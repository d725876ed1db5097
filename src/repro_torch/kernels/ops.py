"""Public kernel entry points of the port, dispatching on the device.

The port of :mod:`repro.kernels.ops`. Where the JAX package picks a
backend with ``impl=`` (Pallas, interpreter or oracle), the port picks by
where the tensors live:

  * CUDA tensors -> the hand-written kernel (``block_agg``,
    ``bitmap_active``), which launches or raises; there is no fallback;
  * CPU tensors  -> the plain PyTorch version in :mod:`.ref`, the
    oracle the kernels are tested against.

Anything else raises. The engine calls these once or twice per scan
round.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.state import MomentState
from repro_torch.kernels import bitmap_active as _bitmap
from repro_torch.kernels import block_agg as _block_agg
from repro_torch.kernels import ref as _ref


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: tensors on {t.device} are not supported "
                     "(CUDA runs the kernel, CPU the plain version)")


def moments_from_sums(sums: torch.Tensor, vmin: torch.Tensor,
                      vmax: torch.Tensor, center) -> MomentState:
    """Convert raw fold outputs — ``sums`` = (count, dsum, dsq) rows of a
    ``(3, G)`` float32 tensor plus ``(1, G)``-or-``(G,)`` extremes — into
    a :class:`MomentState` via the exact shifted-moment identity, in
    float32 exactly as the JAX package does."""
    count, dsum, dsq = sums[0], sums[1], sums[2]
    safe = torch.clamp(count, min=1.0)
    # centre as a Python scalar: rounded to float32 like the reference's
    # jnp.asarray(center, f32), with no host-to-device copy per round
    mean = dsum / safe + float(center)
    m2 = torch.clamp(dsq - dsum * dsum / safe, min=0.0)
    empty = count == 0
    zero = torch.zeros((), dtype=torch.float32, device=sums.device)
    return MomentState(
        count=count,
        mean=torch.where(empty, zero, mean),
        m2=torch.where(empty, zero, m2),
        vmin=vmin.reshape(-1),
        vmax=vmax.reshape(-1),
    )


def grouped_sums(values: torch.Tensor, gids: torch.Tensor,
                 mask: Optional[torch.Tensor], num_groups: int,
                 center: float = 0.0, *, blk: Optional[torch.Tensor] = None,
                 tvalid: Optional[torch.Tensor] = None):
    """Raw additive per-group fold: ``(sums, vmin, vmax)`` with ``sums``
    the ``(3, num_groups)`` (count, dsum, dsq) rows about ``center`` and
    ``vmin`` / ``vmax`` the ``(1, num_groups)`` extremes.

    ``values`` / ``gids`` / ``mask`` are ``(nb, block_rows)`` slabs (a
    1-D input is one block). ``blk`` selects blocks in fold order and
    ``tvalid`` flags padding lanes (their rows fold with mask 0); with
    ``blk=None`` every block is folded in order. Rows fold in row order
    on both devices, so the CUDA kernel and the CPU plain version give
    the same bits."""
    if mask is None:
        mask = torch.ones_like(values, dtype=torch.float32)
    if values.dim() == 1:
        values, gids, mask = (t.reshape(1, -1) for t in (values, gids, mask))
    if _on_cuda(values, "grouped_sums"):
        if blk is None:
            nb = values.shape[0]
            blk = torch.arange(nb, dtype=torch.int32, device=values.device)
            tvalid = torch.ones(nb, dtype=torch.int32, device=values.device)
        return _block_agg.block_agg(values, gids, mask, blk, tvalid, center,
                                    num_groups)
    if blk is not None:
        return _ref.block_agg_blocks_ref(values, gids, mask, blk, tvalid,
                                         center, num_groups=num_groups)
    return _ref.block_agg_ref(values, gids, mask, center,
                              num_groups=num_groups)


def grouped_moments(values: torch.Tensor, gids: torch.Tensor,
                    mask: Optional[torch.Tensor], num_groups: int,
                    center: float = 0.0, *,
                    blk: Optional[torch.Tensor] = None,
                    tvalid: Optional[torch.Tensor] = None) -> MomentState:
    """Masked per-group moments -> float32 :class:`MomentState` with
    leading dim ``num_groups``. ``center`` should be a data-scale
    constant (catalog midpoint) for f32 stability; the result is
    mathematically independent of it."""
    sums, vmin, vmax = grouped_sums(values, gids, mask, num_groups, center,
                                    blk=blk, tvalid=tvalid)
    return moments_from_sums(sums, vmin, vmax, center)


def grouped_hist(*args, **kwargs):
    """Per-group DKW histogram (the Anderson/DKW bounder's state)."""
    raise NotImplementedError(
        "grouped_hist (the Anderson/DKW histogram fold, TPU kernels "
        "repro.kernels.hist.grouped_hist and fused_scan.fused_fold) is not "
        "ported yet: it comes with a later slice of the port. Use a "
        "bounder other than 'anderson_dkw'.")


def active_blocks(words: torch.Tensor, active_words: torch.Tensor, *,
                  win: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed-bitmap activity probe -> int32 ``(n,)`` flags for rows
    ``win`` of ``words`` (all rows when ``win`` is None). Words are
    uint32 bits in int32 tensors."""
    if _on_cuda(words, "active_blocks"):
        return _bitmap.active_blocks(words, active_words, win)
    if win is not None:
        words = words[win]
    return _ref.active_blocks_ref(words, active_words)


def active_blocks_multi(*args, **kwargs):
    """Per-query activity probe over a ``(Q, W)`` stack of masks."""
    raise NotImplementedError(
        "active_blocks_multi (the multi-query probe of shared-scan "
        "serving) is not ported yet: it comes with the serving slice of "
        "the port.")
