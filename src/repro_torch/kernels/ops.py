"""Public kernel entry points of the port, dispatching on the device.

The port of :mod:`repro.kernels.ops`. Where the JAX package picks a
backend with ``impl=`` (Pallas, interpreter or oracle), the port picks by
where the tensors live:

  * CUDA tensors -> the hand-written kernel (``block_agg``,
    ``fused_fold``, ``grouped_hist``, ``bitmap_active`` with its
    multi-query form and its round head ``round_select``,
    ``selective_scan``, ``selective_scan_bwd``),
    which launches or raises; there is no fallback;
  * CPU tensors  -> the plain PyTorch version in :mod:`.ref`, the
    oracle the kernels are tested against.

Anything else raises. The engine calls the round head and a fold once
per fused scan round (once a slot a round in a shared pass, whose host
loop also runs the multi-query probe); the Mamba1 layer's ``"pallas"`` path calls
:func:`selective_scan` once per layer per forward and, in training,
:func:`selective_scan_bwd` once per layer per backward.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.state import HistState, MomentState
from repro_torch.kernels import _build
from repro_torch.kernels import bitmap_active as _bitmap
from repro_torch.kernels import block_agg as _block_agg
from repro_torch.kernels import fused_fold as _fused_fold
from repro_torch.kernels import grouped_hist as _hist
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import selective_scan as _scan


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
    ``(3, G)`` tensor plus ``(1, G)``-or-``(G,)`` extremes — into a
    :class:`MomentState` via the exact shifted-moment identity, in the
    sums' dtype exactly as the JAX package does: float32 for a round's
    fold, float64 for the sharded scan's pooled cadence delta."""
    count, dsum, dsq = sums[0], sums[1], sums[2]
    safe = torch.clamp(count, min=1.0)
    # centre as a Python scalar rounded to float32, like the reference's
    # jnp.asarray(center, f32) (also in float64 arithmetic), with no
    # host-to-device copy per round
    mean = dsum / safe + float(np.float32(center)) # aqplint: disable=AQP101(center is a Python number: no host sync)
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


def grouped_fold_hist(values: torch.Tensor, gids: torch.Tensor,
                      mask: torch.Tensor, num_groups: int, center: float,
                      a: float, b: float, nbins: int, *, blk: torch.Tensor,
                      tvalid: torch.Tensor):
    """The fused round's fold with the histogram: :func:`grouped_sums`'s
    ``(sums, vmin, vmax)`` of blocks ``blk`` of the ``(nb, block_rows)``
    slabs plus the ``(num_groups, nbins)`` histogram of the same rows
    over ``[a, b]``, in one pass (the ``fused_fold`` kernel on the card).
    The moments are bit for bit those of :func:`grouped_sums`."""
    if _on_cuda(values, "grouped_fold_hist"):
        return _fused_fold.fused_fold(values, gids, mask, blk, tvalid,
                                      center, a, b, num_groups, nbins)
    return _ref.fused_fold_ref(values, gids, mask, blk, tvalid, center, a,
                               b, num_groups=num_groups, nbins=nbins)


def grouped_hist(values: torch.Tensor, gids: torch.Tensor,
                 mask: Optional[torch.Tensor], num_groups: int, a: float,
                 b: float, nbins: int = 1024) -> HistState:
    """Per-group DKW histogram -> :class:`HistState` ``(num_groups,
    nbins)``: the count of masked rows in each bin of the uniform grid
    over ``[a, b]``, rows read flat.

    The mask contract: the CUDA kernel counts a row with ``m != 0`` once,
    while the plain version (and the JAX package's reference) adds ``m``
    itself. The two agree on 0 / 1 masks, which is what every caller
    passes (the engine's predicate times validity)."""
    if mask is None:
        mask = torch.ones_like(values, dtype=torch.float32)
    if _on_cuda(values, "grouped_hist"):
        return HistState(_hist.grouped_hist(values, gids, mask, a, b,
                                            num_groups, nbins))
    return HistState(_ref.grouped_hist_ref(values, gids, mask, a, b,
                                           num_groups=num_groups,
                                           nbins=nbins))


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


def active_blocks_multi(words: torch.Tensor, stack: torch.Tensor, *,
                        win: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-query activity probe over a ``(Q, W)`` stack of masks -> int32
    ``(Q, n)``, row ``q`` bit for bit :func:`active_blocks` of the same
    rows against ``stack[q]`` (rows ``win`` of ``words``, all rows when
    ``win`` is None). One launch on the card, where the reference loops
    its kernel once a row of the stack."""
    if _on_cuda(words, "active_blocks_multi"):
        return _bitmap.active_blocks_multi(words, stack, win)
    if win is not None:
        words = words[win.long()]
    return _ref.active_blocks_multi_ref(words, stack)


def round_select(order_pad: torch.Tensor, static_ok: torch.Tensor,
                 words: torch.Tensor, active_words: torch.Tensor,
                 pos: torch.Tensor, go: torch.Tensor, *, nb: int,
                 window: int, budget: int, probe: bool,
                 lap_end: Optional[int] = None, wrap: bool = False):
    """The fused round's head: the cursor window of ``order_pad`` from
    ``pos``, its static-prefilter verdicts ``ok``, the activity ``flags``
    (``ok`` AND the bitmap probe of ``words`` against ``active_words``;
    ``ok`` itself without ``probe``), the budgeted cut ``new_pos`` and the
    fold's lanes: ``blk`` (the k-th flagged position's block) and
    ``tvalid`` (False on padding lanes, whose ``blk`` is 0).

    ``pos`` is an int64 and ``go`` a bool scalar on the tensors' device
    (the previous round's ``new_pos`` and the loop's verdict): nothing is
    read from the host, so a CUDA graph of many rounds replays right. A
    round with ``go`` false, or ``pos`` outside ``[lap_end - nb,
    lap_end]``, selects nothing and returns ``new_pos == pos``.
    ``order_pad`` holds ``nb + window`` entries.

    A slot of a shared pass (:func:`repro_torch.kernels.fused_scan.
    build_pass_loop`) passes its lap's end ``lap_end`` (``anchor + nb``;
    ``nb`` when None), ``wrap=True`` (the window starts at ``pos % nb``
    of a wrap-filled ``order_pad``) and a ``(Q, W)`` stack of its
    queries' masks as ``active_words``, whose flags are the union over
    the rows. Returns ``(ok, flags, new_pos, blk, tvalid)``: bool
    ``(window,)`` twice, an int64 device scalar, int32 and bool
    ``(budget,)``. One launch on the card; the plain sequence
    (:func:`repro_torch.kernels.ref.round_select_ref`) on the CPU."""
    kw = dict(nb=nb, window=window, budget=budget, probe=probe,
              lap_end=lap_end, wrap=wrap)
    if _on_cuda(order_pad, "round_select"):
        return _bitmap.round_select(order_pad, static_ok, words,
                                    active_words, pos, go, **kw)
    return _ref.round_select_ref(order_pad, static_ok, words, active_words,
                                 pos, go, **kw)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                   h0: torch.Tensor, *, din_tile: int = _scan.DIN_TILE,
                   time_chunk: int = _scan.TIME_CHUNK):
    """Mamba1 selective scan forward -> ``(y (B, L, din), hout (B, din,
    n), hseg (B, L / tc, din, n))`` float32, ``tc = min(time_chunk, L)``
    (:func:`repro_torch.kernels.ref.selective_scan_ref` says what it
    computes). Inputs are cast to float32, as the reference's ``_forward``
    casts them. On the meta device it returns the outputs' shapes and
    reports the launch they stand for to a running cost analysis
    (:func:`repro_torch.kernels._build.report`), counting none.

    The shape contract is the reference's (its grid is ``din / din_tile``
    by ``L / tc``): ``L`` must be a multiple of ``tc`` and ``din`` of
    ``din_tile``. The CUDA kernel would take a ragged ``din``; the check
    stays so both packages accept the same shapes."""
    B, L, din = x.shape
    tc = min(time_chunk, L)
    if L % tc or din % din_tile:
        raise ValueError(f"selective_scan: L and din must be multiples of "
                         f"the time chunk and the din tile, got "
                         f"(L, tc, din, din_tile) = {(L, tc, din, din_tile)}")
    args = [t.to(torch.float32).contiguous()
            for t in (x, dt, b, c, a, d, h0)]
    if x.device.type == "meta":
        # a cost analysis on meta (launch/step_cost.py): the launch's
        # outputs as it allocates them and the bytes it moves; nothing
        # runs and no launch is counted
        n = b.shape[-1]
        _build.report("selective_scan", *_scan.traffic(B, L, din, n, tc),
                      stand_in=True)
        return tuple(torch.empty(s, dtype=torch.float32, device="meta")
                     for s in ((B, L, din), (B, din, n),
                               (B, L // tc, din, n)))
    if _on_cuda(x, "selective_scan"):
        return _scan.selective_scan(*args, time_chunk=tc)
    return _ref.selective_scan_ref(*args, time_chunk=tc)


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                       hseg: torch.Tensor, ybar: torch.Tensor,
                       houtbar: torch.Tensor, *,
                       time_chunk: int = _scan.TIME_CHUNK):
    """Mamba1 selective scan backward -> ``(dx, ddt (B, L, din), dB, dC
    (B, L, n), dA (din, n), dD (din,), dh0 (B, din, n))`` float32, from
    the forward's inputs, its chunk-start states ``hseg`` (at the same
    ``time_chunk``) and the cotangents of ``y`` and of the final state
    (:func:`repro_torch.kernels.ref.selective_scan_bwd_ref` says what it
    computes). Inputs are cast to float32, as the reference's
    ``make_trainable_scan`` casts them before ``_backward``."""
    tc = min(time_chunk, x.shape[1])
    args = [t.to(torch.float32).contiguous()
            for t in (x, dt, b, c, a, d, hseg, ybar, houtbar)]
    if _on_cuda(x, "selective_scan_bwd"):
        return _scan.selective_scan_bwd(*args, time_chunk=tc)
    return _ref.selective_scan_bwd_ref(*args, time_chunk=tc)
