"""The fused scan round: one OptStop round's scan work on the card.

The port of the per-round part of :mod:`repro.kernels.fused_scan`. One
call of :func:`fused_round` runs, over device-resident column slabs:

    order[pos : pos+window] ──> static_ok ──┐
    bitmap.words[window]  ──────probe───────┴─> flags ──rank──> new_pos,
                                                         lanes' block ids
                                                                     │
                     MomentState delta (+ hist delta)  <──fold───────┘

and the host syncs once per round, to fetch the mergeable delta and the
per-position flags it needs for its soundness bookkeeping. Selection
reproduces the reference cursor bit for bit: the round takes the first
``budget`` blocks whose static prefilter AND activity test pass, and the
cursor stops just past the budget-th selected block (or at the window
end). The fold then sees exactly the rows the per-block path would fold,
in the same order; padding lanes point at block 0 with ``tvalid`` False
and fold with mask 0.

On the card the round is two kernels: the round head
(:func:`repro_torch.kernels.ops.round_select`: window, prefilter, probe,
selection and the lanes' block ids in one launch) and the fold, the
``block_agg`` CUDA kernel or, when the round also folds the Anderson/DKW
histogram, the ``fused_fold`` kernel (the same moments plus the
histogram in one pass). Both folds gather the selected blocks
themselves, so the ``(budget, block_rows)`` gather is never
materialised. On the CPU the head is the plain sequence (probe, cumsum
/ argmax selection, scatter of the lanes) and the fold the plain version
over the gathered rows. Nothing in a round reads a device value back on
the host: the cursor ``pos`` comes in as a host int (the host knows it
from the last sync).

The device-resident loop (``build_query_loop``) and the multi-query
round are later slices of the port.
"""

from __future__ import annotations

import torch

from repro_torch.core.state import MomentState, merge_moments
from repro_torch.kernels import ops as kops


def _fold(values, gids, mask, blk, tvalid, center, a, b, num_groups,
          nbins, use_hist):
    """One round's fold of the selected blocks -> ``(float32
    MomentState delta, (G, nbins) histogram delta | None)``. Without the
    histogram it is the ``block_agg`` fold alone; with it the
    ``fused_fold`` pass, whose moments are the same bits."""
    hist = None
    if use_hist:
        sums, vmin, vmax, hist = kops.grouped_fold_hist(
            values, gids, mask, num_groups, center, a, b, nbins, blk=blk,
            tvalid=tvalid)
    else:
        sums, vmin, vmax = kops.grouped_sums(values, gids, mask,
                                             num_groups, center, blk=blk,
                                             tvalid=tvalid)
    return kops.moments_from_sums(sums, vmin, vmax, center), hist


def fused_round(values: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
                words: torch.Tensor, order_pad: torch.Tensor,
                static_ok: torch.Tensor, pos: int,
                active_words: torch.Tensor, *, nb: int, window: int,
                budget: int, center: float, a: float, b: float,
                num_groups: int, nbins: int, use_hist: bool, probe: bool):
    """One fused scan round over device-resident column data.

    Args (tensors on one device unless noted):
      values/gids/mask: ``(nb, block_rows)`` materialized value column
        (f32), group codes (i32) and predicate*valid mask (f32);
      words: ``(nb, W)`` group-bitmap words, uint32 bits in int32 (unused
        when ``probe=False``);
      order_pad: ``(nb + window,)`` int32 scan order, zero-padded;
      static_ok: ``(nb,)`` bool static-prefilter verdict per block;
      pos: the scan cursor, a host int;
      active_words: ``(W,)`` int32 packed active-group mask.

    ``window`` is the round's maximum cursor coverage and ``budget`` the
    processed-block budget, as in the reference; with ``use_hist`` the
    round also folds the ``(num_groups, nbins)`` histogram over
    ``[a, b]`` (the Anderson/DKW bounder's state).

    Returns ``(state, hist, ok, flags, new_pos)``: the mergeable
    :class:`MomentState` delta (float32) and histogram delta (float32,
    None without ``use_hist``) for the round, the per-window-position
    static / activity verdicts the host needs for taint and skip
    accounting, and the advanced cursor (a device scalar).
    """
    ok, flags, new_pos, blk, tvalid = kops.round_select(
        order_pad, static_ok, words, active_words, pos, nb=nb,
        window=window, budget=budget, probe=probe)
    state, hist = _fold(values, gids, mask, blk, tvalid, center, a, b,
                        num_groups, nbins, use_hist)
    return state, hist, ok, flags, new_pos


# Device twins of the host loop's pack_mask / merge_moments_host (the
# latter is core.state.merge_moments). The host loop does not call them;
# the device-resident loop (a later slice) does.


def pack_active_device(active: torch.Tensor, n_words: int) -> torch.Tensor:
    """Device twin of :func:`repro_torch.aqp.bitmap.pack_mask`: bool
    ``(G,)`` active mask -> ``(n_words,)`` packed words (little-endian bit
    order, bit ``j`` of word ``w`` = group ``32 w + j``), as uint32 bits
    in an int32 tensor. Packs in int64 (torch has no uint32 arithmetic on
    the CPU) and wraps each word into int32 range."""
    G = active.shape[0]
    bits = torch.zeros(n_words * 32, dtype=torch.int64, device=active.device)
    bits[:G] = active.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=active.device)
    words = (bits.reshape(n_words, 32) << shifts).sum(dim=1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _merge_f64(state: MomentState, delta: MomentState) -> MomentState:
    """Fold a round's float32 mergeable delta into a float64 running
    state on the device: the twin of
    ``merge_moments_host(state, to_host(delta))``. The delta is cast to
    float64 before any arithmetic (torch keeps ``f32 * f64[]`` in
    float32). Same formula in the same order."""
    return merge_moments(
        state, MomentState(*(f.to(torch.float64) for f in delta)))

