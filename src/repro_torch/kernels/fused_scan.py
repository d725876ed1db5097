"""The fused scan round: one OptStop round's scan work on the card.

The port of the per-round part of :mod:`repro.kernels.fused_scan`. One
call of :func:`fused_round` runs, over device-resident column slabs:

    order[pos : pos+window] ──> static_ok ──┐
    bitmap.words[window]  ──bitmap_active───┴─> flags ──cumsum──> take mask
                                                           │         │
                                                      new_pos   block ids
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

On the card the fold is the ``block_agg`` CUDA kernel or, when the
round also folds the Anderson/DKW histogram, the ``fused_fold`` kernel
(the same moments plus the histogram in one pass). Both gather the
selected blocks themselves, so the ``(budget, block_rows)`` gather is
never materialised; on the CPU the fold is the plain version over the
gathered rows.
Nothing in a round reads a device value back on the host: the cursor
``pos`` comes in as a host int (the host knows it from the last sync) and
the selection is cumsum / argmax / scatter arithmetic.

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


def _budget_select(flags: torch.Tensor, pos: int, nb: int, window: int,
                   budget: int):
    """Budgeted selection, replicating the reference cursor bit for bit:
    take the first ``budget`` flagged blocks; the cursor cut is one past
    the budget-th selected block, else the (limit-clamped) window end.
    Returns ``(take mask over the window, new_pos (device scalar),
    inclusive flag count per position)``."""
    csum = torch.cumsum(flags.to(torch.int32), 0)
    take = flags & (csum <= budget)
    n_sel = csum[window - 1]
    # argmax over an int tensor: the first maximal index, like jnp.argmax
    # over the bool mask in the reference
    cut = torch.argmax(((csum == budget) & flags).to(torch.int32))
    covered = torch.where(n_sel >= budget, cut + 1, min(window, nb - pos))
    return take, pos + covered, csum


def _gather_blocks(take: torch.Tensor, csum: torch.Tensor, win: torch.Tensor,
                   window: int, budget: int):
    """Selected window positions -> padded block ids + padding-lane mask
    + window position per lane, with no host sync (the reference's
    ``jnp.nonzero(take, size=budget, fill_value=window)``): the k-th taken
    position scatters to lane k, every other position to a spare lane
    that is dropped. Padding lanes point at block 0 with ``tvalid`` False
    and ``take_idx`` = window."""
    dev = take.device
    lane = torch.where(take, csum - 1, budget).to(torch.int64)
    take_idx = torch.full((budget + 1,), window, dtype=torch.int64,
                          device=dev)
    take_idx.scatter_(0, lane, torch.arange(window, dtype=torch.int64,
                                            device=dev))
    take_idx = take_idx[:budget]
    tvalid = take_idx < window
    blk = torch.where(tvalid, win[torch.clamp(take_idx, max=window - 1)],
                      torch.zeros((), dtype=win.dtype, device=dev))
    return blk, tvalid, take_idx


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
    dev = order_pad.device
    offs = torch.arange(window, dtype=torch.int64, device=dev)
    in_range = (pos + offs) < nb
    win = order_pad[pos:pos + window]
    ok = static_ok[win] & in_range
    if probe:
        act = kops.active_blocks(words, active_words, win=win) > 0
        flags = ok & act
    else:
        flags = ok

    take, new_pos, csum = _budget_select(flags, pos, nb, window, budget)
    blk, tvalid, _ = _gather_blocks(take, csum, win, window, budget)
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

