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
the host: the cursor ``pos`` and the round's ``go`` flag are device
scalars (the previous round's ``new_pos``, and the loop's verdict that
the round is to run).

**Device-resident round loop** (``EngineConfig(device_loop=True)``, the
default): :func:`build_query_loop` goes one step further and removes the
per-round host sync. The whole OptStop round — :func:`fused_round`'s head
and fold, the float64 running-state merge, the skip / taint / coverage
accounting, the CI refresh (the ``*_device`` bound twins of
:mod:`repro_torch.core`) and the stopping condition — is enqueued on the
card with no ``.item()``, ``bool()`` or blocking copy inside, and its
state lives in a :class:`QueryLoopCarry` of device tensors. Torch has no
``lax.while_loop``: a chunk is a Python loop that enqueues a fixed number
of rounds, each computing on the card whether it is to run (``go``), and
updating every carry field through ``torch.where(go, new, old)``, so a
round after the stop is a no-op. The host reads one scalar per chunk.
On the card the engine captures a chunk as one CUDA graph and replays it
(:class:`repro_torch.aqp.engine._DeviceLoop`); on the CPU the same chunk
function runs eagerly. The multi-query pass loop is a later slice of the
port.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

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
                static_ok: torch.Tensor, pos: torch.Tensor,
                active_words: torch.Tensor, *, go: torch.Tensor, nb: int,
                window: int, budget: int, center: float, a: float, b: float,
                num_groups: int, nbins: int, use_hist: bool, probe: bool):
    """One fused scan round over device-resident column data.

    Args (tensors on one device unless noted):
      values/gids/mask: ``(nb, block_rows)`` materialized value column
        (f32), group codes (i32) and predicate*valid mask (f32);
      words: ``(nb, W)`` group-bitmap words, uint32 bits in int32 (unused
        when ``probe=False``);
      order_pad: ``(nb + window,)`` int32 scan order, zero-padded;
      static_ok: ``(nb,)`` bool static-prefilter verdict per block;
      pos: the scan cursor, an int64 device scalar;
      active_words: ``(W,)`` int32 packed active-group mask;
      go: a bool device scalar: False (or ``pos`` outside ``[0, nb]``)
        makes the round select nothing and fold no row.

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
        order_pad, static_ok, words, active_words, pos, go, nb=nb,
        window=window, budget=budget, probe=probe)
    state, hist = _fold(values, gids, mask, blk, tvalid, center, a, b,
                        num_groups, nbins, use_hist)
    return state, hist, ok, flags, new_pos


# Device twins of the host loop's pack_mask / merge_moments_host (the
# latter is core.state.merge_moments), called by the device-resident loop.


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


def _probe_cost(flags: torch.Tensor, pos: torch.Tensor, nb: int,
                window: int, budget: int, lookahead: int,
                cover_cap: int) -> torch.Tensor:
    """Device twin of the host's probe metric (the per-lookahead batched
    probing counted in ``engine._fused_accounting``): the window
    positions the per-block path would have probed this round, as an
    int64 device scalar."""
    dev = flags.device
    win_len = torch.clamp(nb - pos, max=window)
    csum = torch.cumsum(flags.to(torch.int32), 0)
    csum_excl = torch.cat([torch.zeros(1, dtype=csum.dtype, device=dev),
                           csum[:-1]])
    n_batches = -(-window // lookahead)
    starts = torch.arange(n_batches, dtype=torch.int64, device=dev) * lookahead
    probed = ((csum_excl[starts] < budget) & (starts < win_len)
              & (starts < cover_cap))
    ends = torch.minimum(starts + lookahead, win_len)
    return torch.where(probed, ends - starts, 0).sum()


class QueryLoopBuffers(NamedTuple):
    """Device-resident inputs of the single-query loop, constant across
    rounds (a captured chunk reads them where they are: ``order_pad`` and
    ``cum_rows`` are refilled in place for each run)."""

    values: torch.Tensor          # (nb, block_rows) f32 value column
    gids: torch.Tensor            # (nb, block_rows) i32 group codes
    mask: torch.Tensor            # (nb, block_rows) f32 predicate*valid
    words: torch.Tensor           # (nb, W) group-bitmap words (u32 in i32)
    order_pad: torch.Tensor       # (nb + window,) i32 scan order
    static_ok: torch.Tensor       # (nb,) bool static prefilter
    presence: torch.Tensor        # (nb, G) bool view-presence matrix
    presence_total: torch.Tensor  # (G,) i32 blocks containing each view
    cum_rows: torch.Tensor        # (nb,) i64 cumulative valid rows in order


class QueryLoopCarry(NamedTuple):
    """The loop's state: every piece of per-query round state the host
    loop keeps in numpy, device-resident across rounds."""

    pos: torch.Tensor             # i64 scan cursor
    rounds: torch.Tensor          # i64 completed OptStop rounds (k)
    it: torch.Tensor              # i64 rounds run inside the current chunk
    live: torch.Tensor            # bool: some view still active
    stopped_early: torch.Tensor   # bool: stop fired before exhaustion
    state: MomentState            # f64 (G,) running moments
    hist: Optional[torch.Tensor]  # f64 (G, K) running histogram (or None)
    processed: torch.Tensor       # (nb,) bool
    seen_presence: torch.Tensor   # (G,) i32 processed blocks per view
    tainted: torch.Tensor         # (G,) bool
    exact: torch.Tensor           # (G,) bool
    lo: torch.Tensor              # (G,) f64 running interval
    hi: torch.Tensor              # (G,) f64
    est: torch.Tensor             # (G,) f64
    refreshed: torch.Tensor       # (G,) bool
    active: torch.Tensor          # (G,) bool
    blocks_fetched: torch.Tensor  # i64 scan metrics
    skipped_static: torch.Tensor  # i64
    skipped_active: torch.Tensor  # i64
    probes: torch.Tensor          # i64


def carry_leaves(c: QueryLoopCarry):
    """The carry's tensors in field order (the moment state's five
    expanded, a missing histogram skipped)."""
    for f in c:
        if isinstance(f, MomentState):
            yield from f
        elif f is not None:
            yield f


def _select(go: torch.Tensor, new: QueryLoopCarry,
            old: QueryLoopCarry) -> QueryLoopCarry:
    """``new`` where the round ran, ``old`` where it did not, field by
    field: a round after the stop changes nothing."""
    pick = lambda n, o: torch.where(go, n, o)
    return QueryLoopCarry(*(
        MomentState(*map(pick, n, o)) if isinstance(n, MomentState)
        else None if n is None else pick(n, o)
        for n, o in zip(new, old)))


def _round_scan(bufs: QueryLoopBuffers, pos: torch.Tensor, go: torch.Tensor,
                active_words: Optional[torch.Tensor], *, nb: int,
                window: int, budget: int, probe: bool):
    """The round's cursor and selection (twin of the reference's
    ``_round_scan``): the head (:func:`repro_torch.kernels.ops.
    round_select`) plus the window's block ids and the covered-range
    mask the accounting needs. Returns ``(win, ok, flags, blk, tvalid,
    new_pos, covmask)``."""
    ok, flags, new_pos, blk, tvalid = kops.round_select(
        bufs.order_pad, bufs.static_ok, bufs.words, active_words, pos, go,
        nb=nb, window=window, budget=budget, probe=probe)
    offs = torch.arange(window, dtype=torch.int64, device=pos.device)
    win = bufs.order_pad[torch.clamp(pos, 0, nb) + offs]
    covmask = offs < (new_pos - pos)
    return win, ok, flags, blk, tvalid, new_pos, covmask


def build_query_loop(*, nb: int, window: int, budget: int, center: float,
                     a: float, b: float, num_groups: int, nbins: int,
                     use_hist: bool, probe: bool, n_words: int,
                     lookahead: int, cover_cap: int, max_rounds: int,
                     chunk: int, refresh_fn: Callable):
    """Build the device-resident round loop for one query.

    Returns ``(chunk_fn, cond)``. ``chunk_fn(bufs: QueryLoopBuffers,
    carry: QueryLoopCarry) -> QueryLoopCarry`` enqueues ``chunk`` OptStop
    rounds and returns the carry after them; nothing in it reads a device
    value on the host, so it can be captured as one CUDA graph. Each
    round is the device twin of the host round: :func:`fused_round`'s
    head and fold, the f64 state merge, ``_fused_accounting``'s skip /
    taint / probe bookkeeping, ``_ScanViews.update_exact`` and the
    caller's ``refresh_fn`` (CI refresh and stopping condition; see
    ``engine._make_device_refresh``). ``cond(carry)`` is the device bool
    ``live & (pos < nb) & (rounds < max_rounds)``: a round whose ``cond``
    is false (after the stop, the end of the scan or ``max_rounds``) runs
    its kernels on nothing and leaves the carry as it was, so the result
    does not depend on ``chunk``.

    ``refresh_fn(k, r, state, hist, tainted, exact, lo, hi, est,
    refreshed, active)`` returns the updated ``(lo, hi, est, refreshed,
    active)``. The carry's moments, histogram and intervals must be
    float64 (the caller checks them with
    :func:`repro_torch.core.state.require_x64`).
    """

    def cond(c: QueryLoopCarry) -> torch.Tensor:
        return c.live & (c.pos < nb) & (c.rounds < max_rounds)

    def body(bufs: QueryLoopBuffers, c: QueryLoopCarry) -> QueryLoopCarry:
        go = cond(c)
        k = c.rounds + 1
        aw = pack_active_device(c.active, n_words) if probe else None
        win, ok, flags, blk, tvalid, new_pos, covmask = _round_scan(
            bufs, c.pos, go, aw, nb=nb, window=window, budget=budget,
            probe=probe)
        dstate, dhist = _fold(bufs.values, bufs.gids, bufs.mask, blk, tvalid,
                              center, a, b, num_groups, nbins, use_hist)
        state = _merge_f64(c.state, dstate)
        hist = c.hist + dhist.to(torch.float64) if use_hist else None

        # -- accounting (twin of engine._fused_accounting + ingest) ------
        act_skip = ok & ~flags & covmask
        pres_win = bufs.presence[win]
        tainted = c.tainted | (pres_win & act_skip[:, None]).any(dim=0)
        skipped_static = c.skipped_static + (~ok & covmask).sum()
        skipped_active = c.skipped_active + act_skip.sum()
        probes = c.probes
        if probe:
            probes = probes + _probe_cost(flags, c.pos, nb, window, budget,
                                          lookahead, cover_cap)
        # the taken positions are the valid lanes, their blocks blk
        hit = torch.zeros(nb, dtype=torch.int32, device=blk.device)
        hit.index_add_(0, blk, tvalid.to(torch.int32))
        processed = c.processed | (hit > 0)
        blocks_fetched = c.blocks_fetched + tvalid.sum()
        seen_presence = c.seen_presence + (
            bufs.presence[blk] & tvalid[:, None]).sum(dim=0,
                                                     dtype=torch.int32)

        # -- coverage / exactness (twin of _ScanViews.update_exact) ------
        cov = seen_presence >= bufs.presence_total
        cov = cov | ((new_pos >= nb) & ~tainted)
        exact = c.exact | cov

        # -- CI refresh + stopping condition (engine-supplied) -----------
        last = torch.clamp(new_pos - 1, min=0).reshape(1)
        r = torch.where(new_pos > 0, bufs.cum_rows.index_select(0, last)[0],
                        0).to(torch.float64)
        lo, hi, est, refreshed, active = refresh_fn(
            k, r, state, hist, tainted, exact, c.lo, c.hi, c.est,
            c.refreshed, c.active)
        live = active.any()
        stopped_early = c.stopped_early | (~live & (new_pos < nb))

        new = QueryLoopCarry(
            pos=new_pos, rounds=k, it=c.it + 1, live=live,
            stopped_early=stopped_early, state=state, hist=hist,
            processed=processed, seen_presence=seen_presence,
            tainted=tainted, exact=exact, lo=lo, hi=hi, est=est,
            refreshed=refreshed, active=active,
            blocks_fetched=blocks_fetched, skipped_static=skipped_static,
            skipped_active=skipped_active, probes=probes)
        return _select(go, new, c)

    def chunk_fn(bufs: QueryLoopBuffers,
                 carry: QueryLoopCarry) -> QueryLoopCarry:
        carry = carry._replace(it=torch.zeros_like(carry.it))
        for _ in range(chunk):
            carry = body(bufs, carry)
        return carry

    return chunk_fn, cond
