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
function runs eagerly.

**Shared passes** (:mod:`repro_torch.serve`): :func:`fused_round_multi`
is one round of a pass of several queries over shared filters, each
*slot* (a distinct ``(column, group-by)``) walking its own cursor over
its own lap ``[anchor, anchor + nb)`` of a wrap-filled scan order with
its own flags (the union over the slot's queries: one head launch with a
stack of masks), and returning the per-query flag stacks through the
multi-query probe. :func:`build_pass_loop` is the pass's device-resident
loop, the twin of :func:`build_query_loop` with every slot frozen by
``torch.where`` once its lap ends or its queries all finish, and each
query's result snapshotted in the carry the round it finishes.

**Sharded scan** (``EngineConfig(shard_rows=True)``, :class:`ShardInfo`):
the same loops with the scan *divided* over the ranks of a
``torch.distributed`` process group, one process a device. Each rank
holds its ``shard_rows`` row slice of every block (the block axis is
whole everywhere), so the round head, the cursor, the accounting and the
bound math run replicated on every rank, and each rank folds only its
slice of the selected blocks. The fold's raw additive sums (count, dsum,
dsq about the centre, and the histogram) and its extremes are the only
thing that crosses ranks: two ``all_reduce`` calls a merge, a SUM over
the sums and a MIN over ``[vmin, -vmax]`` (:func:`merge_across_shards`),
before the shifted-moment conversion. At ``merge_every = K > 1`` (the
collective cadence) a round only adds its local delta to float64 pending
slots of the carry, and the merge fires at the start of a round once K
rounds are pending, plus a flush when the reference's dispatch would
exit. A chunk is a fixed sequence of rounds, so the merge is issued at
fixed positions of it (the start of every K-th round, and the exit) on
every rank, and its effect is gated on the replicated ``go &
(pend_rounds >= K)`` (``pend_rounds > 0`` for the flush): every rank
issues the same collectives in the same order, and a chunk can be
captured as a CUDA graph (under NCCL). A chunk the caller asked for is
one of the reference's dispatches of that many rounds (it exits
merged); the default chunk stands in for the reference's single
dispatch to the end (``until_end``: a multiple of K rounds, pending
deltas carried into the next chunk, the flush once the loop is over),
so the merges fall on the same rounds as there.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.state import MomentState, merge_moments
from repro_torch.kernels import ops as kops


class ShardInfo(NamedTuple):
    """The divided scan's geometry on this rank (built by
    :class:`repro_torch.aqp.distributed.BlockShards`). Shard ``d`` is rank
    ``d`` of ``group`` and holds rows ``[d * shard_rows, (d + 1) *
    shard_rows)`` of EVERY block, the row axis zero-padded so every rank
    holds an equal-shape ``(nb, shard_rows)`` slab (padding rows carry
    ``mask == 0`` and fold to exact zeros). The block axis is whole on
    every rank, so global block ids index the local slab directly."""

    group: object         # torch.distributed group (None: the default)
    n_shards: int
    rank: int
    shard_rows: int       # padded rows a block on each rank
    merge_every: int = 1  # collective cadence K (1: merge every round)


#: Host-side tally of the sharded fold's all-reduces: calls, bytes and
#: the host seconds spent inside them (under gloo the whole staged reduce;
#: under NCCL the enqueue). A captured chunk's replays add the calls and
#: bytes their capture recorded (``engine._ChunkGraph``), not seconds.
COLLECTIVES = {"calls": 0, "bytes": 0, "seconds": 0.0}


def _all_reduce(t: torch.Tensor, op, group) -> None:
    t0 = time.perf_counter() # aqplint: disable=AQP101(a host clock read around the collective: no device sync)
    dist.all_reduce(t, op=op, group=group)
    COLLECTIVES["seconds"] += time.perf_counter() - t0 # aqplint: disable=AQP101(a host clock read around the collective: no device sync)
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += t.numel() * t.element_size()


def merge_across_shards(shard: ShardInfo, folds):
    """Merge raw additive folds across the ranks of ``shard.group``:
    ``folds`` is a sequence of ``(sums (3, G), vmin, vmax, hist | None)``
    (one a slot), all of one float dtype, and the same sequence comes
    back summed (sums, histograms) and min / max-ed (extremes) over the
    ranks. Two ``all_reduce`` calls whatever the number of folds: a SUM
    over every sum and histogram in one flat buffer, a MIN over every
    ``vmin`` and ``-vmax`` (``max(x) = -min(-x)`` holds exactly for
    floats and infinities). The inputs are not modified (the collectives
    run on fresh buffers), so a caller may still discard the result."""
    sums = [f[0] for f in folds] + [f[3] for f in folds if f[3] is not None]
    ext = ([f[1] for f in folds]
           + [torch.neg(f[2]) for f in folds])
    buf = torch.cat([t.reshape(-1) for t in sums])
    mins = torch.cat([t.reshape(-1) for t in ext])
    _all_reduce(buf, dist.ReduceOp.SUM, shard.group)
    _all_reduce(mins, dist.ReduceOp.MIN, shard.group)
    sum_parts = iter(torch.split(buf, [t.numel() for t in sums]))
    min_parts = iter(torch.split(mins, [t.numel() for t in ext]))
    merged_sums = [next(sum_parts).reshape(f[0].shape) for f in folds]
    merged_hist = [next(sum_parts).reshape(f[3].shape)
                   if f[3] is not None else None for f in folds]
    merged_min = [next(min_parts).reshape(f[1].shape) for f in folds]
    merged_max = [torch.neg(next(min_parts)).reshape(f[2].shape)
                  for f in folds]
    return [tuple(x) for x in zip(merged_sums, merged_min, merged_max,
                                  merged_hist)]


def _fold_local(values, gids, mask, blk, tvalid, center, a, b, num_groups,
                nbins, use_hist):
    """This rank's raw additive fold of one round's selected blocks:
    ``(sums (3, G), vmin (1, G), vmax (1, G), hist (G, nbins) | None)``,
    float32, about ``center``, before any merge across ranks or the
    shifted-moment conversion. Without the histogram it is the
    ``block_agg`` fold alone; with it the ``fused_fold`` pass, whose
    moments are the same bits."""
    if use_hist:
        return kops.grouped_fold_hist(values, gids, mask, num_groups, center,
                                      a, b, nbins, blk=blk, tvalid=tvalid)
    sums, vmin, vmax = kops.grouped_sums(values, gids, mask, num_groups,
                                         center, blk=blk, tvalid=tvalid)
    return sums, vmin, vmax, None


def _fold(values, gids, mask, blk, tvalid, center, a, b, num_groups,
          nbins, use_hist, shard: Optional[ShardInfo] = None):
    """One round's fold of the selected blocks -> ``(float32
    MomentState delta, (G, nbins) histogram delta | None)``. With
    ``shard`` the slabs are this rank's row slice of every block and the
    raw sums merge across ranks BEFORE the shifted-moment conversion
    (the reference's ``_fold(shard_axes=)``), so the merged state is the
    single-device fold up to the order of the row sum: bit for bit
    whenever each rank's float32 partial sums are exact."""
    sums, vmin, vmax, hist = _fold_local(values, gids, mask, blk, tvalid,
                                         center, a, b, num_groups, nbins,
                                         use_hist)
    if shard is not None:
        ((sums, vmin, vmax, hist),) = merge_across_shards(
            shard, [(sums, vmin, vmax, hist)])
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
    # the collective cadence's slots (``ShardInfo.merge_every > 1``;
    # None otherwise): this rank's raw additive delta since the last
    # merge, zeroed by every merge; a dispatch exits merged (its flush)
    pend_sums: Optional[torch.Tensor] = None    # (3, G) f64
    pend_vmin: Optional[torch.Tensor] = None    # (G,) f64, +inf when empty
    pend_vmax: Optional[torch.Tensor] = None    # (G,) f64, -inf when empty
    pend_hist: Optional[torch.Tensor] = None    # (G, K) f64
    pend_rounds: Optional[torch.Tensor] = None  # i64 rounds since the last
                                                # merge (replicated)


_LEAF = (torch.Tensor, np.ndarray)


def carry_leaves(c):
    """The carry's tensors in field order, depth first (a moment state's
    five expanded, nested slot and query carries walked, missing fields
    skipped). Works for every carry of this module, and for its host
    image (numpy arrays in place of tensors)."""
    for f in c:
        if isinstance(f, _LEAF):
            yield f
        elif f is not None:
            yield from carry_leaves(f)


def carry_map(fn: Callable, *carries):
    """Rebuild a carry (or a tuple of carries) with ``fn`` applied to its
    tensors (or arrays), leaf by leaf across ``carries`` of one
    structure."""
    c0 = carries[0]
    if isinstance(c0, _LEAF):
        return fn(*carries)
    if c0 is None:
        return None
    vals = [carry_map(fn, *fs) for fs in zip(*carries)]
    return type(c0)(*vals) if hasattr(c0, "_fields") else tuple(vals)


def _select(go: torch.Tensor, new, old):
    """``new`` where the round ran, ``old`` where it did not, field by
    field: a round after the stop changes nothing."""
    return carry_map(lambda n, o: torch.where(go, n, o), new, old)


_TORCH_DTYPE = {np.dtype(bool): torch.bool, np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.float64): torch.float64}


def carry_to_device(host, device: torch.device):
    """Upload a carry's host image (numpy arrays of bool, int32, int64 or
    float64) in ONE host-to-device copy: the leaves packed as float64
    (which holds every value of theirs exactly), from pinned memory
    without a stream sync on the card, then split and cast on the
    device."""
    leaves = list(carry_leaves(host))
    flat = np.concatenate([np.asarray(x, np.float64).reshape(-1)
                           for x in leaves])
    t = torch.from_numpy(flat)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    parts = iter(torch.split(t, [x.size for x in leaves]))
    return carry_map(lambda x: next(parts).to(_TORCH_DTYPE[x.dtype])
                     .reshape(x.shape), host)


def carry_to_host(carry, extra=()):
    """A carry's host image (numpy arrays of each leaf's dtype) in ONE
    device-to-host copy, the leaves packed as float64; ``extra`` tensors
    ride in the same copy and come back as float64 arrays after it.
    Returns ``(host carry, [extra arrays])``."""
    leaves = list(carry_leaves(carry)) + list(extra)
    flat = torch.cat([t.reshape(-1).to(torch.float64)
                      for t in leaves]).cpu().numpy()
    out, at = [], 0
    for t in leaves:
        n = t.numel()
        dt = {torch.bool: bool, torch.int32: np.int32,
              torch.int64: np.int64}.get(t.dtype, np.float64)
        out.append(flat[at:at + n].reshape(tuple(t.shape)).astype(dt))
        at += n
    it = iter(out)
    host = carry_map(lambda _: next(it), carry)
    return host, out[len(out) - len(extra):] if extra else []


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


def _empty_pending(like: torch.Tensor, hist: Optional[torch.Tensor]):
    """The cadence's pending slots emptied: zero sums (and histogram),
    ``+inf`` / ``-inf`` extremes, no pending round."""
    return dict(pend_sums=torch.zeros_like(like),
                pend_vmin=torch.full_like(like[0], float("inf")),
                pend_vmax=torch.full_like(like[0], float("-inf")),
                pend_hist=None if hist is None else torch.zeros_like(hist))


def _check_until_end(cadence: bool, until_end: bool, chunk: int,
                     K: int) -> None:
    if cadence and until_end and chunk % K:
        raise ValueError(
            f"a chunk of {chunk} rounds is not a multiple of merge_every="
            f"{K}: chunks that stand in for one dispatch to the end would "
            "merge on other rounds than that dispatch")


def _add_pending(sums, vmin, vmax, hist, pend_sums, pend_vmin, pend_vmax,
                 pend_hist):
    """A round's float32 local delta added to the float64 pending slots
    (cast before any arithmetic, as the merge into the running state
    is)."""
    f64 = torch.float64
    return dict(
        pend_sums=pend_sums + sums.to(f64),
        pend_vmin=torch.minimum(pend_vmin, vmin.to(f64).reshape(-1)),
        pend_vmax=torch.maximum(pend_vmax, vmax.to(f64).reshape(-1)),
        pend_hist=None if hist is None else pend_hist + hist.to(f64))


def build_query_loop(*, nb: int, window: int, budget: int, center: float,
                     a: float, b: float, num_groups: int, nbins: int,
                     use_hist: bool, probe: bool, n_words: int,
                     lookahead: int, cover_cap: int, max_rounds: int,
                     chunk: int, refresh_fn: Callable,
                     shard: Optional[ShardInfo] = None,
                     until_end: bool = False):
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

    With ``shard`` the value, group and mask slabs are this rank's row
    slice of every block (:class:`ShardInfo`) and every other buffer and
    the whole carry are replicated: each rank runs the same round on its
    slice, and the fold's sums merge across ranks each round
    (:func:`_fold`). ``shard.merge_every = K > 1`` runs the reference's
    collective cadence: a round adds its local delta to the carry's
    float64 pending slots and the intervals and active mask stay at
    their last merged values (stale by at most K rounds, still
    anytime-valid); the merge (:func:`merge_across_shards`, then the
    refresh and stop test on merged stats) fires at the start of a round
    once K rounds are pending, selection of that round using the active
    mask from before the merge (the round runs even when that merge
    stops the loop, as in the reference), and once more (the flush) when
    the reference's dispatch would exit. The merge is issued at fixed
    positions of the chunk (every K-th round start and the exit) and
    gated on the replicated ``go & (pend_rounds >= K)``. With
    ``until_end=False`` a chunk is one of the reference's dispatches of
    ``chunk`` rounds: it starts with nothing pending and exits merged,
    so the merge schedule follows the chunk. ``until_end=True`` makes
    the chunks stand in for the reference's one dispatch to the end:
    ``chunk`` must be a multiple of K, the pending delta and its rounds
    carry into the next chunk, whose first round start merges them, and
    the flush fires only once ``cond`` is false, so the merges fall on
    the rounds of an unchunked run whatever ``chunk`` is.
    """
    cadence = shard is not None and shard.merge_every > 1
    K = shard.merge_every if shard is not None else 1
    _check_until_end(cadence, until_end, chunk, K)

    def cond(c: QueryLoopCarry) -> torch.Tensor:
        return c.live & (c.pos < nb) & (c.rounds < max_rounds)

    def rows_at(bufs: QueryLoopBuffers, p: torch.Tensor) -> torch.Tensor:
        last = torch.clamp(p - 1, min=0).reshape(1)
        return torch.where(p > 0, bufs.cum_rows.index_select(0, last)[0],
                           0).to(torch.float64)

    def scan(bufs: QueryLoopBuffers, c: QueryLoopCarry, go: torch.Tensor,
             active: torch.Tensor):
        """The round's head and its accounting (twin of
        engine._fused_accounting + ingest + _ScanViews.update_exact):
        returns the fold's lanes, the new cursor and the updated carry
        fields."""
        aw = pack_active_device(active, n_words) if probe else None
        win, ok, flags, blk, tvalid, new_pos, covmask = _round_scan(
            bufs, c.pos, go, aw, nb=nb, window=window, budget=budget,
            probe=probe)
        act_skip = ok & ~flags & covmask
        pres_win = bufs.presence[win]
        tainted = c.tainted | (pres_win & act_skip[:, None]).any(dim=0)
        probes = c.probes
        if probe:
            probes = probes + _probe_cost(flags, c.pos, nb, window, budget,
                                          lookahead, cover_cap)
        # the taken positions are the valid lanes, their blocks blk
        hit = torch.zeros(nb, dtype=torch.int32, device=blk.device)
        hit.index_add_(0, blk, tvalid.to(torch.int32))
        seen_presence = c.seen_presence + (
            bufs.presence[blk] & tvalid[:, None]).sum(dim=0,
                                                     dtype=torch.int32)
        cov = seen_presence >= bufs.presence_total
        cov = cov | ((new_pos >= nb) & ~tainted)
        acct = dict(
            processed=c.processed | (hit > 0), seen_presence=seen_presence,
            tainted=tainted, exact=c.exact | cov,
            blocks_fetched=c.blocks_fetched + tvalid.sum(),
            skipped_static=c.skipped_static + (~ok & covmask).sum(),
            skipped_active=c.skipped_active + act_skip.sum(), probes=probes)
        return blk, tvalid, new_pos, acct

    def body(bufs: QueryLoopBuffers, c: QueryLoopCarry) -> QueryLoopCarry:
        go = cond(c)
        k = c.rounds + 1
        blk, tvalid, new_pos, acct = scan(bufs, c, go, c.active)
        dstate, dhist = _fold(bufs.values, bufs.gids, bufs.mask, blk, tvalid,
                              center, a, b, num_groups, nbins, use_hist,
                              shard)
        state = _merge_f64(c.state, dstate)
        hist = c.hist + dhist.to(torch.float64) if use_hist else None
        # -- CI refresh + stopping condition (engine-supplied) -----------
        lo, hi, est, refreshed, active = refresh_fn(
            k, rows_at(bufs, new_pos), state, hist, acct["tainted"],
            acct["exact"], c.lo, c.hi, c.est, c.refreshed, c.active)
        live = active.any()
        stopped_early = c.stopped_early | (~live & (new_pos < nb))
        new = c._replace(
            pos=new_pos, rounds=k, it=c.it + 1, live=live,
            stopped_early=stopped_early, state=state, hist=hist, lo=lo,
            hi=hi, est=est, refreshed=refreshed, active=active, **acct)
        return _select(go, new, c)

    # -- the collective cadence (shard.merge_every = K > 1) --------------

    def merge_refresh(bufs: QueryLoopBuffers,
                      c: QueryLoopCarry) -> QueryLoopCarry:
        """The merge across ranks of the pending multi-round delta, folded
        into the running state, then the refresh and stop test on merged
        stats at delta index ``c.rounds`` (the rounds the merged state
        covers); the pending slots emptied."""
        ((sums, vmin, vmax, hist),) = merge_across_shards(
            shard, [(c.pend_sums, c.pend_vmin, c.pend_vmax, c.pend_hist)])
        state = merge_moments(c.state,
                              kops.moments_from_sums(sums, vmin, vmax,
                                                     center))
        hist = c.hist + hist if use_hist else None
        lo, hi, est, refreshed, active = refresh_fn(
            c.rounds, rows_at(bufs, c.pos), state, hist, c.tainted,
            c.exact, c.lo, c.hi, c.est, c.refreshed, c.active)
        live = active.any()
        return c._replace(
            live=live,
            stopped_early=c.stopped_early | (~live & (c.pos < nb)),
            state=state, hist=hist, lo=lo, hi=hi, est=est,
            refreshed=refreshed, active=active,
            pend_rounds=torch.zeros_like(c.pend_rounds),
            **_empty_pending(c.pend_sums, c.pend_hist))

    def cadence_body(bufs: QueryLoopBuffers, c: QueryLoopCarry,
                     i: int) -> QueryLoopCarry:
        go = cond(c)
        # the round selects on the mask from before the merge, so its
        # scan and fold do not wait on the collective
        sel_active = c.active
        if i % K == 0 and (i > 0 or until_end):
            c = _select(go & (c.pend_rounds >= K), merge_refresh(bufs, c),
                        c)
        blk, tvalid, new_pos, acct = scan(bufs, c, go, sel_active)
        pend = _add_pending(*_fold_local(
            bufs.values, bufs.gids, bufs.mask, blk, tvalid, center, a, b,
            num_groups, nbins, use_hist), c.pend_sums, c.pend_vmin,
            c.pend_vmax, c.pend_hist)
        new = c._replace(pos=new_pos, rounds=c.rounds + 1, it=c.it + 1,
                         pend_rounds=c.pend_rounds + 1, **acct, **pend)
        return _select(go, new, c)

    def chunk_fn(bufs: QueryLoopBuffers,
                 carry: QueryLoopCarry) -> QueryLoopCarry:
        carry = carry._replace(it=torch.zeros_like(carry.it))
        for i in range(chunk):
            carry = (cadence_body(bufs, carry, i) if cadence
                     else body(bufs, carry))
        if cadence:  # the flush: a dispatch exits merged
            flush = carry.pend_rounds > 0
            if until_end:
                flush = flush & ~cond(carry)
            carry = _select(flush, merge_refresh(bufs, carry), carry)
        return carry

    return chunk_fn, cond


# ---------------------------------------------------------------------------
# Shared passes: several queries' slots, each on its own cursor
# ---------------------------------------------------------------------------


def fused_round_multi(mask: torch.Tensor, order_pad: torch.Tensor,
                      static_ok: torch.Tensor, pos: torch.Tensor, values,
                      gids, words, active, *, nb: int, window: int,
                      budget: int, meta, anchors=None):
    """One fused scan round shared by several queries (a
    :class:`repro_torch.serve.FrameServer` pass's host loop). All queries
    share the predicate mask and the static prefilter; each *slot*
    (distinct ``(column, group-by)`` over the shared filters) advances its
    OWN cursor through its own budgeted selection and folds its own
    columns, so every slot's scan replays its solo run whatever else is
    co-resident. Each query adds one row to its slot's stack of masks;
    the slot selects with the union over its rows.

    Args (tensors on one device unless noted):
      mask: ``(nb, block_rows)`` shared predicate*valid mask (f32);
      order_pad: ``(nb + window,)`` int32 scan order with a WRAP-FILLED
        tail (``order[:window]``): every slot reads it from its own
        ``pos % nb``;
      static_ok: ``(nb,)`` bool static prefilter;
      pos: ``(S,)`` int64 per-slot cursors in pass coordinates (a slot's
        lap is ``[anchors[s], anchors[s] + nb)``);
      values / gids: length-S tuples of ``(nb, block_rows)`` per-slot
        value (f32) / group-code (int32) columns;
      words: length-S tuple of ``(nb, W_s)`` bitmap words (uint32 bits in
        int32): the slot's group bitmap, or an all-ones ``(nb, 1)``
        engagement bitmap for a slot that does not skip on activity (its
        queries then gate selection with one engaged / finished bit);
      active: length-S tuple of ``(Q_s, W_s)`` int32 per-query masks;
      anchors: length-S Python ints (None: all zero, a static batch).

    ``meta`` is a length-S tuple of per-slot ``(num_groups, nbins,
    use_hist, a, b, center)``. The head (:func:`repro_torch.kernels.ops.
    round_select` with the stack, the slot's lap end and ``wrap``) gives
    the union's selection and the fold's lanes; the multi-query probe
    (:func:`repro_torch.kernels.ops.active_blocks_multi`, one launch a
    slot) gives the per-query verdicts over the same window. The caller
    does not advance slots that are lapped or fully finished (the round
    of a finished slot covers ground without selecting).

    Returns ``(states, hists, flag_stacks, oks, new_pos)``: per-slot
    float32 mergeable deltas (``hists[s]`` None without a histogram),
    per-slot ``(Q_s, window)`` bool per-query verdicts, per-slot
    ``(window,)`` static verdicts and the ``(S,)`` int64 advanced
    cursors, all on the device.
    """
    S = len(meta)
    anchors = tuple(anchors) if anchors is not None else (0,) * S
    dev = order_pad.device
    go = torch.ones((), dtype=torch.bool, device=dev)
    offs = torch.arange(window, dtype=torch.int64, device=dev)
    states, hists, flag_stacks, oks, new_positions = [], [], [], [], []
    for s, (num_groups, nbins, use_hist, a, b, center) in enumerate(meta):
        p = pos[s]
        ok, _, new_p, blk, tvalid = kops.round_select(
            order_pad, static_ok, words[s], active[s], p, go, nb=nb,
            window=window, budget=budget, probe=True,
            lap_end=anchors[s] + nb, wrap=True)
        win = order_pad[torch.remainder(p, nb) + offs].to(torch.int32)
        act = kops.active_blocks_multi(words[s], active[s], win=win) > 0
        st, h = _fold(values[s], gids[s], mask, blk, tvalid, center, a, b,
                      num_groups, nbins, use_hist)
        states.append(st)
        hists.append(h)
        flag_stacks.append(ok[None, :] & act)
        oks.append(ok)
        new_positions.append(new_p)
    return (tuple(states), tuple(hists), tuple(flag_stacks), tuple(oks),
            torch.stack(new_positions))


class SlotSpec(NamedTuple):
    """Static per-slot configuration of the pass loop."""

    num_groups: int
    nbins: int
    use_hist: bool
    a: float
    b: float
    center: float
    probe: bool
    n_words: int


class PassLoopBuffers(NamedTuple):
    """Device-resident inputs of the pass loop; the per-slot fields are
    length-S tuples. A captured chunk reads them where they are:
    ``order_pad`` and ``cum_rows`` are refilled in place for each pass."""

    mask: torch.Tensor            # (nb, block_rows) shared predicate mask
    order_pad: torch.Tensor       # (nb + window,) i32, wrap-filled
    static_ok: torch.Tensor       # (nb,) bool
    cum_rows: torch.Tensor        # (nb,) i64 cumulative valid rows in order
    values: Tuple[torch.Tensor, ...]          # per-slot value columns
    gids: Tuple[torch.Tensor, ...]            # per-slot group codes
    words: Tuple[torch.Tensor, ...]           # per-slot bitmap words
    presence: Tuple[torch.Tensor, ...]        # per-slot (nb, G_s) bool
    presence_total: Tuple[torch.Tensor, ...]  # per-slot (G_s,) i32


class SlotCarry(NamedTuple):
    """Per-slot scan state inside the pass carry: the slot's own cursor,
    fold, coverage and metrics, the twin of a solo
    :class:`QueryLoopCarry`'s scan half, so a slot replays its solo run
    whatever else is co-resident."""

    pos: torch.Tensor             # i64 slot cursor (pass coordinates)
    state: MomentState            # f64 (G_s,)
    hist: Optional[torch.Tensor]  # f64 (G_s, K) or None
    seen_presence: torch.Tensor   # (G_s,) i32
    tainted: torch.Tensor         # (G_s,) bool
    exact: torch.Tensor           # (G_s,) bool
    processed: torch.Tensor       # (nb,) bool blocks this slot fetched
    blocks_fetched: torch.Tensor  # i64 scan metrics (slot-local)
    skipped_static: torch.Tensor  # i64
    skipped_active: torch.Tensor  # i64
    probes: torch.Tensor          # i64
    lap_rounds: torch.Tensor      # i64 round the slot's lap ended (-1
                                  # while still inside it)
    # the collective cadence's slots (merge_every > 1, else None; see
    # QueryLoopCarry): this rank's raw delta since the last merge
    pend_sums: Optional[torch.Tensor] = None    # (3, G_s) f64
    pend_vmin: Optional[torch.Tensor] = None    # (G_s,) f64
    pend_vmax: Optional[torch.Tensor] = None    # (G_s,) f64
    pend_hist: Optional[torch.Tensor] = None    # (G_s, K) f64


class PassQueryCarry(NamedTuple):
    """Per-query OptStop state plus its finish-time snapshot: the slot
    keeps scanning for its other queries, so the carry records the
    slot's state and metrics the round the query finishes."""

    lo: torch.Tensor              # (G_s,) f64
    hi: torch.Tensor              # (G_s,) f64
    est: torch.Tensor             # (G_s,) f64
    refreshed: torch.Tensor       # (G_s,) bool
    active: torch.Tensor          # (G_s,) bool
    finished: torch.Tensor        # bool
    stopped_early: torch.Tensor   # bool
    finish_rounds: torch.Tensor   # i64 slot-local rounds at the finish
    finish_pos: torch.Tensor      # i64
    finish_blocks_fetched: torch.Tensor   # i64
    finish_skipped_static: torch.Tensor   # i64
    finish_skipped_active: torch.Tensor   # i64
    finish_probes: torch.Tensor           # i64
    snap_counts: torch.Tensor     # (G_s,) f64 slot counts at the finish
    snap_exact: torch.Tensor      # (G_s,) bool
    snap_tainted: torch.Tensor    # (G_s,) bool


class PassCarry(NamedTuple):
    """The pass loop's state: the shared round clock and liveness, and
    per-slot / per-query carries."""

    rounds: torch.Tensor          # i64 pass rounds (the shared clock)
    it: torch.Tensor              # i64 rounds run inside the current chunk
    n_live: torch.Tensor          # i64 unfinished queries across slots
    slots: Tuple[SlotCarry, ...]
    queries: Tuple[Tuple[PassQueryCarry, ...], ...]  # [slot][query]
    pend_rounds: Optional[torch.Tensor] = None       # i64 rounds since the
                                                     # last merge (cadence)


def slot_nonfinite(carry: PassCarry) -> torch.Tensor:
    """The NaN sentinel on the device: ``(S,)`` bool, True where a slot's
    folded state is poisoned (non-finite count / mean / m2, NaN min / max,
    or non-finite histogram mass). ``vmin`` / ``vmax`` are legitimately
    ``±inf`` for groups no row has touched, so only NaN counts there."""
    flags = []
    for slot in carry.slots:
        st = slot.state
        bad = (~torch.isfinite(st.count) | ~torch.isfinite(st.mean)
               | ~torch.isfinite(st.m2) | torch.isnan(st.vmin)
               | torch.isnan(st.vmax))
        if slot.hist is not None:
            bad = bad | ~torch.isfinite(slot.hist).all(dim=-1)
        flags.append(bad.any())
    return torch.stack(flags)


def carry_nonfinite_slots(carry: PassCarry) -> Tuple[bool, ...]:
    """Host-side NaN sentinel over a pass carry: one flag per slot
    (:func:`slot_nonfinite`), read in one device-to-host copy. The
    serving layer quarantines a poisoned slot at a chunk boundary
    without looking at its co-resident slots."""
    return tuple(bool(v) for v in slot_nonfinite(carry).cpu().tolist())


def _any_unfinished(queries) -> torch.Tensor:
    return functools.reduce(torch.logical_or,
                            [~qc.finished for qc in queries])


def build_pass_loop(*, nb: int, window: int, budget: int, lookahead: int,
                    cover_cap: int, max_rounds: int, chunk: int,
                    slot_specs: Sequence[SlotSpec],
                    refresh_fns: Sequence[Sequence[Callable]],
                    anchors: Optional[Sequence[int]] = None,
                    round_offsets: Optional[Sequence[int]] = None,
                    row_offsets: Optional[Sequence[int]] = None,
                    shard: Optional[ShardInfo] = None,
                    until_end: bool = False):
    """Build the device-resident loop of one shared pass (S slots, each
    with its own queries and its OWN cursor walk).

    Returns ``(chunk_fn, cond)``. ``chunk_fn(bufs: PassLoopBuffers,
    carry: PassCarry) -> PassCarry`` enqueues ``chunk`` pass rounds with
    nothing read back on the host, so it can be captured as one CUDA
    graph; ``cond(carry)`` is the device bool "some slot can still
    progress, rounds < max_rounds and some query is unfinished" (the
    reference's while-loop condition). Each round computes ``cond`` on
    the card as its ``go``; a round whose ``go`` is false changes
    nothing, so results do not depend on ``chunk``.

    Every slot advances on its own each pass round: the round head at its
    own cursor, with a stack of its queries' masks (the union) over its
    lap and a wrapped window, the fold, the float64 merge and the
    coverage / taint / metric accounting: the device twin of a solo
    :func:`build_query_loop` run on the scan order rotated to the slot's
    anchor. A slot whose lap ended (``pos >= anchor + nb``) or whose
    queries all finished is frozen in place (``torch.where`` on every
    field). Per-query CI refresh and stop tests use slot-local round and
    row counts; a query's result is snapshotted in its carry the round
    it finishes. ``refresh_fns[s][q]`` has :func:`build_query_loop`'s
    ``refresh_fn`` signature.

    Non-probe slots probe an all-ones ``(nb, 1)`` bitmap with a ``(Q,
    1)`` stack of their queries' ``~finished`` bits. ``anchors[s]`` is
    the slot's admission position in pass coordinates (a static
    argument of the head), ``round_offsets[s]`` the pass rounds before
    it and ``row_offsets[s]`` the rows before its anchor, in pass
    coordinates (rows are periodic in ``nb``, so ``cum_rows`` needs no
    extension); None means all zero (a static batch).

    ``shard`` divides the pass as :func:`build_query_loop` does: every
    slot's value and group slabs and the shared mask are this rank's row
    slices, everything else is replicated, and each round's folds of all
    slots merge across ranks in one :func:`merge_across_shards` (two
    all-reduces a round for the whole pass). ``shard.merge_every = K >
    1`` applies the query loop's collective cadence to the whole pass:
    one replicated ``pend_rounds``, per-slot pending slots, the queries'
    intervals and finished flags refreshed only at merges (selection
    gates on the flags from before the merge: at most K rounds of extra
    blocks for a query that just finished), finish snapshots taken at
    merges, and ``until_end`` as there. The cadence needs every anchor
    at zero: a mid-lap joiner's refresh schedule would be quantized to
    merge boundaries, up to K rounds off its solo run's.
    """
    S = len(slot_specs)
    anchors = tuple(anchors) if anchors is not None else (0,) * S
    round_offsets = (tuple(round_offsets) if round_offsets is not None
                     else (0,) * S)
    row_offsets = (tuple(row_offsets) if row_offsets is not None
                   else (0,) * S)
    lap_ends = tuple(a + nb for a in anchors)
    cadence = shard is not None and shard.merge_every > 1
    K = shard.merge_every if shard is not None else 1
    if cadence and any(a != 0 for a in anchors):
        raise ValueError(
            "mid-scan admission (anchor > 0) does not compose with the "
            "collective cadence (merge_every > 1): a joiner's refresh "
            "schedule would be quantized to merge boundaries, up to K "
            "rounds apart from its solo run's; admit onto a fresh pass "
            "or a merge_every=1 pass")
    _check_until_end(cadence, until_end, chunk, K)

    def cond(c: PassCarry) -> torch.Tensor:
        progressable = functools.reduce(torch.logical_or, [
            (c.slots[s].pos < lap_ends[s]) & _any_unfinished(c.queries[s])
            for s in range(S)])
        return progressable & (c.rounds < max_rounds) & (c.n_live > 0)

    def _stack(spec: SlotSpec, queries) -> torch.Tensor:
        if spec.probe:
            rows = [pack_active_device(qc.active, spec.n_words)
                    for qc in queries]
        else:
            rows = [(~qc.finished).to(torch.int32).reshape(1)
                    for qc in queries]
        return torch.stack(rows)

    def _slot_rows(bufs: PassLoopBuffers, s: int,
                   p_end: torch.Tensor) -> torch.Tensor:
        """Rows the slot's cursor has covered, the f64 ``r`` of its
        refresh: laps of the whole scramble plus ``cum_rows``, rebased
        to the slot's own lap by ``row_offsets[s]``; integer valued, so
        bit for bit a solo run's ``r``."""
        p_end = torch.clamp(p_end, max=lap_ends[s])
        pm1 = p_end - 1
        within = bufs.cum_rows.index_select(
            0, torch.remainder(pm1, nb).reshape(1))[0]
        laps = torch.div(pm1, nb, rounding_mode="floor")
        rows_abs = torch.where(p_end > 0, laps * bufs.cum_rows[nb - 1]
                               + within, 0)
        return (rows_abs - row_offsets[s]).to(torch.float64)

    def scan(bufs: PassLoopBuffers, c: PassCarry, go: torch.Tensor,
             sel_queries):
        """Every slot's head (with the stack of ``sel_queries``' masks),
        its fold's lanes and its accounting, a slot frozen unless live.
        Returns per slot ``(slot_live, blk, tvalid, new carry fields)``."""
        k = c.rounds + 1
        offs = torch.arange(window, dtype=torch.int64, device=k.device)
        out = []
        for s, spec in enumerate(slot_specs):
            sc, le = c.slots[s], lap_ends[s]
            # a slot whose lap ended or whose queries all finished is
            # frozen: its solo twin has left its loop
            slot_live = go & (sc.pos < le) & _any_unfinished(c.queries[s])
            ok, flags, new_pos, blk, tvalid = kops.round_select(
                bufs.order_pad, bufs.static_ok, bufs.words[s],
                _stack(spec, sel_queries[s]), sc.pos, slot_live, nb=nb,
                window=window, budget=budget, probe=True, lap_end=le,
                wrap=True)
            win = bufs.order_pad[torch.remainder(sc.pos, nb) + offs]
            covmask = offs < (new_pos - sc.pos)
            act_skip = ok & ~flags & covmask
            presence = bufs.presence[s]
            tainted = sc.tainted | (presence[win]
                                    & act_skip[:, None]).any(dim=0)
            probes = sc.probes
            if spec.probe:
                probes = probes + _probe_cost(flags, sc.pos, le, window,
                                              budget, lookahead, cover_cap)
            hit = torch.zeros(nb, dtype=torch.int32, device=k.device)
            hit.index_add_(0, blk, tvalid.to(torch.int32))
            seen_presence = sc.seen_presence + (
                presence[blk] & tvalid[:, None]).sum(dim=0,
                                                     dtype=torch.int32)
            cov = seen_presence >= bufs.presence_total[s]
            cov = cov | ((new_pos >= le) & ~tainted)
            acct = dict(
                pos=new_pos, seen_presence=seen_presence, tainted=tainted,
                exact=sc.exact | cov, processed=sc.processed | (hit > 0),
                blocks_fetched=sc.blocks_fetched + tvalid.sum(),
                skipped_static=sc.skipped_static + (~ok & covmask).sum(),
                skipped_active=sc.skipped_active + act_skip.sum(),
                probes=probes,
                lap_rounds=torch.where((sc.pos < le) & (new_pos >= le), k,
                                       sc.lap_rounds))
            out.append((slot_live, blk, tvalid, acct))
        return out

    def local_folds(bufs: PassLoopBuffers, lanes):
        return [_fold_local(bufs.values[s], bufs.gids[s], bufs.mask, blk,
                            tvalid, spec.center, spec.a, spec.b,
                            spec.num_groups, spec.nbins, spec.use_hist)
                for s, (spec, (_, blk, tvalid, _)) in enumerate(
                    zip(slot_specs, lanes))]

    def refresh(s: int, k_s, r_s, state, hist, tainted, exact, queries,
                may, acct: dict, n_live):
        """Every query of slot ``s``: its refresh and stop test where
        ``may`` (and it is unfinished), and its finish snapshot the round
        it finishes (``acct``: the slot's fields at that point)."""
        slot_queries = []
        for qi, qc in enumerate(queries):
            nlo, nhi, nest, nrefr, nact = refresh_fns[s][qi](
                k_s, r_s, state, hist, tainted, exact, qc.lo, qc.hi,
                qc.est, qc.refreshed, qc.active)
            keep = qc.finished | ~may
            kept = lambda new, old: torch.where(keep, old, new)
            active = kept(nact, qc.active)
            now_fin = may & ~qc.finished & ~active.any()
            n_live = n_live - now_fin.to(n_live.dtype)
            snap = lambda new, old: torch.where(now_fin, new, old)
            slot_queries.append(PassQueryCarry(
                lo=kept(nlo, qc.lo), hi=kept(nhi, qc.hi),
                est=kept(nest, qc.est),
                refreshed=kept(nrefr, qc.refreshed), active=active,
                finished=qc.finished | now_fin,
                stopped_early=snap(acct["pos"] < lap_ends[s],
                                   qc.stopped_early),
                finish_rounds=snap(k_s, qc.finish_rounds),
                finish_pos=snap(acct["pos"], qc.finish_pos),
                finish_blocks_fetched=snap(acct["blocks_fetched"],
                                           qc.finish_blocks_fetched),
                finish_skipped_static=snap(acct["skipped_static"],
                                           qc.finish_skipped_static),
                finish_skipped_active=snap(acct["skipped_active"],
                                           qc.finish_skipped_active),
                finish_probes=snap(acct["probes"], qc.finish_probes),
                snap_counts=snap(state.count, qc.snap_counts),
                snap_exact=snap(exact, qc.snap_exact),
                snap_tainted=snap(tainted, qc.snap_tainted)))
        return tuple(slot_queries), n_live

    def body(bufs: PassLoopBuffers, c: PassCarry) -> PassCarry:
        go = cond(c)
        k = c.rounds + 1
        lanes = scan(bufs, c, go, c.queries)
        folds = local_folds(bufs, lanes)
        if shard is not None:
            folds = merge_across_shards(shard, folds)
        n_live = c.n_live
        new_slots, new_queries = [], []
        for s, spec in enumerate(slot_specs):
            sc = c.slots[s]
            slot_live, _, _, acct = lanes[s]
            sums, vmin, vmax, dhist = folds[s]
            state = _merge_f64(sc.state, kops.moments_from_sums(
                sums, vmin, vmax, spec.center))
            hist = (sc.hist + dhist.to(torch.float64) if spec.use_hist
                    else None)
            new_slots.append(_select(slot_live, sc._replace(
                state=state, hist=hist, **acct), sc))
            # a frozen slot stops refreshing (a lapped slot's queries
            # still active wait for the host's recovery pass)
            queries, n_live = refresh(
                s, k - round_offsets[s], _slot_rows(bufs, s, acct["pos"]),
                state, hist, acct["tainted"], acct["exact"], c.queries[s],
                slot_live, acct, n_live)
            new_queries.append(queries)
        return c._replace(rounds=torch.where(go, k, c.rounds),
                          it=torch.where(go, c.it + 1, c.it), n_live=n_live,
                          slots=tuple(new_slots),
                          queries=tuple(new_queries))

    # -- the collective cadence (shard.merge_every = K > 1) --------------

    def merge_refresh(bufs: PassLoopBuffers, c: PassCarry) -> PassCarry:
        """Every slot's pending delta merged across ranks (one
        :func:`merge_across_shards` for the pass) into its running state,
        then every unfinished query's refresh and stop test on merged
        stats (delta index ``c.rounds``), with finish snapshots from the
        merged values; the pending slots emptied. A frozen slot carries
        an empty delta, so its merge changes nothing."""
        folds = merge_across_shards(shard, [
            (sc.pend_sums, sc.pend_vmin, sc.pend_vmax, sc.pend_hist)
            for sc in c.slots])
        n_live = c.n_live
        everyone = torch.ones((), dtype=torch.bool, device=n_live.device)
        new_slots, new_queries = [], []
        for s, spec in enumerate(slot_specs):
            sc = c.slots[s]
            sums, vmin, vmax, dhist = folds[s]
            state = merge_moments(sc.state, kops.moments_from_sums(
                sums, vmin, vmax, spec.center))
            hist = sc.hist + dhist if spec.use_hist else None
            new_slots.append(sc._replace(
                state=state, hist=hist,
                **_empty_pending(sc.pend_sums, sc.pend_hist)))
            acct = dict(pos=sc.pos, blocks_fetched=sc.blocks_fetched,
                        skipped_static=sc.skipped_static,
                        skipped_active=sc.skipped_active, probes=sc.probes)
            queries, n_live = refresh(
                s, c.rounds - round_offsets[s], _slot_rows(bufs, s, sc.pos),
                state, hist, sc.tainted, sc.exact, c.queries[s], everyone,
                acct, n_live)
            new_queries.append(queries)
        return c._replace(n_live=n_live, slots=tuple(new_slots),
                          queries=tuple(new_queries),
                          pend_rounds=torch.zeros_like(c.pend_rounds))

    def cadence_body(bufs: PassLoopBuffers, c: PassCarry,
                     i: int) -> PassCarry:
        go = cond(c)
        # selection gates on the flags from before the merge
        sel_queries = c.queries
        if i % K == 0 and (i > 0 or until_end):
            c = _select(go & (c.pend_rounds >= K), merge_refresh(bufs, c),
                        c)
        lanes = scan(bufs, c, go, sel_queries)
        folds = local_folds(bufs, lanes)
        new_slots = []
        for sc, (slot_live, _, _, acct), fold in zip(c.slots, lanes, folds):
            pend = _add_pending(*fold, sc.pend_sums, sc.pend_vmin,
                                sc.pend_vmax, sc.pend_hist)
            new_slots.append(_select(slot_live,
                                     sc._replace(**acct, **pend), sc))
        return c._replace(
            rounds=torch.where(go, c.rounds + 1, c.rounds),
            it=torch.where(go, c.it + 1, c.it), slots=tuple(new_slots),
            pend_rounds=torch.where(go, c.pend_rounds + 1, c.pend_rounds))

    def chunk_fn(bufs: PassLoopBuffers, carry: PassCarry) -> PassCarry:
        carry = carry._replace(it=torch.zeros_like(carry.it))
        for i in range(chunk):
            carry = (cadence_body(bufs, carry, i) if cadence
                     else body(bufs, carry))
        if cadence:  # the flush: a dispatch exits merged
            flush = carry.pend_rounds > 0
            if until_end:
                flush = flush & ~cond(carry)
            carry = _select(flush, merge_refresh(bufs, carry), carry)
        return carry

    return chunk_fn, cond
