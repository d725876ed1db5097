"""FastFrame query engine: OptStop rounds + active scanning over a scramble.

The port of :mod:`repro.aqp.engine`. Per round (Algorithm 5 at block
granularity, §4.2/§4.3):
  1. advance the scan cursor through the shuffled block order, using the
     static predicate bitmap and the (group-bitmap AND active-mask) probe
     to *skip* blocks that cannot help any active view;
  2. fold the selected blocks into the per-group mergeable moment states
     (+ the DKW histogram when the Anderson/DKW bounder is in play);
  3. re-evaluate per-view CIs at delta_k = (6/pi^2) delta_view / k^2 with the
     Theorem-3 ``N+`` upper bound standing in for the unknown view size;
  4. intersect with the running interval, update the active mask from the
     query's stopping condition, and stop when no view is active.

Steps 1–2 have two implementations sharing the same semantics:

  * **fused** (default, ``EngineConfig.fused=True``): the query's value
    column, predicate mask and group codes are materialized once and kept
    on the frame's device; each round is one
    :func:`repro_torch.kernels.fused_scan.fused_round` (activity probe ->
    budgeted selection -> moment / histogram fold), and the host syncs
    once per round to merge the emitted deltas in float64 and run the
    soundness bookkeeping;
  * **per-block reference** (``fused=False``): a Python cursor loop issuing
    separate bitmap-probe and fold calls per lookahead batch with host
    materialization in between — the oracle the fused path is tested
    against.

Steps 1–4 run in one of two loops:

  * **device-resident** (default, ``EngineConfig.device_loop``): the
    whole round — scan, fold, float64 merge, accounting, CI refresh
    (the ``*_device`` bound twins) and stop test — is enqueued on the
    device with no host sync (:func:`repro_torch.kernels.fused_scan.
    build_query_loop`); on the card each chunk of rounds is one captured
    CUDA graph, replayed, and the host reads one scalar a chunk
    (:class:`_DeviceLoop`);
  * **per-round host loop** (``device_loop=False``): the host syncs once
    per round and runs the float64 merge and bound math in numpy — the
    tolerance oracle of the device loop.

The frame's device is explicit: ``FastFrame(scramble, device=None)`` runs
on the card (``"cuda"``) and raises when there is none, unless the caller
asks for ``device="cpu"``, where every kernel is its plain PyTorch version
(and the device loop's chunks run eagerly). Torch always has float64, so
the port needs no 64-bit switch.

Soundness bookkeeping beyond the paper's prose (as in the reference):
  * ``tainted`` views: a view that occurred in an *activity-skipped* block
    no longer sees a clean scan prefix, so its CI is frozen at the last
    clean value (always valid — Theorem 4's intersection is anytime).
  * ``exact`` views: once every block containing a view has been processed
    the aggregate is exact regardless of sampling history; the interval
    collapses to a point. This also guarantees termination.
  * The Exact baseline performs a full sequential sweep with no bitmap
    skipping (the paper's strawman).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.aqp import distributed as adist
from repro_torch.aqp.bitmap import (BlockBitmap, build_bitmap, pack_mask,
                                    unpack_words)
from repro_torch.aqp.query import AggQuery, Expression, QueryResult
from repro_torch.aqp.scramble import Scramble
from repro_torch.core import count_sum
from repro_torch.core.bounders import get_bounder
from repro_torch.core.lru import LRUCache
from repro_torch.core.optstop import delta_schedule, delta_schedule_device
from repro_torch.core.state import (DevStatsBatch, MomentState, StatsBatch,
                                    init_moments_host, merge_hist_host,
                                    merge_moments_host, require_x64, to_host,
                                    x64_enabled)
from repro_torch.device import resolve_device
from repro_torch.kernels import bitmap_active as kbitmap
from repro_torch.kernels import block_agg as kblock
from repro_torch.kernels import fused_fold as kfold
from repro_torch.kernels import fused_scan as kfused
from repro_torch.kernels import ops as kops

_ALPHA = count_sum.ALPHA_DEFAULT
_INT32_MAX = np.iinfo(np.int32).max


def _batched_view_ci(q: AggQuery, sb: StatsBatch, a, b, r, R, dk,
                     known_n, bounder, alpha):
    """One round's CI refresh for a batch of views. Returns ``(lo, hi,
    est)`` arrays of the batch length. ``r`` is the scalar clean-prefix
    row count; N+ and all bounder math are evaluated elementwise over the
    batch."""
    if q.agg == "count":
        clo, chi = count_sum.count_ci(sb.count, r, R, dk)
        return clo, chi, sb.count / max(r, 1) * R
    if known_n:
        alo, ahi = bounder.interval_batch(sb, a, b, R, dk)
    else:
        budget = dk if q.agg == "avg" else dk / 2.0
        npl = count_sum.n_plus(sb.count, r, R, (1 - alpha) * budget)
        alo, ahi = bounder.interval_batch(sb, a, b, npl, alpha * budget)
    if q.agg == "avg":
        return alo, ahi, sb.mean.copy()
    # SUM = COUNT x AVG (paper §4.1)
    cci = count_sum.count_ci(sb.count, r, R, dk / 2.0)
    slo, shi = count_sum.sum_ci(cci, (alo, ahi))
    return slo, shi, sb.mean * (sb.count / max(r, 1)) * R


def _view_ci_device(q: AggQuery, sb: DevStatsBatch, a, b, r, R, dk,
                    known_n, bounder, alpha):
    """Tensor twin of :func:`_batched_view_ci`: the same CI refresh in
    device float64, with ``r`` (clean-prefix rows) and ``dk`` (the
    round's delta) as device scalars — the per-round bound evaluation of
    the device-resident loop."""
    if q.agg == "count":
        clo, chi = count_sum.count_ci_device(sb.count, r, R, dk)
        return clo, chi, sb.count / torch.clamp(r, min=1.0) * R
    if known_n:
        alo, ahi = bounder.interval_batch_device(sb, a, b, R, dk)
    else:
        budget = dk if q.agg == "avg" else dk / 2.0
        npl = count_sum.n_plus_device(sb.count, r, R, (1 - alpha) * budget)
        alo, ahi = bounder.interval_batch_device(sb, a, b, npl,
                                                 alpha * budget)
    if q.agg == "avg":
        return alo, ahi, sb.mean
    # SUM = COUNT x AVG (paper §4.1)
    cci = count_sum.count_ci_device(sb.count, r, R, dk / 2.0)
    slo, shi = count_sum.sum_ci_device(cci, (alo, ahi))
    return slo, shi, sb.mean * (sb.count / torch.clamp(r, min=1.0)) * R


def _exact_estimate(q: AggQuery, counts, means, R):
    """Vectorized point estimate over fully-covered views (elementwise:
    numpy arrays or tensors)."""
    if q.agg == "avg":
        return means
    if q.agg == "count":
        return counts
    return means * counts  # sum


def _round_window(nb: int, lookahead: int, cover_cap: int) -> int:
    """Maximum cursor coverage per fused round: the reference path
    accumulates whole lookahead batches until the cover cap (then clamps
    to ``nb``)."""
    window = lookahead * (-(-cover_cap // lookahead))
    return min(window, lookahead * (-(-nb // lookahead)))


@dataclasses.dataclass
class EngineConfig:
    """Engine tuning knobs (defaults follow the paper's §4.3 settings).

    The port of :class:`repro.aqp.engine.EngineConfig`; the kernel
    backend follows the frame's device, so there is no ``impl`` knob.

    Attributes:
        round_blocks: processed-block budget per OptStop round.
        lookahead_blocks: ActivePeek bitmap-probe batch (paper §4.3).
        sync_lookahead_blocks: ActiveSync probe batch.
        cover_cap_factor: cap on cursor positions covered per round, as a
            multiple of ``round_blocks``.
        hist_bins: DKW histogram resolution (Anderson/DKW bounder only):
            bins of the uniform grid over the column's a-priori range.
        alpha: COUNT/AVG delta split for unknown-``N`` SUM/AVG queries.
        fused: drive scan rounds through
            :func:`repro_torch.kernels.fused_scan.fused_round` (one round
            of kernels + one host sync per round); ``False`` runs the
            per-block reference path. Results are identical either way.
        device_loop: keep the *whole* round loop device-resident — fold,
            float64 state merge, CI refresh (the ``*_device`` bound twins)
            and stop test are enqueued with no host sync; on the card a
            chunk of rounds is one captured CUDA graph, replayed, and the
            host reads one scalar a chunk (:class:`_DeviceLoop`). Requires
            ``fused=True``. ``None`` (default) resolves to ``fused``
            (torch always has float64, where the reference also needs its
            64-bit switch); ``False`` forces the per-round host loop (the
            tolerance oracle). Scan decisions, folds, coverage, soundness
            flags and scan metrics match the host loop exactly; CI
            endpoints and estimates agree to <= 1e-9 (libm against the
            device's transcendentals and reduction orders).
        chunk_rounds: OptStop rounds a chunk enqueues (one CUDA graph
            replay on the card). ``None`` takes
            :data:`GRAPH_CHUNK_ROUNDS` (rounded up to a multiple of
            ``merge_every`` on a sharded cadence loop:
            :func:`default_chunk`), where the reference runs until the
            stop in one dispatch: a replay cannot branch on a device
            value, so a chunk always holds a fixed number of rounds, and
            rounds after the stop inside it change nothing. Chunking
            changes dispatch granularity only, never results, save under
            the collective cadence (``merge_every``).
        sync_every: host-sync (and ``on_sync`` streaming callback)
            cadence in rounds for the device loop; takes precedence over
            ``chunk_rounds`` as the chunk size.
        mat_cache_entries: LRU capacity of EACH of the frame's three
            device materialization caches (value columns, predicate
            masks, group-code columns). Every entry pins one full
            ``(n_blocks, block_rows)`` device buffer.
        shard_rows: run the device-resident round loop with the scan
            DIVIDED over the ranks of the default ``torch.distributed``
            process group, one process a device (shard ``d`` is rank
            ``d``; :mod:`repro_torch.aqp.distributed`): the within-block
            row axis of the value / mask / group-code slabs is sliced
            into ``n_shards`` equal pieces (the block axis whole on every
            rank, rows zero-padded to divide evenly), so each rank folds
            only ``1/n_shards`` of every selected block's rows;
            selection, accounting and bound math stay replicated, and
            each round's fold sums merge across ranks with two
            ``all_reduce`` calls before the moment conversion. Every rank
            runs the same call on the same scramble and gets the same
            result. ``None`` (default) turns it on when the device loop
            is in effect AND a default group of >= 2 ranks is
            initialized; ``True`` requires both (a clear error
            otherwise). Against the single-device loop
            (``tests/test_torch_distributed.py``): scan decisions,
            coverage, taint and scan metrics equal; fold deltas bit for
            bit whenever each rank's float32 partial sums are exact
            (then CIs too); on general data the merge reorders the
            float32 row sum (CIs within 1e-3 relative, the reference's
            bound). Under gloo a chunk's rounds are enqueued (the
            collectives stage the card's tensors through host memory);
            under NCCL a chunk is one captured CUDA graph.
        mesh_shape: explicit shape of the ranks for ``shard_rows`` (e.g.
            ``(2, 2)``): its product must be the group's size, and it
            only orders the ranks (flattened). ``None`` takes every rank
            as a 1-D layout.
        merge_every: collective cadence K of the sharded round loop: the
            merge across ranks fires every K rounds on a replicated round
            counter, with nothing crossing ranks between merges.
            Termination reads merged stats only and is observed at most
            K-1 rounds after the round that would have stopped the K=1
            loop; between merges each rank pools its raw fold delta in
            float64 and the intervals stay at their last merged values
            (stale by at most K rounds, still anytime-valid). A chunk
            asked for (``sync_every`` / ``chunk_rounds``) is one of the
            reference's dispatches of that many rounds and ends with a
            merge, so its host reads and ``on_sync`` snapshots see merged
            stats; the default chunk (:func:`default_chunk`, a multiple
            of K) stands in for the reference's one dispatch to the end:
            pending rounds carry from chunk to chunk and the merges fall
            on that dispatch's rounds. 1 (default) merges every round;
            K > 1 has no effect on an unsharded run.
    """

    round_blocks: int = 64          # processed-block budget per round
    lookahead_blocks: int = 1024    # ActivePeek batch (paper §4.3)
    sync_lookahead_blocks: int = 32 # ActiveSync batch (cache-unfriendly)
    cover_cap_factor: int = 64      # max covered positions per round
    hist_bins: int = 1024
    alpha: float = _ALPHA
    fused: bool = True              # fused scan round (vs per-block)
    device_loop: Optional[bool] = None  # device-resident round loop
                                    # (None = on iff fused)
    chunk_rounds: Optional[int] = None  # rounds per device-loop chunk
    sync_every: Optional[int] = None    # host-sync / streaming cadence
    mat_cache_entries: int = 32     # LRU cap per device materialization
                                    # cache (each entry pins one full
                                    # (n_blocks, block_rows) buffer)
    shard_rows: Optional[bool] = None   # sharded device loop (None = on
                                    # iff the device loop is in effect
                                    # and a group of >= 2 ranks exists)
    mesh_shape: Optional[Tuple[int, ...]] = None  # order of the ranks
    merge_every: int = 1            # collective cadence K of the sharded
                                    # loop (1 = merge folds every round)

    def __post_init__(self):
        if self.merge_every < 1:
            raise ValueError(
                f"EngineConfig(merge_every={self.merge_every}) must be "
                ">= 1 (1 merges the shard folds every round; K > 1 "
                "amortizes the collective set over K rounds)")
        for name in ("chunk_rounds", "sync_every"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"EngineConfig({name}={v}) must be >= 1 "
                                 "(or None)")

    def resolve_device_loop(self) -> bool:
        """Whether the device-resident round loop is in effect, with the
        guard applied for an explicit ``device_loop=True``."""
        if self.device_loop is None:
            return self.fused and x64_enabled()
        if self.device_loop and not self.fused:
            raise ValueError(
                "EngineConfig(device_loop=True) requires fused=True: the "
                "device-resident loop is built on the fused scan round")
        return bool(self.device_loop)

    def resolve_shard_rows(self) -> bool:
        """Whether the device-resident round loop runs divided over the
        ranks of the default process group, with the guards applied for
        an explicit ``shard_rows=True`` (auto is off without a group of
        >= 2 ranks)."""
        n_dev = (math.prod(self.mesh_shape) if self.mesh_shape
                 else adist.world()[0])
        if self.shard_rows is None:
            return n_dev > 1 and self.resolve_device_loop()
        if self.shard_rows:
            if n_dev < 2:
                raise ValueError(
                    "EngineConfig(shard_rows=True) needs >= 2 ranks (one "
                    f"a device), but the resolved layout has {n_dev}: "
                    "initialize a torch.distributed default group of >= "
                    "2 processes (e.g. torchrun --nproc-per-node=N, or "
                    "gloo ranks on the CPU) before building the frame. "
                    "Sharding on one device is pure overhead, so it is "
                    "never enabled implicitly.")
            if not self.resolve_device_loop():
                raise ValueError(
                    "EngineConfig(shard_rows=True) requires the device-"
                    "resident round loop (device_loop=True, which needs "
                    "fused=True): the sharded scan is the device loop run "
                    "on every rank.")
        return bool(self.shard_rows)


class _ScanViews:
    """State determined by one scan signature ``(filters, column,
    group-by)``: the aggregate views' fold / coverage / soundness
    bookkeeping, independent of any one query's stopping condition.

    One instance can back several concurrent queries
    (:class:`repro_torch.serve.FrameServer`): the moment / histogram
    states, coverage, exactness and taint are functions of the scan
    alone, so queries that differ only in aggregate, bounder, delta or
    stopping condition share them. ``use_hist`` overrides the query's own
    need for the histogram (a slot folds it when any of its queries
    needs it)."""

    def __init__(self, frame: "FastFrame", q: AggQuery,
                 use_hist: Optional[bool] = None, anchor: int = 0):
        self.frame = frame
        self.rep_q = q
        sc = frame.scramble
        # Carousel anchor: the pass cursor position where this slot
        # joined a shared walk. Its lap is [anchor, anchor + n_blocks) in
        # pass coordinates, one full rotation of the scan order, so the
        # skipped prefix is covered at the end of the lap. A solo run is
        # the anchor=0 case.
        self.anchor = anchor
        self.lap_end = anchor + sc.n_blocks
        self.gcol, self.G = (None, 1)
        if q.group_by is not None:
            self.gcol, self.G = frame._composite_group(q.group_cols)
        self.value_src, (self.a, self.b) = frame._values_and_bounds(q)
        self.center = 0.5 * (self.a + self.b)
        self.use_hist = use_hist if use_hist is not None else q.needs_hist
        self.static_ok, self.probes0 = frame._static_ok(q)
        self.group_bm = (frame.bitmap(self.gcol) if self.gcol is not None
                         else None)
        self.presence = (unpack_words(self.group_bm.words, self.G)
                         if self.group_bm is not None
                         else np.ones((sc.n_blocks, 1), dtype=bool))
        self.presence_total = self.presence.sum(axis=0)
        self.valid = self.presence_total > 0
        self.state = init_moments_host((self.G,))
        self.hist = (np.zeros((self.G, frame.config.hist_bins), np.float64)
                     if self.use_hist else None)
        self.seen_presence = np.zeros(self.G, dtype=np.int64)
        self.processed = np.zeros(sc.n_blocks, dtype=bool)
        self.exact = self.presence_total == 0   # group code never occurs
        self.tainted = np.zeros(self.G, dtype=bool)
        self.blocks_fetched = 0

    @property
    def counts(self) -> np.ndarray:
        return self.state.count

    def ingest_delta(self, idx: np.ndarray, upd, hupd) -> None:
        """Merge one fused round's mergeable deltas (moments, and the
        histogram when ``use_hist``) for the selected blocks ``idx``
        (float64 on the host)."""
        self.processed[idx] = True
        self.blocks_fetched += len(idx)
        self.state = merge_moments_host(self.state, to_host(upd))
        if self.use_hist:
            self.hist = merge_hist_host(self.hist, hupd)
        self.seen_presence += self.presence[idx].sum(axis=0)

    def ingest_blocks(self, idx: np.ndarray,
                      pad_to: Optional[int] = None) -> None:
        """Host materialize-and-fold path (per-block reference, exact
        sweep and the recovery pass)."""
        self.processed[idx] = True
        self.blocks_fetched += len(idx)
        self.state, self.hist = self.frame._fold_blocks(
            self.rep_q, idx, self.value_src, self.gcol, self.G, self.center,
            self.a, self.b, self.state, self.hist, self.use_hist,
            pad_to=pad_to)
        self.seen_presence += self.presence[idx].sum(axis=0)

    def export_state(self) -> Dict[str, object]:
        """Deep copy of the mutable fold / coverage / soundness state (the
        signature's derived arrays, presence, static_ok and bounds, are
        functions of the frame and are rebuilt by a restored slot).
        Consumed by :class:`repro_torch.serve.checkpoint.PassCheckpoint`."""
        return dict(
            use_hist=self.use_hist, anchor=self.anchor,
            state=MomentState(*(np.array(x) for x in self.state)),
            hist=None if self.hist is None else np.array(self.hist),
            seen_presence=np.array(self.seen_presence),
            processed=np.array(self.processed),
            exact=np.array(self.exact),
            tainted=np.array(self.tainted),
            blocks_fetched=int(self.blocks_fetched))

    def import_state(self, snap: Dict[str, object]) -> None:
        """Overwrite the mutable state from an :meth:`export_state`
        snapshot, arrays copied back verbatim, so a restored scan goes on
        bit for bit where the snapshot was taken."""
        if snap["use_hist"] != self.use_hist or \
                snap["anchor"] != self.anchor:
            raise ValueError("checkpoint does not match this slot's "
                             "scan configuration")
        self.state = MomentState(*(np.array(x) for x in snap["state"]))
        self.hist = (None if snap["hist"] is None
                     else np.array(snap["hist"]))
        self.seen_presence = np.array(snap["seen_presence"])
        self.processed = np.array(snap["processed"])
        self.exact = np.array(snap["exact"])
        self.tainted = np.array(snap["tainted"])
        self.blocks_fetched = int(snap["blocks_fetched"])

    def update_exact(self, pos: Optional[int] = None) -> None:
        """Mark fully-covered views exact; on lap exhaustion (``pos >=
        lap_end``: the cursor walked one full rotation from this slot's
        anchor) also untainted views — an untainted view's unprocessed
        blocks were all static-skipped (zero view rows), whereas a tainted
        view lost member rows to activity skips and must finish via the
        recovery pass."""
        cov = self.seen_presence >= self.presence_total
        if pos is not None and pos >= self.lap_end:
            cov = cov | ~self.tainted
        self.exact |= cov


class _QueryIntervals:
    """One query's OptStop / interval state over a :class:`_ScanViews`
    slot: running intervals, delta schedule, batched CI refresh and the
    active mask from the query's stopping condition."""

    def __init__(self, frame: "FastFrame", q: AggQuery, slot: _ScanViews):
        self.q = q
        self.slot = slot
        self.cfg = frame.config
        self.R = frame.scramble.n_rows
        self.bounder = (get_bounder(q.bounder, rangetrim=q.rangetrim)
                        if q.agg != "count" else None)
        # The per-view delta budget is split over views that can ever emit
        # an interval (presence_total > 0, known a priori from the group
        # bitmap).
        self.delta_view = q.delta / max(int(slot.valid.sum()), 1)
        self.known_n = (not q.filters) and (q.group_by is None)
        self.use_hist = q.needs_hist
        G = slot.G
        # trivial a-priori bounds (valid before any sample is seen)
        if q.agg == "avg":
            lo0, hi0 = slot.a, slot.b
        elif q.agg == "count":
            lo0, hi0 = 0.0, float(self.R)
        else:  # sum
            lo0 = min(0.0, self.R * slot.a)
            hi0 = max(0.0, self.R * slot.b)
        self.lo = np.full(G, lo0)
        self.hi = np.full(G, hi0)
        self.est = np.full(G, slot.center)
        self.refreshed = np.zeros(G, dtype=bool)
        self.active = slot.valid.copy()
        self.finished = False

    def export_state(self) -> Dict[str, object]:
        """Deep copy of the running interval state (the checkpoint twin of
        :meth:`_ScanViews.export_state` for per-query state)."""
        return dict(lo=np.array(self.lo), hi=np.array(self.hi),
                    est=np.array(self.est),
                    refreshed=np.array(self.refreshed),
                    active=np.array(self.active),
                    finished=bool(self.finished))

    def import_state(self, snap: Dict[str, object]) -> None:
        self.lo = np.array(snap["lo"])
        self.hi = np.array(snap["hi"])
        self.est = np.array(snap["est"])
        self.refreshed = np.array(snap["refreshed"])
        self.active = np.array(snap["active"])
        self.finished = bool(snap["finished"])

    def cond_active(self) -> np.ndarray:
        """Stopping-condition activity over EXISTING views only (phantom
        composite codes must not distort orderings)."""
        slot = self.slot
        out = np.zeros(slot.G, dtype=bool)
        v = slot.valid
        if v.any():
            out[v] = self.q.stop.active(self.lo[v], self.hi[v],
                                        self.est[v], slot.counts[v])
        return out

    def refresh(self, k: int, r: int) -> None:
        """Step 3: batched CI refresh at OptStop round ``k`` with ``r``
        clean-prefix rows, then collapse fully-covered views to their
        exact point."""
        slot = self.slot
        dk = delta_schedule(self.delta_view, k)
        counts = slot.counts
        refresh = ~slot.tainted & (counts > 0) & (self.active
                                                  | ~self.refreshed)
        gidx = np.nonzero(refresh)[0]
        if gidx.size:
            sb = StatsBatch.from_state(
                slot.state, slot.hist if self.use_hist else None).take(gidx)
            glo, ghi, gest = _batched_view_ci(
                self.q, sb, slot.a, slot.b, r, self.R, dk, self.known_n,
                self.bounder, self.cfg.alpha)
            self.lo[gidx] = np.maximum(self.lo[gidx], glo)
            self.hi[gidx] = np.minimum(self.hi[gidx], ghi)
            self.est[gidx] = gest
            self.refreshed[gidx] = True
        self.collapse_exact()

    def collapse_exact(self) -> None:
        """Full coverage -> point interval at the exact aggregate."""
        slot = self.slot
        counts = slot.counts
        full = slot.exact & (counts > 0)
        if full.any():
            ex = _exact_estimate(self.q, counts, slot.state.mean, self.R)
            self.lo[full] = self.hi[full] = self.est[full] = ex[full]

    def update_active(self) -> bool:
        """Step 4: recompute the active mask from the stopping condition;
        returns True while any view is still active."""
        self.active = self.cond_active() & ~self.slot.exact & self.slot.valid
        return bool(self.active.any())

    def result(self, rounds: int, pos: int, cum_rows: np.ndarray,
               metrics: Dict[str, int], t0: float,
               stopped_early: bool,
               rows_covered: Optional[int] = None) -> QueryResult:
        """Build the QueryResult from the current slot/query state. The
        arrays are copied (``count_seen`` too, which must not alias the
        slot's live fold state), so the result is a consistent snapshot
        even while a shared scan goes on mutating the slot: the serving
        layer calls this the moment a query finishes. ``rows_covered``
        overrides the prefix-sum lookup for an anchored slot, whose lap
        does not start at cursor position 0."""
        slot = self.slot
        counts = slot.counts
        if rows_covered is None:
            rows_covered = int(cum_rows[pos - 1]) if pos else 0
        return QueryResult(
            group_codes=np.arange(slot.G), estimate=self.est.copy(),
            lo=self.lo.copy(), hi=self.hi.copy(),
            count_seen=counts.copy(),
            nonempty=counts > 0, exact=slot.exact.copy(),
            tainted=slot.tainted.copy(),
            rows_covered=rows_covered,
            blocks_fetched=slot.blocks_fetched,
            blocks_skipped_active=metrics["skipped_active"],
            blocks_skipped_static=metrics["skipped_static"],
            bitmap_probes=metrics["probes"], rounds=rounds,
            wall_time_s=time.perf_counter() - t0,
            stopped_early=stopped_early)


class _FusedScan:
    """Device-resident scan context for one query: assembles the cached
    value column, predicate mask, group codes and bitmap words on the
    frame's device, then drives
    :func:`repro_torch.kernels.fused_scan.fused_round` — one round of
    kernels and one host sync per round.

    Materialization is identical (bitwise) to the per-block path's
    per-round ``_materialize``: predicates and value expressions are
    elementwise, so evaluating them over the full blocked columns and
    gathering on the device yields the same rows."""

    def __init__(self, frame: "FastFrame", q: AggQuery, value_src, gcol,
                 G: int, center: float, a: float, b: float, use_hist: bool,
                 probe: bool, lookahead: int, budget: int, cover_cap: int,
                 static_ok: np.ndarray, group_bm, order: np.ndarray):
        sc = frame.scramble
        nb = sc.n_blocks
        self.window = _round_window(nb, lookahead, cover_cap)
        self.budget = budget
        self.nb = nb
        self.probe = probe
        self.use_hist = use_hist
        self.center = float(center)
        self.a = float(a)
        self.b = float(b)
        self.G = G
        self.nbins = frame.config.hist_bins
        # the round's histogram delta lands here without a sync of its own
        self._hist_host = None
        if use_hist and frame.device.type == "cuda":
            self._hist_host = torch.empty((G, self.nbins),
                                          dtype=torch.float32,
                                          pin_memory=True)

        self.values = frame._device_values(value_src)
        self.gids = frame._device_gids(gcol)
        self.mask = frame._device_mask(q.filters)
        words = (group_bm.words if group_bm is not None
                 else np.zeros((1, 1), np.uint32))
        self.words = frame._put(words.view(np.int32))
        opad = np.zeros(nb + self.window, np.int32)
        opad[:nb] = order
        self.order_pad = frame._put(opad)
        self.static_ok = frame._put(static_ok)
        self._dummy_active = frame._put(np.zeros(words.shape[1], np.int32))
        # the cursor on the device: each round's new_pos is the next
        # round's pos, so nothing is uploaded for it
        self._pos = torch.zeros((), dtype=torch.int64, device=frame.device)
        self._go = torch.ones((), dtype=torch.bool, device=frame.device)

    def round(self, active_words):
        """One fused round from the device cursor (the last round's
        ``new_pos``; 0 at the start). Returns host-side
        ``(moment_delta, hist_delta, ok, flags, new_pos)``
        (``hist_delta`` is None without the histogram).

        The round syncs with the host once. Verdicts, cursor and the
        float32 moment delta come back in one device-to-host copy,
        packed as float64, which holds each of them exactly. The
        histogram delta is copied as float32 into a pinned buffer
        without a sync of its own, ahead of that copy on the same stream,
        so the packed copy's sync covers it (packing it as float64 would
        double the round's largest copy)."""
        aw = active_words if active_words is not None else self._dummy_active
        state, hist, ok, flags, new_pos = kfused.fused_round(
            self.values, self.gids, self.mask, self.words, self.order_pad,
            self.static_ok, self._pos, aw, go=self._go, nb=self.nb,
            window=self.window, budget=self.budget, center=self.center,
            a=self.a, b=self.b, num_groups=self.G, nbins=self.nbins,
            use_hist=self.use_hist, probe=self.probe)
        self._pos = new_pos
        if self._hist_host is not None:
            hist = self._hist_host.copy_(hist, non_blocking=True)
        parts = (ok, flags, new_pos, *state)
        host = torch.cat([t.reshape(-1).to(torch.float64)
                          for t in parts]).cpu().numpy()
        w, G = self.window, self.G
        delta = MomentState(*host[2 * w + 1:].reshape(5, G))
        hdelta = None if hist is None else hist.numpy()
        return (delta, hdelta, host[:w] > 0, host[w:2 * w] > 0,
                int(host[2 * w]))


def _make_device_refresh(q: AggQuery, qci: _QueryIntervals,
                         a: float, b: float, use_hist: bool, R: float,
                         valid: torch.Tensor) -> Callable:
    """Build the per-round CI-refresh + stop-test closure for one query:
    the tensor twin of ``_QueryIntervals.refresh`` + ``collapse_exact`` +
    ``update_active``, with the query's static configuration (bounder,
    delta schedule, stopping condition, ``valid`` mask on the device)
    baked in. Passed as ``refresh_fn`` to
    :func:`repro_torch.kernels.fused_scan.build_query_loop`. A view's CI
    is computed for every lane and kept where the host would have
    refreshed it, so nothing is subset on the host."""
    bounder = qci.bounder
    delta_view = qci.delta_view
    known_n = qci.known_n
    alpha = qci.cfg.alpha
    stop = q.stop

    def refresh_fn(k, r, state, hist, tainted, exact, lo, hi, est,
                   refreshed, active):
        counts = state.count  # f64 in the loop carry
        dk = delta_schedule_device(delta_view, k)
        refresh = ~tainted & (counts > 0) & (active | ~refreshed)
        sb = DevStatsBatch.from_state(state, hist if use_hist else None)
        glo, ghi, gest = _view_ci_device(q, sb, a, b, r, R, dk, known_n,
                                         bounder, alpha)
        lo = torch.where(refresh, torch.maximum(lo, glo), lo)
        hi = torch.where(refresh, torch.minimum(hi, ghi), hi)
        est = torch.where(refresh, gest, est)
        refreshed = refreshed | refresh
        full = exact & (counts > 0)
        ex = _exact_estimate(q, counts, state.mean, R)
        lo = torch.where(full, ex, lo)
        hi = torch.where(full, ex, hi)
        est = torch.where(full, ex, est)
        active = (stop.active_device(lo, hi, est, counts, valid)
                  & ~exact & valid)
        return lo, hi, est, refreshed, active

    return refresh_fn


def _host_copy(x, dtype=None) -> np.ndarray:
    """Writable host copy of a tensor on any device (or of an array): the
    host bookkeeping mutates its arrays in place."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype=dtype)


def _restore_views_from_carry(slot: _ScanViews, state: MomentState, hist,
                              processed, seen_presence, tainted, exact,
                              blocks_fetched, metrics: Dict[str, int],
                              skipped_static, skipped_active) -> None:
    """Copy a device-loop carry's shared fold / coverage / soundness state
    back into a host-side :class:`_ScanViews` + metrics dict, so the
    recovery pass and result construction run the host loop's own code
    on identical state."""
    slot.state = MomentState(*(_host_copy(f, np.float64) for f in state))
    if slot.use_hist:
        slot.hist = _host_copy(hist, np.float64)
    slot.processed = _host_copy(processed, bool)
    slot.seen_presence = _host_copy(seen_presence, np.int64)
    slot.tainted = _host_copy(tainted, bool)
    slot.exact = _host_copy(exact, bool)
    slot.blocks_fetched = int(blocks_fetched)
    metrics["skipped_static"] += int(skipped_static)
    metrics["skipped_active"] += int(skipped_active)


#: Rounds of one device-loop chunk (one CUDA graph replay on the card)
#: when neither ``EngineConfig.chunk_rounds`` nor ``sync_every`` is set.
#: The reference runs until the stop in one dispatch; a graph replay
#: cannot branch on a device value, so the port replays chunks of this
#: many rounds and reads one scalar after each. Rounds after the stop
#: inside a chunk run their kernels on nothing and change no state, so
#: results do not depend on it; it trades those idle rounds (a few ms at
#: most) against one host sync and one replay launch per chunk.
GRAPH_CHUNK_ROUNDS = 16


def default_chunk(merge_every: int = 1) -> int:
    """The rounds of a device-loop chunk nobody asked for:
    :data:`GRAPH_CHUNK_ROUNDS` rounded up to a multiple of the collective
    cadence K, so that chunks standing in for the reference's one
    dispatch to the end merge on its rounds (``build_query_loop(
    until_end=True)``)."""
    return -(-GRAPH_CHUNK_ROUNDS // merge_every) * merge_every

# The kernels a device-loop chunk may launch (the round head and a fold a
# round, a slot a round in a shared pass, and the multi-query probe): a
# graph replay launches what its capture recorded, without calling their
# wrappers, so each replay adds its launches to their counts itself.
_LOOP_KERNELS = (kbitmap.round_select, kblock.block_agg, kfold.fused_fold,
                 kbitmap.active_blocks_multi)


class _ChunkGraph:
    """One chunk of a device-resident loop (the solo query loop's or a
    shared pass's) captured as a ``torch.cuda.CUDAGraph`` and replayed:
    the one piece of code that holds a chunk to "no host sync".

    The first :meth:`load` captures: one eager chunk on a *copy* of the
    carry on a side stream, under ``torch.cuda.set_sync_debug_mode(
    "error")`` (the enqueue must not sync; it also makes the round head's
    look-back buffer for that stream outside the capture), then the
    capture of ``chunk_fn`` on the same stream, whose replay advances the
    carry's own tensors (the static carry) in place. Later loads copy a
    carry into the static one. A failed capture raises: there is no eager
    or host-loop fallback. Each :meth:`replay` adds the launches its
    capture recorded to the kernels' counts (and, for a sharded chunk
    under NCCL, the all-reduces to ``fused_scan.COLLECTIVES``). The
    instance owns its graph and the graph's memory pool.

    A sharded chunk is captured only when its group's collectives can be
    (NCCL): ``shard`` is its :class:`~repro_torch.kernels.fused_scan.
    ShardInfo`, and the group's communicator is set up by one eager
    all-reduce before the warm-up."""

    def __init__(self, chunk_fn: Callable, bufs, device: torch.device,
                 shard: Optional[kfused.ShardInfo] = None):
        self._chunk_fn = chunk_fn
        self._bufs = bufs
        self._shard = shard
        self.device = device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static = None
        self._replay_launches: Tuple[int, ...] = ()
        self._replay_collectives: Tuple[int, int] = (0, 0)
        self.capture_s = 0.0   # host seconds of the warm-up and capture
        self.replays = 0

    def load(self, carry):
        """Make ``carry``'s values the static carry's (capturing on the
        first call, when ``carry``'s own tensors become the static carry);
        returns the static carry."""
        if self.graph is None:
            self.capture(carry)
        else:
            for dst, src in zip(kfused.carry_leaves(self.static),
                                kfused.carry_leaves(carry)):
                dst.copy_(src)
        return self.static

    def replay(self) -> None:
        self.graph.replay()
        for k, n in zip(_LOOP_KERNELS, self._replay_launches):
            k.launches += n
        coll = kfused.COLLECTIVES
        coll["calls"] += self._replay_collectives[0]
        coll["bytes"] += self._replay_collectives[1]
        self.replays += 1

    def capture(self, carry) -> None:
        """Capture one chunk as a CUDA graph whose replay advances the
        static carry (``carry``'s own tensors) in place."""
        t0 = time.perf_counter()
        if self._shard is not None:  # the communicator, outside capture
            kfused.merge_across_shards(self._shard, [
                tuple(torch.zeros((3, 1), device=self.device)
                      for _ in range(3)) + (None,)])
        clone = kfused.carry_map(torch.clone, carry)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(stream):
            torch.cuda.set_sync_debug_mode("error")
            try:  # warm-up: the same enqueue, on a copy, must not sync
                self._chunk_fn(self._bufs, clone)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        warm = tuple(k.launches for k in _LOOP_KERNELS)
        coll = kfused.COLLECTIVES
        warm_coll = (coll["calls"], coll["bytes"])
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = self._chunk_fn(self._bufs, carry)
            for dst, src in zip(kfused.carry_leaves(carry),
                                kfused.carry_leaves(out)):
                dst.copy_(src)
        # the capture launched nothing: what it recorded runs per replay
        self._replay_launches = tuple(
            k.launches - n for k, n in zip(_LOOP_KERNELS, warm))
        for k, n in zip(_LOOP_KERNELS, warm):
            k.launches = n
        self._replay_collectives = (coll["calls"] - warm_coll[0],
                                    coll["bytes"] - warm_coll[1])
        coll["calls"], coll["bytes"] = warm_coll
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.graph = graph
        self.static = carry
        self.capture_s += time.perf_counter() - t0


class _DeviceLoop:
    """Device-resident round-loop driver for one query: assembles the
    :class:`~repro_torch.kernels.fused_scan.QueryLoopBuffers`, builds the
    chunk function, runs chunks of ``sync_every`` / ``chunk_rounds`` /
    :func:`default_chunk` rounds (one scalar read on the host after
    each), and writes the final carry back into the host-side
    :class:`_ScanViews` / :class:`_QueryIntervals` (one packed copy) so
    the recovery pass and result construction are the code the host loop
    uses.

    On the card the first run captures one chunk as a CUDA graph
    (:class:`_ChunkGraph`: an eager warm-up chunk on a copy of the carry
    under ``torch.cuda.set_sync_debug_mode("error")``, then the capture);
    each chunk is then one replay. The instance is cached on the frame
    (``FastFrame.device_loops``) and owns its graph and the graph's
    memory pool, which go with it when the cache evicts it. On the CPU
    the same chunk function runs eagerly.

    ``shards`` (:class:`repro_torch.aqp.distributed.BlockShards`) divides
    the scan over the ranks: the value, group and mask slabs are this
    rank's row slices and the fold merges across ranks. Whether a chunk
    is captured then follows the group's backend (:attr:`backend`):
    under NCCL it is, collectives included; under gloo, whose
    collectives stage the card's tensors through host memory, the
    chunk's rounds are enqueued eagerly, as on the CPU. :attr:`captured`
    says which ran."""

    def __init__(self, frame: "FastFrame", q: AggQuery, slot: _ScanViews,
                 qci: _QueryIntervals, probe: bool, lookahead: int,
                 max_rounds: int,
                 shards: Optional[adist.BlockShards] = None):
        cfg = frame.config
        nb = frame.scramble.n_blocks
        cover_cap = cfg.round_blocks * cfg.cover_cap_factor
        window = _round_window(nb, lookahead, cover_cap)
        dev = frame.device
        self.device = dev
        self.nb = nb
        self.G = slot.G
        self.use_hist = slot.use_hist
        self.nbins = cfg.hist_bins
        self.shards = shards
        self.cadence = shards is not None and shards.merge_every > 1
        asked = cfg.sync_every or cfg.chunk_rounds
        self.chunk = asked or default_chunk(shards.merge_every
                                            if self.cadence else 1)
        self.backend = shards.backend if shards is not None else None
        self.capturable = dev.type == "cuda" and (shards is None
                                                   or self.backend == "nccl")
        words = (slot.group_bm.words if probe
                 else np.zeros((1, 1), np.uint32))
        # run-independent buffers; order_pad / cum_rows are refilled in
        # place by set_order (a captured graph reads them where they are);
        # sharded, the three slabs are this rank's row slices
        self.bufs = kfused.QueryLoopBuffers(
            values=frame._device_values(slot.value_src, shards),
            gids=frame._device_gids(slot.gcol, shards),
            mask=frame._device_mask(q.filters, shards),
            words=frame._put(words.view(np.int32)),
            order_pad=torch.zeros(nb + window, dtype=torch.int32,
                                  device=dev),
            static_ok=frame._put(slot.static_ok),
            presence=frame._put(slot.presence),
            presence_total=frame._put(slot.presence_total.astype(np.int32)),
            cum_rows=torch.zeros(nb, dtype=torch.int64, device=dev))
        refresh_fn = _make_device_refresh(
            q, qci, slot.a, slot.b, qci.use_hist, float(qci.R),
            frame._put(slot.valid))
        self._chunk_fn, self._cond = kfused.build_query_loop(
            nb=nb, window=window, budget=cfg.round_blocks,
            center=float(slot.center), a=float(slot.a), b=float(slot.b),
            num_groups=slot.G, nbins=cfg.hist_bins, use_hist=slot.use_hist,
            probe=probe, n_words=words.shape[1], lookahead=lookahead,
            cover_cap=cover_cap, max_rounds=max_rounds, chunk=self.chunk,
            refresh_fn=refresh_fn,
            shard=shards.info if shards is not None else None,
            until_end=asked is None)
        self._graph = _ChunkGraph(self._chunk_fn, self.bufs, dev,
                                  shards.info if shards is not None
                                  else None)
        self.chunks = 0    # chunks run on a query's carry
        self.syncs = 0     # host reads of the loop's state
        self.last_rounds = 0  # rounds the last run's loop took

    def set_order(self, order: np.ndarray, cum_rows: np.ndarray) -> None:
        """Install this run's scan order (the only run-dependent input)."""
        self.bufs.order_pad[:self.nb].copy_(
            torch.from_numpy(order.astype(np.int32)))
        self.bufs.cum_rows.copy_(torch.from_numpy(cum_rows.astype(np.int64)))

    def init_carry(self, slot: _ScanViews,
                   qci: _QueryIntervals) -> kfused.QueryLoopCarry:
        """Fresh carry from the (just-initialized) host-side state."""
        dev = self.device
        f64 = lambda x: torch.as_tensor(np.asarray(x, np.float64),
                                        device=dev)
        put = lambda x: torch.as_tensor(np.asarray(x), device=dev)
        i64 = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
        pend = {}
        if self.cadence:  # the cadence's pending slots, empty
            G = slot.G
            pend = dict(
                pend_sums=torch.zeros((3, G), dtype=torch.float64,
                                      device=dev),
                pend_vmin=torch.full((G,), np.inf, dtype=torch.float64,
                                     device=dev),
                pend_vmax=torch.full((G,), -np.inf, dtype=torch.float64,
                                     device=dev),
                pend_hist=(torch.zeros((G, self.nbins), dtype=torch.float64,
                                       device=dev)
                           if self.use_hist else None),
                pend_rounds=i64(0))
        return kfused.QueryLoopCarry(
            pos=i64(0), rounds=i64(0), it=i64(0),
            live=torch.tensor(True, device=dev),
            stopped_early=torch.tensor(False, device=dev),
            state=MomentState(*(f64(f) for f in slot.state)),
            hist=f64(slot.hist) if self.use_hist else None,
            processed=put(slot.processed),
            seen_presence=put(slot.seen_presence.astype(np.int32)),
            tainted=put(slot.tainted), exact=put(slot.exact),
            lo=f64(qci.lo), hi=f64(qci.hi), est=f64(qci.est),
            refreshed=put(qci.refreshed), active=put(qci.active),
            blocks_fetched=i64(slot.blocks_fetched),
            skipped_static=i64(0), skipped_active=i64(0), probes=i64(0),
            **pend)

    def _done(self, c: kfused.QueryLoopCarry,
              on_sync: Optional[Callable]) -> bool:
        """The one host read after a chunk: whether the loop is over
        (``~live | pos >= nb | rounds >= max_rounds``), with the snapshot
        ``on_sync`` streams packed into the same copy."""
        head = [(~self._cond(c)).to(torch.float64), c.rounds, c.pos, c.live]
        parts = [t.reshape(1).to(torch.float64) for t in head]
        if on_sync is not None:
            parts += [c.lo, c.hi, c.est]
        host = torch.cat(parts).cpu().numpy()
        self.syncs += 1
        if on_sync is not None:
            G = self.G
            on_sync(dict(rounds=int(host[1]), pos=int(host[2]),
                         lo=host[4:4 + G].copy(),
                         hi=host[4 + G:4 + 2 * G].copy(),
                         est=host[4 + 2 * G:].copy(),
                         live=bool(host[3])))
        return bool(host[0])

    def run(self, carry: kfused.QueryLoopCarry,
            on_sync: Optional[Callable] = None) -> kfused.QueryLoopCarry:
        """Run chunks until the loop terminates; after each the host reads
        one packed scalar (plus the streaming snapshot for ``on_sync``
        subscribers)."""
        require_x64("the device-resident round loop", *carry.state,
                    carry.hist, carry.lo, carry.hi, carry.est)
        if self.capturable:
            return self._run_graph(carry, on_sync)
        while True:
            carry = self._chunk_fn(self.bufs, carry)
            self.chunks += 1
            if self._done(carry, on_sync):
                return carry

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        return self._graph.graph

    @property
    def captured(self) -> bool:
        """Whether the loop's chunks run as a captured graph's replays."""
        return self._graph.graph is not None

    @property
    def _static(self):
        return self._graph.static

    @property
    def replays(self) -> int:
        """Chunks run as graph replays."""
        return self._graph.replays

    def _capture(self, carry: kfused.QueryLoopCarry) -> None:
        self._graph.capture(carry)

    def _run_graph(self, carry, on_sync):
        static = self._graph.load(carry)
        while True:
            self._graph.replay()
            self.chunks += 1
            if self._done(static, on_sync):
                return static

    def writeback(self, carry: kfused.QueryLoopCarry, slot: _ScanViews,
                  qci: _QueryIntervals,
                  metrics: Dict[str, int]) -> Tuple[int, int, bool]:
        """Copy the final carry into the host-side bookkeeping in one
        packed device-to-host copy (float64 holds every field exactly);
        after this, recovery / result construction run the host loop's
        code on identical state. Returns ``(pos, rounds,
        stopped_early)``."""
        h, _ = kfused.carry_to_host(carry)
        self.syncs += 1
        self.last_rounds = int(h.rounds)
        _restore_views_from_carry(
            slot, h.state, h.hist, h.processed, h.seen_presence, h.tainted,
            h.exact, h.blocks_fetched, metrics, h.skipped_static,
            h.skipped_active)
        metrics["probes"] += int(h.probes)
        qci.lo, qci.hi, qci.est = (np.array(x) for x in (h.lo, h.hi, h.est))
        qci.refreshed, qci.active = np.array(h.refreshed), np.array(h.active)
        return int(h.pos), int(h.rounds), bool(h.stopped_early)


class FastFrame:
    """Sampling-optimized in-memory column store (paper §4).

    Wraps a :class:`~repro_torch.aqp.scramble.Scramble` with block bitmap
    indexes and the OptStop round loop; :meth:`run` answers one
    :class:`~repro_torch.aqp.query.AggQuery` with anytime-valid intervals.

    Args:
        scramble: the scramble (numpy, on the host).
        config: engine knobs (:class:`EngineConfig`).
        device: where the column slabs live and the kernels run. ``None``
            means the card (``"cuda"``); without CUDA that raises unless
            ``device="cpu"`` is passed.
    """

    def __init__(self, scramble: Scramble, config: EngineConfig = None,
                 device=None):
        self.device = resolve_device(device)
        self.scramble = scramble
        self.config = config or EngineConfig()
        self._bitmaps: Dict[str, BlockBitmap] = {}
        self._static_cache: Dict[Tuple, np.ndarray] = {}
        self._valid_counts = scramble.valid.sum(axis=1).astype(np.int64)
        # device-resident materialization caches, keyed by the components
        # of the (filters, column, group-by) scan signature (+ whether the
        # buffer is this rank's row slices); LRU-bounded
        # (config.mat_cache_entries). In-flight scans hold direct
        # references, so eviction only drops the cache's pin.
        cap = self.config.mat_cache_entries
        self._dev_masks = LRUCache(cap)
        self._dev_values = LRUCache(cap)
        self._dev_gids = LRUCache(cap)
        # device-resident round loops (each with its captured CUDA graph
        # on the card), keyed by the query's static identity: a repeat
        # query replays its graph instead of building and capturing anew
        self.device_loops = LRUCache(cap)
        self._block_shards: Optional[adist.BlockShards] = None
        self._shards_resolved = False

    def block_shards(self) -> Optional[adist.BlockShards]:
        """The frame's divided-scan layout over the default group's ranks,
        or ``None`` when sharding is off (``EngineConfig.shard_rows``
        resolves False). Built once, so every run and serving pass of the
        frame shards alike."""
        if not self._shards_resolved:
            shards = None
            if self.config.resolve_shard_rows():
                mesh = adist.make_aqp_mesh(self.config.mesh_shape)
                shards = adist.build_block_shards(
                    self.scramble.n_blocks, mesh,
                    self.scramble.valid.shape[1],
                    merge_every=self.config.merge_every, device=self.device)
            self._block_shards = shards
            self._shards_resolved = True
        return self._block_shards

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """Copy a host array to the frame's device."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _active_words(self, active: np.ndarray) -> torch.Tensor:
        """The packed active-group mask on the frame's device, uploaded
        once per round from pinned memory without a stream sync (the
        round's one sync is its result copy)."""
        t = torch.from_numpy(pack_mask(active).view(np.int32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- index plumbing ------------------------------------------------------

    def bitmap(self, column: str) -> BlockBitmap:
        if column not in self._bitmaps:
            self._bitmaps[column] = build_bitmap(self.scramble, column)
        return self._bitmaps[column]

    def _composite_group(self, cols: Tuple[str, ...]) -> Tuple[str, int]:
        """Synthesize (and cache) a composite group-code column.

        Raises:
            ValueError: when the cardinality product exceeds the int32
                group-code space the kernels operate in.
        """
        if len(cols) == 1:
            return cols[0], self.scramble.categorical[cols[0]]
        name = "__grp_" + "_".join(cols)
        if name not in self.scramble.columns:
            card = 1
            for c in cols:
                card *= int(self.scramble.categorical[c])
            if card > _INT32_MAX:
                raise ValueError(
                    f"composite GROUP BY over {cols} has cardinality "
                    f"product {card} > int32 max ({_INT32_MAX}); group "
                    "codes would wrap and merge unrelated groups. Reduce "
                    "the grouping cardinality (e.g. pre-bucket a column).")
            codes = np.zeros_like(self.scramble.columns[cols[0]],
                                  dtype=np.int64)
            for c in cols:
                cc = self.scramble.categorical[c]
                codes = codes * cc + self.scramble.columns[c]
            self.scramble.columns[name] = codes.astype(np.int32)
            self.scramble.categorical[name] = card
        return name, self.scramble.categorical[name]

    def _static_ok(self, q: AggQuery) -> Tuple[np.ndarray, int]:
        """Block-level predicate prefilter from categorical eq/isin filters
        (available to every approximate strategy, incl. Scan — §5.2)."""
        key = tuple(f.key() for f in q.filters
                    if f.categorical_eq and f.column in
                    self.scramble.categorical)
        if not key:
            return np.ones(self.scramble.n_blocks, dtype=bool), 0
        if key in self._static_cache:
            return self._static_cache[key], 0
        ok = np.ones(self.scramble.n_blocks, dtype=bool)
        probes = 0
        for f in q.filters:
            if not (f.categorical_eq and f.column in
                    self.scramble.categorical):
                continue
            bm = self.bitmap(f.column)
            cmask = np.zeros(bm.cardinality, dtype=bool)
            vals = np.atleast_1d(np.asarray(f.value))
            cmask[vals] = True
            hit = kops.active_blocks(self._put(bm.words.view(np.int32)),
                                     self._put(pack_mask(cmask)
                                               .view(np.int32)))
            ok &= hit.cpu().numpy() > 0
            probes += self.scramble.n_blocks
        self._static_cache[key] = ok
        return ok, probes

    # -- value / mask materialization -----------------------------------------

    def _values_and_bounds(self, q: AggQuery):
        if q.agg == "count":
            return None, (0.0, 1.0)
        if isinstance(q.column, Expression):
            return q.column, q.column.derived_bounds(self.scramble.catalog)
        return q.column, self.scramble.catalog[q.column]

    def _put_blocks(self, arr: np.ndarray,
                    shards: Optional[adist.BlockShards]) -> torch.Tensor:
        """A (n_blocks, block_rows) slab on the frame's device: this
        rank's row slices when ``shards`` is set, whole otherwise."""
        if shards is not None:
            return shards.put_blocks(arr)
        return self._put(arr)

    def _device_mask(self, filters, shards=None) -> torch.Tensor:
        """Device-resident (n_blocks, block_rows) f32 predicate*valid
        mask, cached by the filters' key (per sharded / unsharded
        layout)."""

        def build():
            sc = self.scramble
            mask = sc.valid.copy()
            for f in filters:
                mask &= f.evaluate(sc.columns)
            return self._put_blocks(mask.astype(np.float32), shards)

        return self._dev_masks.get_or_build(
            (tuple(f.key() for f in filters), shards is not None), build)

    def _device_values(self, value_src, shards=None) -> torch.Tensor:
        """Device-resident f32 value column (zeros for COUNT), cached by
        the column name / Expression (per sharded / unsharded layout)."""

        def build():
            sc = self.scramble
            if isinstance(value_src, Expression):
                values = value_src.evaluate(sc.columns)
            elif isinstance(value_src, str):
                values = sc.columns[value_src].astype(np.float32)
            else:  # COUNT: value column unused
                values = np.zeros(sc.valid.shape, np.float32)
            return self._put_blocks(np.asarray(values, np.float32), shards)

        return self._dev_values.get_or_build(
            (value_src, shards is not None), build)

    def _device_gids(self, gcol: Optional[str], shards=None) -> torch.Tensor:
        """Device-resident int32 group-code column, cached by name (per
        sharded / unsharded layout)."""

        def build():
            sc = self.scramble
            gids = (sc.columns[gcol].astype(np.int32) if gcol is not None
                    else np.zeros(sc.valid.shape, np.int32))
            return self._put_blocks(gids, shards)

        return self._dev_gids.get_or_build((gcol, shards is not None),
                                           build)

    def _materialize(self, q: AggQuery, idx: np.ndarray, value_src,
                     gcol: Optional[str]):
        sc = self.scramble
        block_cols = {}
        needed = set(f.column for f in q.filters)
        if isinstance(value_src, Expression):
            needed |= set(value_src.columns)
        elif isinstance(value_src, str):
            needed.add(value_src)
        for c in needed:
            block_cols[c] = sc.columns[c][idx]
        mask = sc.valid[idx].copy()
        for f in q.filters:
            mask &= f.evaluate(block_cols)
        if isinstance(value_src, Expression):
            values = value_src.evaluate(block_cols)
        elif isinstance(value_src, str):
            values = block_cols[value_src].astype(np.float32)
        else:  # COUNT: value column unused
            values = np.zeros_like(mask, dtype=np.float32)
        gids = (sc.columns[gcol][idx] if gcol is not None
                else np.zeros(mask.shape, dtype=np.int32))
        return values, gids.astype(np.int32), mask

    # -- block folding ---------------------------------------------------------

    def _fold_blocks(self, q, idx, value_src, gcol, G, center, a, b,
                     state, hist, use_hist, pad_to: Optional[int] = None):
        """Materialize blocks ``idx`` on the host, copy them to the
        frame's device and fold them into the running per-group moment
        state (+ histogram): the one shared ingest path for the per-block
        loop, the exact sweep and the recovery pass. Returns the updated
        ``(state, hist)``.

        ``pad_to`` pads the fold input to a static block count (padding
        rows carry ``mask == 0`` and contribute exact zeros), as the
        reference does to keep its compiled shapes static."""
        values, gids, mask = self._materialize(q, idx, value_src, gcol)
        if pad_to is not None and len(idx) < pad_to:
            pr = pad_to - len(idx)
            br = mask.shape[1]
            values = np.concatenate(
                [values, np.zeros((pr, br), values.dtype)])
            gids = np.concatenate([gids, np.zeros((pr, br), gids.dtype)])
            mask = np.concatenate([mask, np.zeros((pr, br), mask.dtype)])
        vf = self._put(np.asarray(values, np.float32))
        gf = self._put(gids)
        mf = self._put(mask.astype(np.float32))
        upd = kops.grouped_moments(vf, gf, mf, G, center)
        state = merge_moments_host(state, to_host(upd))
        if use_hist:
            hupd = kops.grouped_hist(vf, gf, mf, G, a, b,
                                     nbins=self.config.hist_bins)
            hist = merge_hist_host(hist, hupd.hist)
        return state, hist

    # -- cursor advance --------------------------------------------------------

    def _advance(self, order, pos, static_ok, group_bm, active_words,
                 presence, tainted, lookahead, budget, cover_cap,
                 skipping, metrics):
        """Advance the scan cursor, selecting up to ``budget`` blocks.

        Returns (idx_to_process, new_pos). Skip accounting (taint, counters)
        is applied only to positions actually covered (< new_pos)."""
        nb = order.shape[0]
        records = []
        p = pos
        total_sel = 0
        while (total_sel < budget and p < nb and (p - pos) < cover_cap):
            end = min(p + lookahead, nb)
            batch = order[p:end]
            ok = static_ok[batch]
            flags = ok.copy()
            if skipping and group_bm is not None:
                # pad the tail batch to a full lookahead (the reference's
                # static probe shape); padded zero-words are never active
                bwords = group_bm.words[batch]
                if len(batch) < lookahead:
                    bwords = np.concatenate(
                        [bwords, np.zeros((lookahead - len(batch),
                                           group_bm.n_words), np.uint32)])
                act = kops.active_blocks(
                    self._put(bwords.view(np.int32)), active_words
                ).cpu().numpy()[:len(batch)] > 0
                metrics["probes"] += len(batch)
                flags &= act
            records.append((p, batch, ok, flags))
            total_sel += int(flags.sum())
            p = end

        # cut position: just after the budget-th selected block
        selected = []
        cut = p
        remaining = budget
        for (base, batch, ok, flags) in records:
            sel_local = np.nonzero(flags)[0]
            take = sel_local[:remaining]
            selected.append(batch[take])
            remaining -= len(take)
            if remaining == 0:
                cut = base + int(take[-1]) + 1
                break
        new_pos = min(cut, p)

        # skip accounting within the covered range only
        for (base, batch, ok, flags) in records:
            if base >= new_pos:
                break
            n = min(new_pos - base, len(batch))
            okc, flagsc = ok[:n], flags[:n]
            metrics["skipped_static"] += int((~okc).sum())
            act_skip = okc & ~flagsc
            metrics["skipped_active"] += int(act_skip.sum())
            if act_skip.any():
                tainted |= presence[batch[:n][act_skip]].any(axis=0)
        idx = (np.concatenate(selected) if selected
               else np.zeros(0, dtype=np.int64))
        return idx, new_pos

    def _fused_accounting(self, order, pos, new_pos, ok, flags, presence,
                          tainted, lookahead, budget, cover_cap, probe,
                          metrics, lap_end=None):
        """Host-side bookkeeping for one fused round: replicates the
        `_advance` skip/taint/probe accounting bit for bit from the
        per-position verdicts the round returned, and materializes the
        selected block ids.

        ``lap_end`` clamps the accounting to one slot's lap in a shared
        pass whose cursor runs past ``n_blocks`` (late joiners): window
        positions at or past the slot's lap end count toward none of its
        metrics and select none of its blocks. Cursor position ``p`` is
        block ``order[p % n_blocks]``. Defaults to ``n_blocks``, the plain
        single-lap scan."""
        nb = order.shape[0]
        end = nb if lap_end is None else lap_end
        if probe:
            # probe metric: the reference path probes whole lookahead
            # batches until the budget is met (or cap/end reached)
            win_len = min(len(flags), end - pos)
            total, p = 0, 0
            while total < budget and p < win_len and p < cover_cap:
                e = min(p + lookahead, win_len)
                metrics["probes"] += e - p
                total += int(flags[p:e].sum())
                p = e
        covered = min(new_pos, end) - pos
        okc, flagsc = ok[:covered], flags[:covered]
        metrics["skipped_static"] += int((~okc).sum())
        act_skip = okc & ~flagsc
        metrics["skipped_active"] += int(act_skip.sum())
        win_ids = order[(pos + np.arange(covered)) % nb]
        if act_skip.any():
            tainted |= presence[win_ids[act_skip]].any(axis=0)
        sel = np.nonzero(flagsc)[0][:budget]
        return (win_ids[sel] if sel.size
                else np.zeros(0, dtype=np.int64))

    # -- recovery (soundness of termination) -----------------------------------

    def _recovery_pass(self, slot: _ScanViews,
                       qcis: List[_QueryIntervals], rounds: int,
                       max_rounds: int) -> int:
        """After the cursor exhausts the scramble, any still-active view is
        either tainted (its CI froze when its blocks were skipped while it
        was inactive) or empty. Tainted views cannot tighten via sampling,
        but full coverage is always sound: process their remaining
        unprocessed blocks until the aggregate is exact. Returns the
        updated round count."""
        cfg = self.config

        def union_active():
            u = np.zeros(slot.G, dtype=bool)
            for qc in qcis:
                qc.active = qc.cond_active() & ~slot.exact & slot.valid
                u |= qc.active
            return u

        while rounds < max_rounds:
            counts = slot.counts
            union = union_active()
            if not union.any():
                break
            rounds += 1
            need = slot.presence[:, union].any(axis=1) & ~slot.processed
            idx = np.nonzero(need)[0][:cfg.lookahead_blocks]
            if len(idx) == 0:
                # active views with zero observed rows over full coverage
                # are empty views: drop them
                slot.exact |= union & (counts == 0)
                if not union_active().any():
                    break
                continue
            slot.ingest_blocks(idx, pad_to=cfg.lookahead_blocks)
            slot.update_exact()
            for qc in qcis:
                qc.collapse_exact()
        return rounds

    # -- main entry ------------------------------------------------------------

    def run(self, q: AggQuery, sampling: str = "active_peek",
            start_block: Optional[int] = None, seed: int = 0,
            max_rounds: int = 100_000,
            on_sync: Optional[Callable] = None) -> QueryResult:
        """Execute one aggregate query.

        Args:
            q: the query (aggregate, filters, GROUP BY, stopping
                condition, bounder configuration).
            sampling: scan strategy — ``'active_peek'`` (batched bitmap
                lookahead, paper §4.3), ``'active_sync'`` (synchronous
                probes), ``'scan'`` (no activity skipping) or ``'exact'``
                (full sequential sweep, the paper's strawman baseline;
                also forced when ``q.stop is None``).
            start_block: scan start position (default: random from
                ``seed``); the scan order wraps around the scramble.
            seed: RNG seed for the scan start (numpy ``default_rng``, as
                the reference draws it).
            max_rounds: hard cap on OptStop rounds (safety valve).
            on_sync: optional streaming callback for the device-resident
                loop: called after every chunk (every
                ``EngineConfig.sync_every`` rounds, or every chunk of
                :data:`GRAPH_CHUNK_ROUNDS` when unset) with a dict
                snapshot (``rounds``, ``pos``, ``lo``, ``hi``, ``est``,
                ``live``). Ignored by the host loop and exact mode.

        Returns:
            :class:`~repro_torch.aqp.query.QueryResult` with per-group
            estimates, anytime-valid ``(1 - q.delta)`` intervals and scan
            metrics.
        """
        t0 = time.perf_counter()
        cfg = self.config
        sc = self.scramble
        nb = sc.n_blocks
        rng = np.random.default_rng(seed)
        exact_mode = (sampling == "exact") or (q.stop is None)
        if cfg.shard_rows:
            # explicit sharding that cannot take effect (no device loop /
            # no group of ranks) must fail loudly, not run unsharded
            cfg.resolve_shard_rows()

        # scan order: random start, wrap around (paper §5.2)
        start = (rng.integers(nb) if start_block is None else start_block)
        order = (start + np.arange(nb)) % nb
        cum_rows = np.cumsum(self._valid_counts[order])

        slot = _ScanViews(self, q)
        qci = _QueryIntervals(self, q, slot)
        metrics = {"skipped_static": 0, "skipped_active": 0,
                   "probes": slot.probes0}

        pos = 0
        rounds = 0
        stopped_early = False
        skipping = (not exact_mode) and sampling in ("active_peek",
                                                     "active_sync")
        lookahead = (cfg.sync_lookahead_blocks if sampling == "active_sync"
                     else cfg.lookahead_blocks)
        cover_cap = cfg.round_blocks * cfg.cover_cap_factor

        if not exact_mode and cfg.resolve_device_loop():
            # ---- device-resident round loop: chunks of rounds enqueued
            # with no host sync (a CUDA graph replay each on the card),
            # one scalar read per chunk, one packed writeback at the end
            probe = skipping and slot.group_bm is not None
            shards = self.block_shards()
            key = ("run", q.scan_signature(), q.agg, q.bounder,
                   q.rangetrim, q.delta, repr(q.stop), probe, lookahead,
                   max_rounds, cfg.sync_every or cfg.chunk_rounds,
                   (shards.n_shards, shards.shard_rows, shards.merge_every)
                   if shards is not None else None)
            dloop = self.device_loops.get_or_build(
                key, lambda: _DeviceLoop(self, q, slot, qci, probe,
                                         lookahead, max_rounds, shards))
            dloop.set_order(order, cum_rows)
            carry = dloop.run(dloop.init_carry(slot, qci), on_sync)
            pos, rounds, stopped_early = dloop.writeback(carry, slot, qci,
                                                         metrics)
            rounds = self._recovery_pass(slot, [qci], rounds, max_rounds)
            qci.collapse_exact()
            return qci.result(rounds, pos, cum_rows, metrics, t0,
                              stopped_early)

        active_words = (self._active_words(qci.active)
                        if slot.gcol is not None else None)
        fscan = None
        if cfg.fused and not exact_mode:
            probe = skipping and slot.group_bm is not None
            fscan = _FusedScan(self, q, slot.value_src, slot.gcol, slot.G,
                               slot.center, slot.a, slot.b, slot.use_hist,
                               probe, lookahead, cfg.round_blocks, cover_cap,
                               slot.static_ok,
                               slot.group_bm if probe else None, order)

        while pos < nb and rounds < max_rounds:
            rounds += 1
            # ---- 1+2. cursor advance + fold --------------------------------
            upd = hupd = None
            if exact_mode:
                end = min(pos + cfg.lookahead_blocks, nb)
                idx = order[pos:end]  # full sweep, no skipping (strawman)
                pos = end
            elif fscan is not None:
                # fused: one round of kernels + one host sync per round
                upd, hupd, ok_w, flags_w, new_pos = fscan.round(
                    active_words)
                idx = self._fused_accounting(
                    order, pos, new_pos, ok_w, flags_w, slot.presence,
                    slot.tainted, lookahead, cfg.round_blocks, cover_cap,
                    fscan.probe, metrics)
                pos = new_pos
            else:
                idx, pos = self._advance(
                    order, pos, slot.static_ok, slot.group_bm,
                    active_words, slot.presence, slot.tainted, lookahead,
                    cfg.round_blocks, cover_cap, skipping, metrics)

            if len(idx):
                if upd is not None:
                    slot.ingest_delta(idx, upd, hupd)
                else:
                    slot.ingest_blocks(
                        idx, pad_to=(cfg.lookahead_blocks if exact_mode
                                     else cfg.round_blocks))
            slot.update_exact(pos)

            if exact_mode:
                continue

            # ---- 3. per-view CI refresh ------------------------------------
            r = int(cum_rows[pos - 1]) if pos > 0 else 0
            qci.refresh(rounds, r)

            # ---- 4. stopping / activity ------------------------------------
            if not qci.update_active():
                stopped_early = pos < nb
                break
            if slot.gcol is not None:
                active_words = self._active_words(qci.active)

        if not exact_mode:
            rounds = self._recovery_pass(slot, [qci], rounds, max_rounds)

        qci.collapse_exact()
        if exact_mode:
            stopped_early = False

        return qci.result(rounds, pos, cum_rows, metrics, t0,
                          stopped_early)
