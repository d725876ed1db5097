"""FastFrame query engine: OptStop rounds + active scanning over a scramble.

The port of :mod:`repro.aqp.engine`, per-round host loop. Per round
(Algorithm 5 at block granularity, §4.2/§4.3):
  1. advance the scan cursor through the shuffled block order, using the
     static predicate bitmap and the (group-bitmap AND active-mask) probe
     to *skip* blocks that cannot help any active view;
  2. fold the selected blocks into the per-group mergeable moment states;
  3. re-evaluate per-view CIs at delta_k = (6/pi^2) delta_view / k^2 with the
     Theorem-3 ``N+`` upper bound standing in for the unknown view size;
  4. intersect with the running interval, update the active mask from the
     query's stopping condition, and stop when no view is active.

Steps 1–2 have two implementations sharing the same semantics:

  * **fused** (default, ``EngineConfig.fused=True``): the query's value
    column, predicate mask and group codes are materialized once and kept
    on the frame's device; each round is one
    :func:`repro_torch.kernels.fused_scan.fused_round` (activity probe ->
    budgeted selection -> moment fold), and the host syncs once per round
    to merge the emitted deltas in float64 and run the soundness
    bookkeeping;
  * **per-block reference** (``fused=False``): a Python cursor loop issuing
    separate bitmap-probe and fold calls per lookahead batch with host
    materialization in between — the oracle the fused path is tested
    against.

The frame's device is explicit: ``FastFrame(scramble, device=None)`` runs
on the card (``"cuda"``) and raises when there is none, unless the caller
asks for ``device="cpu"``, where every kernel is its plain PyTorch version.
All bound math is float64 numpy on the host, exactly as the reference's
host loop does it, so the port needs no 64-bit switch.

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
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.aqp.bitmap import (BlockBitmap, build_bitmap, pack_mask,
                                    unpack_words)
from repro_torch.aqp.query import AggQuery, Expression, QueryResult
from repro_torch.aqp.scramble import Scramble
from repro_torch.core import count_sum
from repro_torch.core.bounders import get_bounder
from repro_torch.core.lru import LRUCache
from repro_torch.core.optstop import delta_schedule
from repro_torch.core.state import (MomentState, StatsBatch,
                                    init_moments_host, merge_moments_host,
                                    to_host)
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


def _exact_estimate(q: AggQuery, counts, means, R):
    """Vectorized point estimate over fully-covered views."""
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


def resolve_device(device=None) -> torch.device:
    """The frame's device: ``None`` means the card (``"cuda"``). Raises
    when CUDA is asked for and absent — the port never falls back to the
    CPU silently; ``device="cpu"`` runs the plain PyTorch versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the card by default, but CUDA is not "
                "available here. Pass device='cpu' to run the engine with "
                "the plain PyTorch versions of its kernels on the host.")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev


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
        alpha: COUNT/AVG delta split for unknown-``N`` SUM/AVG queries.
        fused: drive scan rounds through
            :func:`repro_torch.kernels.fused_scan.fused_round` (one round
            of kernels + one host sync per round); ``False`` runs the
            per-block reference path. Results are identical either way.
        device_loop: the device-resident round loop. Not ported yet:
            ``None`` and ``False`` run the per-round host loop, ``True``
            raises ``NotImplementedError``.
        mat_cache_entries: LRU capacity of EACH of the frame's three
            device materialization caches (value columns, predicate
            masks, group-code columns). Every entry pins one full
            ``(n_blocks, block_rows)`` device buffer.
        shard_rows / mesh_shape / merge_every: the mesh-sharded scan. Not
            ported yet: any setting other than the defaults (``None``,
            ``None``, ``1``) raises ``NotImplementedError``.
    """

    round_blocks: int = 64          # processed-block budget per round
    lookahead_blocks: int = 1024    # ActivePeek batch (paper §4.3)
    sync_lookahead_blocks: int = 32 # ActiveSync batch (cache-unfriendly)
    cover_cap_factor: int = 64      # max covered positions per round
    alpha: float = _ALPHA
    fused: bool = True              # fused scan round (vs per-block)
    device_loop: Optional[bool] = None  # device-resident loop (later slice)
    mat_cache_entries: int = 32     # LRU cap per device materialization
                                    # cache (each entry pins one full
                                    # (n_blocks, block_rows) buffer)
    shard_rows: Optional[bool] = None   # mesh-sharded scan (later slice)
    mesh_shape: Optional[Tuple[int, ...]] = None
    merge_every: int = 1

    def __post_init__(self):
        if self.merge_every < 1:
            raise ValueError(
                f"EngineConfig(merge_every={self.merge_every}) must be "
                ">= 1 (1 merges the shard folds every round)")
        if self.shard_rows or self.mesh_shape is not None \
                or self.merge_every > 1:
            raise NotImplementedError(
                "the mesh-sharded scan (shard_rows / mesh_shape / "
                "merge_every > 1) is not ported yet: it comes with the "
                "sharded-scan slice of the port (torch.distributed)")
        self.resolve_device_loop()

    def resolve_device_loop(self) -> bool:
        """Whether the device-resident round loop is in effect: never, in
        this slice of the port."""
        if self.device_loop:
            raise NotImplementedError(
                "EngineConfig(device_loop=True): the device-resident round "
                "loop is not ported yet (it comes with the device-loop "
                "slice of the port); device_loop=None or False runs the "
                "per-round host loop")
        return False


class _ScanViews:
    """State determined by one scan signature ``(filters, column,
    group-by)``: the aggregate views' fold / coverage / soundness
    bookkeeping, independent of any one query's stopping condition."""

    def __init__(self, frame: "FastFrame", q: AggQuery):
        if q.needs_hist:
            raise NotImplementedError(
                "the Anderson/DKW bounder needs the per-group histogram "
                "fold (TPU kernels repro.kernels.hist.grouped_hist and "
                "fused_scan.fused_fold), which is not ported yet: it comes "
                "with a later slice of the port. Use another bounder.")
        self.frame = frame
        self.rep_q = q
        sc = frame.scramble
        self.lap_end = sc.n_blocks
        self.gcol, self.G = (None, 1)
        if q.group_by is not None:
            self.gcol, self.G = frame._composite_group(q.group_cols)
        self.value_src, (self.a, self.b) = frame._values_and_bounds(q)
        self.center = 0.5 * (self.a + self.b)
        self.static_ok, self.probes0 = frame._static_ok(q)
        self.group_bm = (frame.bitmap(self.gcol) if self.gcol is not None
                         else None)
        self.presence = (unpack_words(self.group_bm.words, self.G)
                         if self.group_bm is not None
                         else np.ones((sc.n_blocks, 1), dtype=bool))
        self.presence_total = self.presence.sum(axis=0)
        self.valid = self.presence_total > 0
        self.state = init_moments_host((self.G,))
        self.seen_presence = np.zeros(self.G, dtype=np.int64)
        self.processed = np.zeros(sc.n_blocks, dtype=bool)
        self.exact = self.presence_total == 0   # group code never occurs
        self.tainted = np.zeros(self.G, dtype=bool)
        self.blocks_fetched = 0

    @property
    def counts(self) -> np.ndarray:
        return self.state.count

    def ingest_delta(self, idx: np.ndarray, upd) -> None:
        """Merge one fused round's mergeable delta for the selected blocks
        ``idx`` (float64 on the host)."""
        self.processed[idx] = True
        self.blocks_fetched += len(idx)
        self.state = merge_moments_host(self.state, to_host(upd))
        self.seen_presence += self.presence[idx].sum(axis=0)

    def ingest_blocks(self, idx: np.ndarray,
                      pad_to: Optional[int] = None) -> None:
        """Host materialize-and-fold path (per-block reference, exact
        sweep and the recovery pass)."""
        self.processed[idx] = True
        self.blocks_fetched += len(idx)
        self.state = self.frame._fold_blocks(
            self.rep_q, idx, self.value_src, self.gcol, self.G, self.center,
            self.state, pad_to=pad_to)
        self.seen_presence += self.presence[idx].sum(axis=0)

    def update_exact(self, pos: Optional[int] = None) -> None:
        """Mark fully-covered views exact; on exhaustion (``pos >=
        lap_end``) also untainted views — an untainted view's unprocessed
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
            sb = StatsBatch.from_state(slot.state).take(gidx)
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
               stopped_early: bool) -> QueryResult:
        """Build the QueryResult from the current slot/query state (arrays
        copied, so the result is a consistent snapshot)."""
        slot = self.slot
        counts = slot.counts
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
                 G: int, center: float, probe: bool, lookahead: int,
                 budget: int, cover_cap: int, static_ok: np.ndarray,
                 group_bm, order: np.ndarray):
        sc = frame.scramble
        nb = sc.n_blocks
        self.window = _round_window(nb, lookahead, cover_cap)
        self.budget = budget
        self.nb = nb
        self.probe = probe
        self.center = float(center)
        self.G = G

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

    def round(self, pos: int, active_words):
        """One fused round from cursor ``pos``. Returns host-side
        ``(moment_delta, ok, flags, new_pos)``.

        The round's outputs come back in ONE device-to-host copy (the
        round's one host sync): verdicts, cursor and the float32 delta,
        packed as float64, which holds each of them exactly."""
        aw = active_words if active_words is not None else self._dummy_active
        state, ok, flags, new_pos = kfused.fused_round(
            self.values, self.gids, self.mask, self.words, self.order_pad,
            self.static_ok, pos, aw, nb=self.nb, window=self.window,
            budget=self.budget, center=self.center, num_groups=self.G,
            probe=self.probe)
        parts = (ok, flags, new_pos, *state)
        host = torch.cat([t.reshape(-1).to(torch.float64)
                          for t in parts]).cpu().numpy()
        w, G = self.window, self.G
        delta = MomentState(*host[2 * w + 1:].reshape(5, G))
        return delta, host[:w] > 0, host[w:2 * w] > 0, int(host[2 * w])


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
        # of the (filters, column, group-by) scan signature; LRU-bounded
        # (config.mat_cache_entries). In-flight scans hold direct
        # references, so eviction only drops the cache's pin.
        cap = self.config.mat_cache_entries
        self._dev_masks = LRUCache(cap)
        self._dev_values = LRUCache(cap)
        self._dev_gids = LRUCache(cap)

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

    def _device_mask(self, filters) -> torch.Tensor:
        """Device-resident (n_blocks, block_rows) f32 predicate*valid
        mask, cached by the filters' key."""

        def build():
            sc = self.scramble
            mask = sc.valid.copy()
            for f in filters:
                mask &= f.evaluate(sc.columns)
            return self._put(mask.astype(np.float32))

        return self._dev_masks.get_or_build(
            tuple(f.key() for f in filters), build)

    def _device_values(self, value_src) -> torch.Tensor:
        """Device-resident f32 value column (zeros for COUNT), cached by
        the column name / Expression."""

        def build():
            sc = self.scramble
            if isinstance(value_src, Expression):
                values = value_src.evaluate(sc.columns)
            elif isinstance(value_src, str):
                values = sc.columns[value_src].astype(np.float32)
            else:  # COUNT: value column unused
                values = np.zeros(sc.valid.shape, np.float32)
            return self._put(np.asarray(values, np.float32))

        return self._dev_values.get_or_build(value_src, build)

    def _device_gids(self, gcol: Optional[str]) -> torch.Tensor:
        """Device-resident int32 group-code column, cached by name."""

        def build():
            sc = self.scramble
            gids = (sc.columns[gcol].astype(np.int32) if gcol is not None
                    else np.zeros(sc.valid.shape, np.int32))
            return self._put(gids)

        return self._dev_gids.get_or_build(gcol, build)

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

    def _fold_blocks(self, q, idx, value_src, gcol, G, center, state,
                     pad_to: Optional[int] = None):
        """Materialize blocks ``idx`` on the host, copy them to the
        frame's device and fold them into the running per-group moment
        state: the one shared ingest path for the per-block loop, the
        exact sweep and the recovery pass.

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
        return merge_moments_host(state, to_host(upd))

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
                          metrics):
        """Host-side bookkeeping for one fused round: replicates the
        `_advance` skip/taint/probe accounting bit for bit from the
        per-position verdicts the round returned, and materializes the
        selected block ids."""
        nb = order.shape[0]
        if probe:
            # probe metric: the reference path probes whole lookahead
            # batches until the budget is met (or cap/end reached)
            win_len = min(len(flags), nb - pos)
            total, p = 0, 0
            while total < budget and p < win_len and p < cover_cap:
                e = min(p + lookahead, win_len)
                metrics["probes"] += e - p
                total += int(flags[p:e].sum())
                p = e
        covered = min(new_pos, nb) - pos
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
            max_rounds: int = 100_000) -> QueryResult:
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
        cfg.resolve_device_loop()

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

        active_words = (self._active_words(qci.active)
                        if slot.gcol is not None else None)
        fscan = None
        if cfg.fused and not exact_mode:
            probe = skipping and slot.group_bm is not None
            fscan = _FusedScan(self, q, slot.value_src, slot.gcol, slot.G,
                               slot.center, probe, lookahead,
                               cfg.round_blocks, cover_cap, slot.static_ok,
                               slot.group_bm if probe else None, order)

        while pos < nb and rounds < max_rounds:
            rounds += 1
            # ---- 1+2. cursor advance + fold --------------------------------
            upd = None
            if exact_mode:
                end = min(pos + cfg.lookahead_blocks, nb)
                idx = order[pos:end]  # full sweep, no skipping (strawman)
                pos = end
            elif fscan is not None:
                # fused: one round of kernels + one host sync per round
                upd, ok_w, flags_w, new_pos = fscan.round(pos, active_words)
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
                    slot.ingest_delta(idx, upd)
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
