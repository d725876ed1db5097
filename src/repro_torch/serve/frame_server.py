"""FrameServer: shared-scan serving of concurrent AggQuery batches.

The port of :mod:`repro.serve.frame_server`. ``FastFrame.run`` answers
one query per scan; under concurrent traffic most of that work is
redundant. :class:`FrameServer` amortizes it three ways:

  1. **Materialization caching** — the device-resident value / mask /
     group-code columns are cached on the :class:`~repro_torch.aqp.engine.
     FastFrame` keyed by the components of the ``(filters, column,
     group-by)`` scan signature, so repeat queries never re-upload
     columns.
  2. **Shared fused-scan passes** — queries with the same filters are
     planned into one *pass*: one round advances every distinct
     ``(column, group-by)`` *slot* of the pass. Each slot walks its OWN
     cursor with its OWN activity flags (the union over the slot's
     queries), so a slot's selection / fold sequence does not depend on
     the other slots of the pass; what is amortized is the dispatch,
     the shared mask / prefilter buffers and the materialization.
  3. **Fold sharing** — queries with equal scan signatures map to the
     same slot and share one :class:`~repro_torch.aqp.engine._ScanViews`
     fold state; each keeps its own :class:`~repro_torch.aqp.engine.
     _QueryIntervals` (OptStop schedule, CI refresh, stopping condition).

A pass is not a static batch: :class:`SharedPass` exposes the lifecycle
as **admit / step / retire / finish**, so a serving loop
(:mod:`repro_torch.serve.scheduler`) can feed queries into an in-flight
cursor walk:

  * ``admit`` at any round boundary anchors a new slot at the current
    cursor frontier. Slot cursors run past ``n_blocks`` in unwrapped
    *pass coordinates* (a "carousel"): each slot's lap is ``[anchor,
    anchor + n_blocks)`` and the block under position ``p`` is
    ``order[p % n_blocks]``. The scan order is a rotation for every
    anchor and every slot selects with its own flags at its own cursor,
    so a slot's lap replays the scan from ``(start + anchor) %
    n_blocks``. The contract of the reference's tests: a finished
    query that is alone in its slot, or in a non-probe slot (no GROUP
    BY, or sampling that skips nothing, where selection does not depend
    on the slot's members), has a :class:`~repro_torch.aqp.query.
    QueryResult` bitwise identical to its solo ``engine.run(start_block=
    (start + anchor) % n_blocks)``. Queries that share a probe slot
    select with the UNION of their activity flags, so each is bitwise
    the slot's run (``run_batch`` of the slot's queries from that
    start), not its own solo run, and its interval stays sound.
  * ``step`` runs one round (host loop) or one chunk of rounds (device
    loop), snapshotting each query's result the moment it finishes.
  * ``retire`` drops slots whose queries have all finished.
  * ``finish`` runs the shared recovery pass for queries still active at
    lap exhaustion and assembles the remaining results.

**The device pass loop** (the default, as for ``FastFrame.run``): a
chunk of pass rounds is one captured CUDA graph on the card
(:func:`repro_torch.kernels.fused_scan.build_pass_loop`, captured by
:class:`repro_torch.aqp.engine._ChunkGraph`), run eagerly on the CPU. The
loop is built once a membership epoch (an admission or a retirement
changes its slots) and cached on the frame; the carry goes up in one
pinned copy a step and comes back in one packed copy a chunk. The
per-round host loop (``EngineConfig(device_loop=False)``) is the
oracle: each round is :func:`repro_torch.kernels.fused_scan.
fused_round_multi` (the round head with the slot's stack of masks, the
multi-query probe, the fold) and the host's own bookkeeping.

Under the device pass loop, a frame with a divided-scan layout
(``EngineConfig.shard_rows``; :mod:`repro_torch.aqp.distributed`) runs
the whole pass divided over the ranks of the default process group: each
slot's value / group slabs and the shared mask are this rank's row
slices, each rank folds only its slice of each slot's selection, and the
slots' folds merge across ranks once a round (once every
``merge_every`` rounds under the collective cadence); cursors and
interval state stay replicated. Carousel (anchored) passes compose with
it. The one exception is the cadence: on a ``merge_every > 1`` pass a
mid-lap joiner's refresh schedule would be quantized to merge
boundaries, so mid-scan admission and wrapped restores there raise the
typed :class:`UnsupportedPassConfig` for the scheduler to reroute.

Soundness: each slot skips a block only when none of ITS queries has an
active view there, so each query's skipped blocks contain only views
inactive for that query (the single-query taint invariant). Every query
keeps its own delta schedule (at its slot-local OptStop round number),
and the recovery pass finishes any view left active at lap exhaustion.
A late-joining slot is never marked exact before its own lap covers the
prefix it skipped (``_ScanViews.lap_end`` gates exhaustion-exactness).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.aqp.bitmap import pack_mask
from repro_torch.aqp.engine import (FastFrame, _ChunkGraph, _QueryIntervals,
                                    _ScanViews, _make_device_refresh,
                                    _restore_views_from_carry, _round_window,
                                    default_chunk)
from repro_torch.aqp.query import AggQuery, QueryResult
from repro_torch.core.state import MomentState, moments_nonfinite
from repro_torch.kernels import fused_scan as kfused
from repro_torch.serve.checkpoint import PassCheckpoint, SlotCheckpoint

__all__ = ["FrameServer", "SharedPass", "UnsupportedPassConfig"]


class UnsupportedPassConfig(RuntimeError):
    """A pass configuration the serving stack cannot run: mid-scan
    admission (anchor > 0) or a wrapped restore on a sharded pass
    running the collective cadence (``merge_every > 1``), where a
    mid-lap joiner's observable round boundaries would be merge
    boundaries, up to K rounds apart from its solo run's refresh
    schedule. Raised before any pass state changes, so the scheduler
    can catch it and route the queries to a fresh pass (the loop
    builder keeps its own check as a backstop)."""


class _SlotExec:
    """One (filters, column, group-by) signature inside a pass: the shared
    fold state plus the device buffers and per-query interval states.

    ``anchor`` is the pass-coordinate position where the slot was
    admitted (its lap is ``[anchor, anchor + n_blocks)``; 0 for a static
    batch) and ``join_round`` the pass round count at admission, so
    slot-local OptStop rounds are ``pass_rounds - join_round``. ``pos``
    is the slot's OWN cursor. ``shards`` (a :class:`repro_torch.aqp.
    distributed.BlockShards`) puts this rank's row slices of the slot's
    value / group slabs on the device for the sharded pass loop; the
    bitmap words stay whole (selection is replicated)."""

    def __init__(self, frame: FastFrame, rep_q: AggQuery, skipping: bool,
                 queries: Sequence[AggQuery], shards=None, anchor: int = 0,
                 join_round: int = 0, row_offset: int = 0):
        use_hist_any = any(q.needs_hist for q in queries)
        self.views = _ScanViews(frame, rep_q, use_hist=use_hist_any,
                                anchor=anchor)
        self.qcis = [_QueryIntervals(frame, q, self.views) for q in queries]
        self.anchor = anchor
        self.join_round = join_round
        self.row_offset = row_offset   # rows before anchor, pass coords
        self.pos = anchor              # this slot's cursor, pass coords
        self.lap_done_round = None     # pass round when the lap completed
        v = self.views
        # probe slots activity-test their real group bitmap; non-probe
        # slots (no GROUP BY, or non-skipping sampling) carry an all-ones
        # engagement bitmap so a finished query stops pulling blocks
        # without changing which blocks it saw while running
        self.probe = skipping and v.group_bm is not None
        self.values = frame._device_values(v.value_src, shards)
        self.gids = frame._device_gids(v.gcol, shards)
        nb = frame.scramble.n_blocks
        words = (v.group_bm.words if self.probe
                 else np.ones((nb, 1), np.uint32))
        self.words = frame._put(words.view(np.int32))
        self.meta = (v.G, frame.config.hist_bins, v.use_hist,
                     float(v.a), float(v.b), float(v.center))
        self.metrics = {"skipped_static": 0, "skipped_active": 0,
                        "probes": v.probes0}
        self._frame = frame

    def active_stack(self) -> torch.Tensor:
        """(Q, W) per-query active words for this round (uint32 bits in
        int32, on the frame's device)."""
        if self.probe:
            rows = [pack_mask(qc.active) for qc in self.qcis]
        else:
            rows = [np.asarray([0 if qc.finished else 1], np.uint32)
                    for qc in self.qcis]
        return self._frame._put(np.stack(rows).view(np.int32))


class _PassLoop:
    """The device-resident loop of one pass membership epoch: the chunk
    function of :func:`repro_torch.kernels.fused_scan.build_pass_loop`,
    its buffers and, on the card, its captured CUDA graph. Cached on the
    frame (``FastFrame.device_loops``) under the pass's static identity,
    so a repeat batch or epoch of the same shape replays the graph. The
    scan order (``order_pad``, ``cum_rows``) is the one run-dependent
    buffer: refilled in place when a pass with another start uses it."""

    def __init__(self, p: "SharedPass"):
        frame, cfg, slots = p.frame, p.cfg, p.slots
        t0 = time.perf_counter()
        dev = frame.device
        self.device = dev
        nb = p.nb
        slot_specs = tuple(
            kfused.SlotSpec(
                num_groups=s.views.G, nbins=cfg.hist_bins,
                use_hist=s.views.use_hist, a=float(s.views.a),
                b=float(s.views.b), center=float(s.views.center),
                probe=s.probe, n_words=int(s.words.shape[1]))
            for s in slots)
        refresh_fns = tuple(
            tuple(_make_device_refresh(qc.q, qc, s.views.a, s.views.b,
                                       qc.use_hist, float(qc.R),
                                       frame._put(s.views.valid))
                  for qc in s.qcis)
            for s in slots)
        self.chunk_fn, self.cond = kfused.build_pass_loop(
            nb=nb, window=p.window, budget=cfg.round_blocks,
            lookahead=p.lookahead, cover_cap=p.cover_cap,
            max_rounds=p.max_rounds, chunk=p.chunk, slot_specs=slot_specs,
            refresh_fns=refresh_fns,
            anchors=tuple(s.anchor for s in slots),
            round_offsets=tuple(s.join_round for s in slots),
            row_offsets=tuple(s.row_offset for s in slots),
            shard=p.shards.info if p.shards is not None else None,
            until_end=p.until_end)
        self.bufs = kfused.PassLoopBuffers(
            mask=p.mask_dev,
            order_pad=torch.zeros(nb + p.window, dtype=torch.int32,
                                  device=dev),
            static_ok=p.static_ok_dev,
            cum_rows=torch.zeros(nb, dtype=torch.int64, device=dev),
            values=tuple(s.values for s in slots),
            gids=tuple(s.gids for s in slots),
            words=tuple(s.words for s in slots),
            presence=tuple(frame._put(s.views.presence) for s in slots),
            presence_total=tuple(
                frame._put(s.views.presence_total.astype(np.int32))
                for s in slots))
        # a sharded pass is captured only under NCCL (gloo stages the
        # card's tensors through host memory): the device loop's rule
        self.backend = p.shards.backend if p.shards is not None else None
        self.graph = (_ChunkGraph(self.chunk_fn, self.bufs, dev,
                                  p.shards.info if p.shards is not None
                                  else None)
                      if dev.type == "cuda"
                      and self.backend in (None, "nccl") else None)
        self.start = None     # the scan start whose order is installed
        self.chunks = 0       # chunks run
        self.syncs = 0        # host reads (done checks and writebacks)
        self.build_s = time.perf_counter() - t0

    def set_order(self, start: int, order_pad: np.ndarray,
                  cum_rows: np.ndarray) -> None:
        if self.start != start:
            self.bufs.order_pad.copy_(torch.from_numpy(order_pad))
            self.bufs.cum_rows.copy_(torch.from_numpy(
                cum_rows.astype(np.int64)))
            self.start = start

    def run(self, carry: kfused.PassCarry,
            until_done: bool) -> kfused.PassCarry:
        """One chunk, or chunks until no slot can progress (one scalar
        read on the host after each); returns the carry after them."""
        if self.graph is not None:
            carry = self.graph.load(carry)
        while True:
            if self.graph is not None:
                self.graph.replay()
            else:
                carry = self.chunk_fn(self.bufs, carry)
            self.chunks += 1
            if not until_done:
                return carry
            self.syncs += 1
            if not bool(self.cond(carry)):
                return carry


class SharedPass:
    """One shared cursor walk with a continuous admit/step/retire/finish
    lifecycle (the carousel described in the module docstring).

    Construct via :meth:`FrameServer.open_pass`; all queries of a pass
    must share their filters. ``chunk_rounds`` overrides the device-loop
    chunk (``EngineConfig.sync_every`` / ``chunk_rounds`` /
    :func:`~repro_torch.aqp.engine.default_chunk`): a scheduler uses
    small chunks so admission boundaries come up often; ``run_batch``
    keeps the config default and runs to completion. On a collective
    cadence pass (``merge_every > 1``) with no chunk asked for, the
    chunks stand in for the reference's one dispatch to the end (see
    ``build_pass_loop(until_end=)``): a ``step`` then runs until no slot
    can progress, as the reference's unchunked step does. ``force_host``
    drops to the per-round host loop (the degradation ladder's last
    rung); ``force_unsharded`` keeps the device loop but runs it whole
    on this rank's device (the rung above it): both are oracle paths, so
    every rung keeps soundness."""

    def __init__(self, frame: FastFrame, filters, sampling: str,
                 start_block: Optional[int], seed: int, max_rounds: int,
                 chunk_rounds: Optional[int] = None,
                 force_host: bool = False,
                 force_unsharded: bool = False):
        self.t0 = time.perf_counter()
        self.frame = frame
        cfg = frame.config
        self.cfg = cfg
        sc = frame.scramble
        self.nb = sc.n_blocks
        self.filters = tuple(filters)
        self.sampling = sampling
        self.max_rounds = max_rounds
        rng = np.random.default_rng(seed)
        self.start = (rng.integers(self.nb) if start_block is None
                      else start_block)
        self.order = (self.start + np.arange(self.nb)) % self.nb
        self.cum_rows = np.cumsum(frame._valid_counts[self.order])
        self.R_total = int(self.cum_rows[-1])

        self.skipping = sampling in ("active_peek", "active_sync")
        self.lookahead = (cfg.sync_lookahead_blocks
                          if sampling == "active_sync"
                          else cfg.lookahead_blocks)
        self.cover_cap = cfg.round_blocks * cfg.cover_cap_factor
        self.window = _round_window(self.nb, self.lookahead,
                                    self.cover_cap)
        # the degradation ladder (the scheduler) rebuilds a faulty pass
        # from its checkpoint with ``force_host``, an oracle path, so the
        # rung keeps soundness
        self.force_host = bool(force_host)
        self.force_unsharded = bool(force_unsharded)
        self.device_pass = cfg.resolve_device_loop() and not force_host
        if cfg.shard_rows:
            cfg.resolve_shard_rows()  # the loud guard, as in FastFrame.run
        # the divided layout applies to the device pass loop only (the
        # host loop and the recovery pass fold whole host rows)
        self.shards = (frame.block_shards()
                       if self.device_pass and not force_unsharded
                       else None)
        # a host-loop pass has no chunk unless one is asked for, as in
        # the reference, so the OOM rung never halves a chunk the host
        # loop does not use
        asked = (chunk_rounds if chunk_rounds is not None
                 else cfg.sync_every or cfg.chunk_rounds)
        cadence = self.shards is not None and self.shards.merge_every > 1
        self.until_end = cadence and asked is None
        self.chunk = asked or (
            default_chunk(self.shards.merge_every if cadence else 1)
            if self.device_pass else None)

        # wrap-filled order pad: the window slice at ``pos % nb`` is a
        # rotation of the scan order, so the pad never grows when late
        # admissions push the horizon past nb
        opad = np.zeros(self.nb + self.window, np.int32)
        opad[:self.nb] = self.order
        opad[self.nb:] = self.order[np.arange(self.window) % self.nb]
        self.order_pad = opad
        self.order_pad_dev = frame._put(opad)
        self.mask_dev = None      # set on first admit (needs a query)
        self.static_ok_dev = None

        self.pos = 0              # cursor frontier: max over slot cursors
        self.rounds = 0
        self.n_live = 0
        self.wrap = False         # sticky: any slot anchored past 0
        self.slots: List[_SlotExec] = []
        self.finished: Dict[int, QueryResult] = {}  # id(qci) -> result
        self._qc_of: Dict[int, _QueryIntervals] = {}  # id(query) -> qci
        self._t0: Dict[int, float] = {}             # id(qci) -> t0
        self._rec_rounds: Dict[int, int] = {}       # id(slot) -> rounds
        # results restored from a checkpoint for queries whose slots no
        # longer exist (retired before the snapshot): id(query) -> result
        self._ext_results: Dict[int, QueryResult] = {}
        # per-slot NaN sentinel from the last device chunk (None on the
        # host path; see quarantine())
        self._sentinel: Optional[Tuple[bool, ...]] = None

    # -- coordinates -----------------------------------------------------------

    def _rows_at(self, p: int) -> int:
        """Valid rows under pass-cursor positions ``[0, p)``. Rows are
        periodic in the lap length, so no extended prefix sums needed."""
        if p <= 0:
            return 0
        laps, rem = divmod(p - 1, self.nb)
        return laps * self.R_total + int(self.cum_rows[rem])

    @property
    def can_step(self) -> bool:
        """True while stepping can still progress some unfinished query
        (queries stuck active past their lap end wait for the recovery
        pass in :meth:`finish`)."""
        if self.rounds >= self.max_rounds or self.n_live == 0:
            return False
        return any(not qc.finished and s.pos < s.views.lap_end
                   for s in self.slots for qc in s.qcis)

    # -- admit -----------------------------------------------------------------

    def admit(self, queries: Sequence[AggQuery],
              t0: Optional[float] = None) -> List[_QueryIntervals]:
        """Admit queries at the current round boundary. Queries sharing a
        scan signature form one slot anchored at the current cursor
        position (merged into a same-signature slot created at this same
        boundary, if histogram needs allow). Returns the new
        :class:`~repro_torch.aqp.engine._QueryIntervals` in input
        order."""
        frame = self.frame
        t0 = self.t0 if t0 is None else t0
        if (self.shards is not None and self.shards.merge_every > 1
                and (self.wrap or self.pos > 0)):
            # raised before any state changes: the scheduler catches it
            # and opens a fresh pass for the late joiner. Plain sharded
            # carousels compose; only the cadence cannot host a mid-lap
            # joiner (its refresh schedule would be quantized to merge
            # boundaries, up to K rounds off its solo run's)
            raise UnsupportedPassConfig(
                "mid-scan admission (anchor > 0) is not supported on a "
                "sharded pass with merge_every > 1; admit to a fresh "
                "pass or run the frame at merge_every=1")
        for q in queries:
            if tuple(f.key() for f in q.filters) != tuple(
                    f.key() for f in self.filters):
                raise ValueError("query filters do not match this pass")
        by_sig: Dict[Tuple, List[AggQuery]] = {}
        for q in queries:
            by_sig.setdefault(q.scan_signature(), []).append(q)
        out_qcis: Dict[int, _QueryIntervals] = {}
        for sig, qs in by_sig.items():
            slot = next(
                (s for s in self.slots
                 if s.anchor == self.pos and s.join_round == self.rounds
                 and s.views.rep_q.scan_signature() == sig
                 and (s.views.use_hist
                      or not any(q.needs_hist for q in qs))),
                None)
            if slot is not None:
                new = [_QueryIntervals(frame, q, slot.views) for q in qs]
                slot.qcis.extend(new)
            else:
                slot = _SlotExec(
                    frame, qs[0], self.skipping, qs, self.shards,
                    anchor=self.pos,
                    join_round=self.rounds,
                    row_offset=self._rows_at(self.pos))
                if self.pos > 0:
                    self.wrap = True
                self.slots.append(slot)
                new = slot.qcis[-len(qs):]
            for q, qc in zip(qs, new):
                self._qc_of[id(q)] = qc
                self._t0[id(qc)] = t0
                out_qcis[id(q)] = qc
            self.n_live += len(qs)
        if self.mask_dev is None:
            self.mask_dev = frame._device_mask(queries[0].filters,
                                               self.shards)
            self.static_ok_dev = frame._put(self.slots[0].views.static_ok)
        return [out_qcis[id(q)] for q in queries]

    # -- retire ----------------------------------------------------------------

    def retire(self) -> int:
        """Drop slots whose queries have all finished, freeing their fold
        width for the next admission. Called by the scheduler at
        admission boundaries; ``run_batch`` keeps its slots static."""
        keep = [s for s in self.slots
                if not all(id(qc) in self.finished for qc in s.qcis)]
        dropped = len(self.slots) - len(keep)
        self.slots = keep
        return dropped

    # -- fault tolerance: checkpoint / restore / freeze / quarantine -----------

    def checkpoint(self) -> PassCheckpoint:
        """Snapshot the complete pass state at the current round/chunk
        boundary (see :mod:`repro_torch.serve.checkpoint`). Every
        boundary is fully merged, so restoring the snapshot and stepping
        forward is bitwise-identical to never having stopped."""
        slots = [SlotCheckpoint(
            queries=[qc.q for qc in s.qcis],
            anchor=s.anchor, join_round=s.join_round,
            row_offset=s.row_offset, lap_done_round=s.lap_done_round,
            metrics=dict(s.metrics),
            views=s.views.export_state(),
            qcs=[qc.export_state() for qc in s.qcis],
            pos=int(s.pos))
            for s in self.slots]
        results: Dict[int, QueryResult] = dict(self._ext_results)
        t0s: Dict[int, float] = {}
        for qid, qc in self._qc_of.items():
            t0s[qid] = self._t0[id(qc)]
            res = self.finished.get(id(qc))
            if res is not None:
                results[qid] = res
        return PassCheckpoint(
            filters=self.filters, sampling=self.sampling,
            start=int(self.start), max_rounds=self.max_rounds,
            pos=self.pos, rounds=self.rounds, n_live=self.n_live,
            wrap=self.wrap, slots=slots, results=results, t0s=t0s,
            layout=self._layout())

    def restore(self, cp: PassCheckpoint) -> None:
        """Restore this pass in place from a checkpoint. The pass must
        have been opened with the checkpoint's filters/sampling/start
        (see :meth:`FrameServer.resume_pass`); slot execution state is
        rebuilt from scratch (device buffers re-materialize through the
        frame's caches) and the exported fold/interval state imported
        over it."""
        if tuple(f.key() for f in cp.filters) != tuple(
                f.key() for f in self.filters):
            raise ValueError("checkpoint filters do not match this pass")
        if int(cp.start) != int(self.start) or cp.sampling != \
                self.sampling:
            raise ValueError("checkpoint scan order does not match this "
                             "pass (start/sampling differ)")
        if (cp.wrap and self.shards is not None
                and self.shards.merge_every > 1):
            raise UnsupportedPassConfig(
                "cannot restore a carousel (wrapped) checkpoint onto a "
                "sharded pass with merge_every > 1; resume with "
                "force_unsharded/force_host or merge_every=1")
        self.pos, self.rounds = int(cp.pos), int(cp.rounds)
        self.wrap = bool(cp.wrap)
        self.slots = []
        self.finished = {}
        self._qc_of = {}
        self._t0 = {}
        self._rec_rounds = {}
        self._ext_results = {}
        self._sentinel = None
        frame = self.frame
        for sc in cp.slots:
            slot = _SlotExec(frame, sc.queries[0], self.skipping,
                             sc.queries, self.shards, anchor=sc.anchor,
                             join_round=sc.join_round,
                             row_offset=sc.row_offset)
            slot.lap_done_round = sc.lap_done_round
            slot.metrics = dict(sc.metrics)
            # a snapshot without a slot cursor: the shared cursor clamped
            # to the slot's lap end, where a shared-cursor loop had it
            slot.pos = (int(sc.pos) if sc.pos is not None
                        else min(int(cp.pos), slot.views.lap_end))
            slot.views.import_state(sc.views)
            for qc, snap in zip(slot.qcis, sc.qcs):
                qc.import_state(snap)
            self.slots.append(slot)
            for q, qc in zip(sc.queries, slot.qcis):
                self._qc_of[id(q)] = qc
                self._t0[id(qc)] = cp.t0s.get(id(q), self.t0)
                if id(q) in cp.results:
                    self.finished[id(qc)] = cp.results[id(q)]
        live_ids = {id(q) for s in cp.slots for q in s.queries}
        for qid, res in cp.results.items():
            if qid not in live_ids:
                self._ext_results[qid] = res
        self.n_live = sum(1 for s in self.slots for qc in s.qcis
                          if not qc.finished)
        if self.slots and self.mask_dev is None:
            self.mask_dev = frame._device_mask(
                self.slots[0].qcis[0].q.filters, self.shards)
            self.static_ok_dev = frame._put(self.slots[0].views.static_ok)

    def freeze_partial(self, q: AggQuery) -> QueryResult:
        """Finalize ``q`` NOW from its current interval state: the
        anytime-valid CI at any round boundary is a sound answer, so a
        deadline-expired or ladder-exhausted query returns its current
        (wider) interval as a partial-with-guarantee result instead of
        being dropped. Idempotent for already-finished queries."""
        qc = self._qc_of[id(q)]
        if id(qc) in self.finished:
            return self.finished[id(qc)]
        s = next(s for s in self.slots if qc in s.qcis)
        le = s.views.lap_end
        k_s = max(self.rounds - s.join_round, 0)
        r_s = self._rows_at(min(s.pos, le)) - s.row_offset
        res = qc.result(k_s, s.pos, self.cum_rows, dict(s.metrics),
                        self._t0[id(qc)], stopped_early=True,
                        rows_covered=r_s)
        qc.finished = True
        qc.active = np.zeros_like(qc.active)
        self.finished[id(qc)] = res
        self.n_live -= 1
        return res

    def quarantine(self) -> List[AggQuery]:
        """Evict poisoned slots at the current round boundary: a slot
        whose fold state or query intervals went NaN (detected by the
        device loop's sentinel, or
        :func:`~repro_torch.core.state.moments_nonfinite` on host state)
        is dropped whole, its unfinished queries returned for the caller
        to fail/quarantine. Results snapshotted BEFORE the poison
        appeared stay valid and are kept; NaN-tainted snapshots are
        discarded. Co-resident slots are untouched: their folds never saw
        the poison, so survivors stay bitwise-identical to a run that
        never admitted the poison query."""
        evicted: List[AggQuery] = []
        keep: List[_SlotExec] = []
        for i, s in enumerate(self.slots):
            poison = (self._sentinel is not None
                      and i < len(self._sentinel)
                      and bool(self._sentinel[i]))
            poison = poison or moments_nonfinite(
                s.views.state,
                s.views.hist if s.views.use_hist else None)
            if not poison:
                poison = any(
                    np.isnan(qc.lo).any() or np.isnan(qc.hi).any()
                    or np.isnan(qc.est).any() for qc in s.qcis)
            if not poison:
                keep.append(s)
                continue
            for qc in s.qcis:
                res = self.finished.get(id(qc))
                if res is not None:
                    if (np.isnan(res.lo).any() or np.isnan(res.hi).any()
                            or np.isnan(res.estimate).any()):
                        del self.finished[id(qc)]
                        evicted.append(qc.q)
                    continue
                qc.finished = True
                self.n_live -= 1
                evicted.append(qc.q)
        self.slots = keep
        self._sentinel = None
        return evicted

    # -- step ------------------------------------------------------------------

    def step(self) -> List[AggQuery]:
        """Advance the pass one round (host loop) or one chunk of rounds
        (device loop; on a cadence pass with no chunk asked for, chunks
        until no slot can progress); returns the queries that finished
        during it."""
        if self.device_pass:
            return self._device_step(until_done=self.until_end)
        return self._step_host()

    def run_to_completion(self) -> None:
        """Step until no unfinished query can progress (a static batch's
        stepping; the device path keeps its carry resident across chunks
        and writes back once, exactly the ``run_batch`` behavior)."""
        if self.device_pass:
            self._device_step(until_done=True)
        else:
            while self.can_step:
                self._step_host()

    def _step_host(self) -> List[AggQuery]:
        frame = self.frame
        cfg = self.cfg
        self._sentinel = None  # host path: quarantine inspects views
        self.rounds += 1
        # frozen slots (lapped, or every query finished) must not advance
        # (their solo twin exited its loop; a finished slot's empty flags
        # would cover ground without selecting): the round computes all
        # S slots and frozen slots' outputs are discarded
        live = [s.pos < s.views.lap_end
                and any(not qc.finished for qc in s.qcis)
                for s in self.slots]
        stacks = tuple(s.active_stack() for s in self.slots)
        pos_vec = torch.tensor([s.pos for s in self.slots],
                               dtype=torch.int64, device=frame.device)
        states, hists, flag_stacks, oks, new_pos_d = \
            kfused.fused_round_multi(
                self.mask_dev, self.order_pad_dev, self.static_ok_dev,
                pos_vec, tuple(s.values for s in self.slots),
                tuple(s.gids for s in self.slots),
                tuple(s.words for s in self.slots), stacks,
                nb=self.nb, window=self.window,
                budget=cfg.round_blocks,
                meta=tuple(s.meta for s in self.slots),
                anchors=tuple(s.anchor for s in self.slots))
        # the round's one sync: verdicts, cursors and deltas in one
        # packed copy (float64 holds each of them exactly)
        parts = [new_pos_d]
        for ok, fl, st, h in zip(oks, flag_stacks, states, hists):
            parts += [ok, fl, *st] + ([h] if h is not None else [])
        host = torch.cat([t.reshape(-1).to(torch.float64)
                          for t in parts]).cpu().numpy()
        S = len(self.slots)
        new_pos_v, at = host[:S].astype(np.int64), S
        newly: List[AggQuery] = []
        for i, (s, fl_t, st_t, h_t) in enumerate(
                zip(self.slots, flag_stacks, states, hists)):
            w, G = self.window, s.views.G
            ok = host[at:at + w] > 0
            at += w
            flags = (host[at:at + fl_t.numel()].reshape(fl_t.shape) > 0
                     ).any(axis=0)
            at += fl_t.numel()
            st = MomentState(*host[at:at + 5 * G].reshape(5, G))
            at += 5 * G
            h = None
            if h_t is not None:
                h = host[at:at + h_t.numel()].reshape(h_t.shape)
                at += h_t.numel()
            if not live[i]:
                continue
            le = s.views.lap_end
            pos0 = s.pos
            new_pos = int(new_pos_v[i])
            idx = frame._fused_accounting(
                self.order, pos0, new_pos, ok, flags, s.views.presence,
                s.views.tainted, self.lookahead, cfg.round_blocks,
                self.cover_cap, s.probe, s.metrics, lap_end=le)
            if len(idx):
                s.views.ingest_delta(idx, st, h)
            s.views.update_exact(new_pos)
            s.pos = new_pos
            if new_pos >= le and s.lap_done_round is None:
                s.lap_done_round = self.rounds
            k_s = self.rounds - s.join_round
            r_s = self._rows_at(min(new_pos, le)) - s.row_offset
            for qc in s.qcis:
                if qc.finished:
                    continue
                qc.refresh(k_s, r_s)
                if not qc.update_active():
                    qc.finished = True
                    self.n_live -= 1
                    self.finished[id(qc)] = qc.result(
                        k_s, new_pos, self.cum_rows, dict(s.metrics),
                        self._t0[id(qc)], stopped_early=new_pos < le,
                        rows_covered=r_s)
                    newly.append(qc.q)
        self.pos = max([self.pos] + [s.pos for s in self.slots])
        return newly

    # -- finish ----------------------------------------------------------------

    def finish(self) -> None:
        """Recovery per slot for queries that exhausted their lap while
        still active (shared block fetches across the slot's queries),
        then assemble their results. Idempotent per slot."""
        frame = self.frame
        for s in self.slots:
            rec = [qc for qc in s.qcis if not qc.finished]
            if rec and id(s) not in self._rec_rounds:
                base = (s.lap_done_round - s.join_round
                        if s.lap_done_round is not None
                        else self.rounds - s.join_round)
                self._rec_rounds[id(s)] = frame._recovery_pass(
                    s.views, rec, base, self.max_rounds)
            for qc in s.qcis:
                if id(qc) in self.finished:
                    continue
                qc.collapse_exact()
                le = s.views.lap_end
                r_s = self._rows_at(min(s.pos, le)) - s.row_offset
                local = self._rec_rounds.get(
                    id(s), self.rounds - s.join_round)
                self.finished[id(qc)] = qc.result(
                    local, s.pos, self.cum_rows, s.metrics,
                    self._t0[id(qc)], False, rows_covered=r_s)
                qc.finished = True

    def result_of(self, q: AggQuery) -> QueryResult:
        qc = self._qc_of.get(id(q))
        if qc is not None and id(qc) in self.finished:
            return self.finished[id(qc)]
        # restored from a checkpoint after the query's slot retired
        return self._ext_results[id(q)]

    # -- device-resident stepping ----------------------------------------------

    def _layout(self) -> Optional[Tuple[int, int, int]]:
        """The pass's divided-scan layout ``(n_shards, shard_rows,
        merge_every)``, None when it runs whole on one device."""
        sh = self.shards
        return ((sh.n_shards, sh.shard_rows, sh.merge_every)
                if sh is not None else None)

    def _loop_key(self) -> Tuple:
        """The pass loop's static identity (its cache key on the frame):
        the queries' configuration, the slots' shapes and their carousel
        coordinates, which the loop bakes in."""
        slots = self.slots
        return ("pass",
                tuple((qc.q.scan_signature(), qc.q.agg, qc.q.bounder,
                       qc.q.rangetrim, qc.q.delta, repr(qc.q.stop))
                      for s in slots for qc in s.qcis),
                tuple((len(s.qcis), s.probe, s.views.use_hist)
                      for s in slots),
                self.lookahead, self.max_rounds, self.chunk, self.until_end,
                self._layout(),
                tuple(s.anchor for s in slots),
                tuple(s.join_round for s in slots),
                tuple(s.row_offset for s in slots))

    def _host_carry(self) -> kfused.PassCarry:
        """The pass's state as the loop carry's host image (with the
        collective cadence's empty pending slots on a ``merge_every > 1``
        pass)."""
        i64 = lambda v: np.asarray(v, np.int64)
        f64 = lambda x: np.asarray(x, np.float64)
        cadence = self.shards is not None and self.shards.merge_every > 1

        def pend(s):
            if not cadence:
                return {}
            G = s.views.G
            return dict(
                pend_sums=np.zeros((3, G)), pend_vmin=np.full(G, np.inf),
                pend_vmax=np.full(G, -np.inf),
                pend_hist=(np.zeros((G, self.cfg.hist_bins))
                           if s.views.use_hist else None))

        slots = tuple(
            kfused.SlotCarry(
                pos=i64(s.pos),
                state=MomentState(*(f64(x) for x in s.views.state)),
                hist=(f64(s.views.hist) if s.views.use_hist else None),
                seen_presence=s.views.seen_presence.astype(np.int32),
                tainted=np.asarray(s.views.tainted, bool),
                exact=np.asarray(s.views.exact, bool),
                processed=np.asarray(s.views.processed, bool),
                blocks_fetched=i64(s.views.blocks_fetched),
                skipped_static=i64(s.metrics["skipped_static"]),
                skipped_active=i64(s.metrics["skipped_active"]),
                probes=i64(s.metrics["probes"]),
                lap_rounds=i64(s.lap_done_round
                               if s.lap_done_round is not None else -1),
                **pend(s))
            for s in self.slots)
        queries = tuple(
            tuple(kfused.PassQueryCarry(
                lo=f64(qc.lo), hi=f64(qc.hi), est=f64(qc.est),
                refreshed=np.asarray(qc.refreshed, bool),
                active=np.asarray(qc.active & ~np.asarray(qc.finished),
                                  bool),
                finished=np.asarray(bool(qc.finished)),
                stopped_early=np.asarray(False),
                finish_rounds=i64(0), finish_pos=i64(0),
                finish_blocks_fetched=i64(0),
                finish_skipped_static=i64(0),
                finish_skipped_active=i64(0), finish_probes=i64(0),
                snap_counts=np.zeros(s.views.G, np.float64),
                snap_exact=np.zeros(s.views.G, bool),
                snap_tainted=np.zeros(s.views.G, bool))
                for qc in s.qcis)
            for s in self.slots)
        return kfused.PassCarry(rounds=i64(self.rounds), it=i64(0),
                                n_live=i64(self.n_live), slots=slots,
                                queries=queries,
                                pend_rounds=i64(0) if cadence else None)

    def _device_step(self, until_done: bool) -> List[AggQuery]:
        """Run the pass's round loop device-resident
        (:func:`repro_torch.kernels.fused_scan.build_pass_loop`).

        ``until_done=True`` keeps the carry on the device across chunks
        and writes back once (the ``run_batch`` whole-pass behavior).
        ``until_done=False`` runs ONE chunk and writes the carry back so
        admission / retirement can change the slot membership before the
        next step; the loop is built (and cached on the frame) once a
        membership epoch, anchors and round offsets being static in it.
        The carry goes up in one pinned copy and comes back, with the
        NaN sentinel, in one packed copy; finish-time snapshots are host
        copies, never views of live state."""
        frame = self.frame
        slots = self.slots
        loop = frame.device_loops.get_or_build(self._loop_key(),
                                               lambda: _PassLoop(self))
        loop.set_order(int(self.start), self.order_pad, self.cum_rows)
        carry = kfused.carry_to_device(self._host_carry(), frame.device)
        carry = loop.run(carry, until_done)

        # the chunk's one writeback: the carry and the kernel-layer NaN
        # sentinel (per-slot poison flags, consumed by quarantine())
        host, (sentinel,) = kfused.carry_to_host(
            carry, extra=(kfused.slot_nonfinite(carry),))
        loop.syncs += 1
        self._sentinel = tuple(bool(v) for v in sentinel)

        # -- slots' cursor + shared fold state + metrics ------------------
        self.rounds = int(host.rounds)
        self.n_live = int(host.n_live)
        for s, sc in zip(slots, host.slots):
            _restore_views_from_carry(
                s.views, sc.state, sc.hist, sc.processed,
                sc.seen_presence, sc.tainted, sc.exact,
                sc.blocks_fetched, s.metrics, 0, 0)
            s.metrics["skipped_static"] = int(sc.skipped_static)
            s.metrics["skipped_active"] = int(sc.skipped_active)
            s.metrics["probes"] = int(sc.probes)
            s.pos = int(sc.pos)
            if s.pos >= s.views.lap_end and s.lap_done_round is None:
                s.lap_done_round = int(sc.lap_rounds)
        self.pos = max([self.pos] + [s.pos for s in slots])

        # -- per-query interval state + finish-time snapshot results ------
        newly: List[AggQuery] = []
        for s, qcars in zip(slots, host.queries):
            le = s.views.lap_end
            for qc, qcar in zip(s.qcis, qcars):
                if id(qc) in self.finished:
                    continue  # result already materialized; carry frozen
                qc.lo = np.array(qcar.lo)
                qc.hi = np.array(qcar.hi)
                qc.est = np.array(qcar.est)
                qc.refreshed = np.array(qcar.refreshed)
                qc.active = np.array(qcar.active)
                qc.finished = bool(qcar.finished)
                if not qc.finished:
                    continue
                snap_counts = np.array(qcar.snap_counts)
                fpos = int(qcar.finish_pos)
                self.finished[id(qc)] = QueryResult(
                    group_codes=np.arange(s.views.G),
                    estimate=np.array(qcar.est), lo=np.array(qcar.lo),
                    hi=np.array(qcar.hi), count_seen=snap_counts,
                    nonempty=snap_counts > 0,
                    exact=np.array(qcar.snap_exact),
                    tainted=np.array(qcar.snap_tainted),
                    rows_covered=(self._rows_at(min(fpos, le))
                                  - s.row_offset),
                    blocks_fetched=int(qcar.finish_blocks_fetched),
                    blocks_skipped_active=int(qcar.finish_skipped_active),
                    blocks_skipped_static=int(qcar.finish_skipped_static),
                    bitmap_probes=int(qcar.finish_probes),
                    rounds=int(qcar.finish_rounds),
                    wall_time_s=(time.perf_counter()
                                 - self._t0[id(qc)]),
                    stopped_early=bool(qcar.stopped_early))
                newly.append(qc.q)
        return newly


class FrameServer:
    """Serve batches of :class:`~repro_torch.aqp.query.AggQuery` over one
    :class:`~repro_torch.aqp.engine.FastFrame` with shared fused-scan
    passes.

    Example::

        server = FrameServer(frame)
        results = server.run_batch([q1, q2, q3])   # one scan, 3 answers

    The server is stateless between batches except for the device
    materialization caches (and pass loops) it shares with the frame, so
    it is safe to interleave ``run_batch`` with direct ``frame.run``
    calls. For continuous serving, :meth:`open_pass` exposes the
    incremental :class:`SharedPass` lifecycle used by
    :class:`repro_torch.serve.scheduler.QueryScheduler`.
    """

    def __init__(self, frame: FastFrame):
        self.frame = frame

    # -- planning --------------------------------------------------------------

    def plan(self, queries: Sequence[AggQuery]
             ) -> Dict[Tuple, List[int]]:
        """Group query indices into shared-scan passes by filters key.
        Exposed for tests/benchmarks; ``run_batch`` uses the same
        grouping."""
        passes: Dict[Tuple, List[int]] = {}
        for i, q in enumerate(queries):
            pkey = tuple(f.key() for f in q.filters)
            passes.setdefault(pkey, []).append(i)
        return passes

    def open_pass(self, filters, sampling: str = "active_peek",
                  start_block: Optional[int] = None, seed: int = 0,
                  max_rounds: int = 100_000,
                  chunk_rounds: Optional[int] = None) -> SharedPass:
        """Open an incremental shared pass for queries with ``filters``
        (admit/step/retire/finish lifecycle; see :class:`SharedPass`)."""
        return SharedPass(self.frame, filters, sampling, start_block,
                          seed, max_rounds, chunk_rounds)

    def resume_pass(self, cp: PassCheckpoint,
                    chunk_rounds: Optional[int] = None,
                    force_host: bool = False,
                    force_unsharded: bool = False) -> SharedPass:
        """Rebuild a pass from a :class:`~repro_torch.serve.checkpoint.
        PassCheckpoint`: the retry path after a fault, and (with the
        ``force_*`` flags or a smaller ``chunk_rounds``) the degradation
        ladder's rung changes. The resumed pass answers ``result_of``
        for the same query objects and, under the same config, steps
        bitwise-identically to the uninterrupted original."""
        p = SharedPass(self.frame, cp.filters, cp.sampling,
                       start_block=int(cp.start), seed=0,
                       max_rounds=cp.max_rounds,
                       chunk_rounds=chunk_rounds,
                       force_host=force_host,
                       force_unsharded=force_unsharded)
        p.restore(cp)
        return p

    def run_batch(self, queries: Sequence[AggQuery],
                  sampling: str = "active_peek",
                  start_block: Optional[int] = None, seed: int = 0,
                  max_rounds: int = 100_000) -> List[QueryResult]:
        """Answer every query, sharing scans where signatures allow.

        Args mirror :meth:`FastFrame.run`; all queries of a batch use the
        same sampling strategy and scan start (queries are only merged
        into a pass when they share filters, and only into a slot when
        their full scan signature matches). Exact-mode queries
        (``sampling='exact'`` or ``stop is None``) cannot share a
        budgeted cursor walk and are delegated to ``frame.run``.

        Returns results in input order.
        """
        results: List[Optional[QueryResult]] = [None] * len(queries)
        shared: List[int] = []
        for i, q in enumerate(queries):
            if sampling == "exact" or q.stop is None:
                results[i] = self.frame.run(
                    q, sampling=sampling, start_block=start_block,
                    seed=seed, max_rounds=max_rounds)
            else:
                shared.append(i)
        for pkey, members in self.plan(
                [queries[i] for i in shared]).items():
            idxs = [shared[m] for m in members]
            out = self._run_pass([queries[i] for i in idxs], sampling,
                                 start_block, seed, max_rounds)
            for i, res in zip(idxs, out):
                results[i] = res
        return results

    # -- one shared pass (static batch) ----------------------------------------

    def _run_pass(self, queries: Sequence[AggQuery], sampling: str,
                  start_block: Optional[int], seed: int,
                  max_rounds: int) -> List[QueryResult]:
        """Static-batch pass: admit everything at cursor position 0, run
        to completion, recover, assemble."""
        p = SharedPass(self.frame, queries[0].filters, sampling,
                       start_block, seed, max_rounds)
        p.admit(queries)
        p.run_to_completion()
        p.finish()
        return [p.result_of(q) for q in queries]
