"""Continuous-batching query scheduler: an async serving loop over
:class:`~repro_torch.serve.frame_server.FrameServer`.

The port of :mod:`repro.serve.scheduler` (numpy only), the same in
behaviour: the same event log for the same trace.

``run_batch`` answers a *static* batch; a serving front-end has queries
arriving and finishing continuously. :class:`QueryScheduler` turns the
:class:`~repro_torch.serve.frame_server.SharedPass` admit/step/retire/finish
lifecycle into a server:

  * **Queue + arrivals** — ``submit()`` enqueues a query (optionally with
    a deadline) at a clock timestamp; trace- or Poisson-driven workloads
    replay through the same entry point
    (``tests/helpers/sim_workload.py``).
  * **Admission at round boundaries** — between two pass rounds, queued
    queries whose filters match the in-flight pass join the running
    cursor walk mid-scan (a carousel slot anchored at the current
    position: they pay only the blocks they missed, and their
    coverage/taint accounting reflects the skipped prefix — see
    ``frame_server``). Queries with new filters open their own pass.
  * **Retirement** — the moment a query's OptStop condition fires its
    result is snapshotted; slots whose queries have all finished are
    retired at the next boundary, freeing fold width for admission.
  * **SLO-aware admission** — a deadline translates into a round budget;
    a Hoeffding-style width projection (distribution-free, from the
    column's catalog bounds) prices the query's target width in rounds.
    Infeasible queries are rejected *with the quote* so the client can
    renegotiate width or deadline.
  * **Progressive streaming** — every step boundary (one round on the
    host loop, one ``chunk_rounds`` dispatch on the device loop — the
    same cadence as ``run(on_sync=...)``/``sync_every``) emits a
    per-query interval snapshot to ``on_stream`` and the event log.

**Fault tolerance** (``docs/robustness.md``): the loop assumes any step
can fail. At every membership boundary (and optionally every
``checkpoint_every`` steps) the pass state is snapshotted into a
:class:`~repro_torch.serve.checkpoint.PassCheckpoint` — a sound resume point,
since every round/chunk boundary is fully merged. A failed step restores
the checkpoint and retries with bounded exponential backoff; after
``max_retries`` consecutive failures the scheduler *degrades* the pass
config instead — smaller ``chunk_rounds`` on OOM, sharded →
single-device, device loop → host oracle loop — each rung an existing
oracle path, so soundness never depends on the failing configuration.
A rung that changes the per-round work (unsharding puts the divided
scan back on one device: ~``n_shards`` x the gather/fold per round)
scales the pass's effective round cost, and every SLO-bearing ticket
still attached to the pass is immediately re-quoted at the degraded
rate (``requote`` log event) — deadline budgets never go stale.

On a frame divided over the ranks of a process group every rank runs
this loop on the same trace, and a fault one rank alone sees (a real
OOM, say) would send that rank down the ladder alone, its next
collective then waiting for ranks that never come. So the ranks agree
on a step's fault before the ladder acts: one MAX ``all_reduce`` of the
fault kind's code after the hook's ``before_step`` (before the step's
own collectives) and one after the step, and every rank takes the
agreed kind's path. A fault raised inside a step's collectives on one
rank alone is beyond this: the group's timeout ends the wait.
When the ladder is exhausted, running queries are frozen at their
current sound CI and returned as partial-with-guarantee results
(``ticket.partial``); the same freeze fires on SLO deadline expiry.
A query whose fold state goes NaN/inf (or whose admission raises a
per-query shape error) is quarantined at the next boundary without
touching co-resident slots. Faults, retries, degradations and
quarantines all land in the replayable event log, and the injectable
``fault_hook`` (in tests and smoke runs a
:class:`repro_torch.testing.faults.FaultInjector`, which this module
never imports) replays a seeded fault trace deterministically
(``tests/test_torch_faults.py``).

**Simulation-first**: every scheduling decision flows through an
injectable :class:`Clock` and a deterministic event heap. Under
:class:`SimClock` no wall clock is ever read, service time advances by
``round_cost_s`` per round, and the entire interleaving is captured in
``scheduler.log`` — replaying the same workload yields an identical log
(asserted by ``tests/test_torch_scheduler.py``). :class:`WallClock` swaps in
real timestamps for production use; nothing in the loop sleeps, and
deadline events fire through the same heap (requeued behind the next
actionable event until the wall clock actually reaches them).

Bitwise guarantee (the reference's tests' contract): a query served
through the scheduler that is alone in its slot, or in a non-probe slot
(no GROUP BY, or sampling that skips nothing), returns a
:class:`~repro_torch.aqp.query.QueryResult` bitwise identical to its
solo ``engine.run`` with the rotated start ``(start + anchor) %
n_blocks`` (property-tested in ``tests/test_torch_serve_property.py``);
queries that share a probe slot select with the union of their activity
flags, so each is bitwise the slot's run from that start, not its own
solo run (``tests/test_torch_scheduler.py``); checkpoint-restore
preserves either (``tests/test_torch_scheduler.py``).
"""

from __future__ import annotations

import heapq
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.aqp.distributed import agree_max
from repro_torch.aqp.query import AggQuery, QueryResult
from repro_torch.serve.frame_server import (FrameServer, SharedPass,
                                      UnsupportedPassConfig)

__all__ = ["SimClock", "WallClock", "AdmissionQuote", "QueryTicket",
           "QueryScheduler"]

# the faults a step may raise (a failed kernel launch raises RuntimeError,
# and so does torch.cuda.OutOfMemoryError, whose message holds "out of
# memory": _classify_failure maps it to "oom")
_STEP_FAULTS = (MemoryError, FloatingPointError, RuntimeError)
# the fault kinds in the order the ranks agree on them: the largest code
# any rank saw wins (0: no fault)
_FAULT_KINDS = ("dispatch", "transfer", "shard", "oom")


class SimClock:
    """Virtual clock for deterministic simulation: time only moves when
    the scheduler processes an event. No wall-clock reads, ever."""

    virtual = True

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def now(self) -> float:
        return self.t

    def advance_to(self, t: float) -> None:
        self.t = max(self.t, float(t))


class WallClock:
    """Real monotonic clock (seconds since construction). ``advance_to``
    is a no-op — real time cannot be set."""

    virtual = False

    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def advance_to(self, t: float) -> None:
        pass


@dataclass(frozen=True)
class AdmissionQuote:
    """Admission-time cost estimate for one query (PilotDB-style:
    deadline -> per-query width/round budget). ``est_rounds`` prices the
    query's target width via a Hoeffding projection on the column's
    catalog bounds; ``width_at_deadline`` is the width the budget buys.
    A rejected ticket carries its quote so the client can renegotiate."""

    feasible: bool
    target_width: Optional[float]
    est_rounds: Optional[int]
    est_seconds: Optional[float]
    round_budget: Optional[int]
    width_at_deadline: Optional[float]
    reason: str


@dataclass
class QueryTicket:
    """One submitted query's lifecycle record.

    Terminal statuses: ``done`` (result present; ``partial=True`` when
    the CI was frozen at a deadline or ladder exhaustion — still a sound
    interval, just wider than the target), ``rejected`` (SLO admission
    or deadline expiry while queued, quote attached), ``failed``
    (per-query admission error, e.g. a bad column), ``quarantined``
    (poisoned fold state evicted from its pass)."""

    query: AggQuery
    arrival_t: float
    deadline: Optional[float] = None
    status: str = "queued"   # queued|running|done|rejected|failed|quarantined
    quote: Optional[AdmissionQuote] = None
    admit_t: Optional[float] = None
    finish_t: Optional[float] = None
    result: Optional[QueryResult] = None
    partial: bool = False             # frozen sound CI, target not met
    # progressive stream: (t, slot-local rounds, max CI width over views)
    snapshots: List[Tuple[float, int, float]] = field(default_factory=list)
    _wall_arrival: float = 0.0
    _qc: object = None

    @property
    def latency(self) -> Optional[float]:
        return (None if self.finish_t is None
                else self.finish_t - self.arrival_t)


class _PassState:
    """One in-flight SharedPass plus its ticket bookkeeping and fault
    state. ``key = (pkey, gen)`` — a filters key can have several pass
    generations over a run (reopened after finish, rerouted around
    ``UnsupportedPassConfig``, rebuilt by the degradation ladder)."""

    def __init__(self, pkey: Tuple, pas: SharedPass, key: Tuple):
        self.pkey = pkey
        self.key = key
        self.pas = pas
        self.pending: List[QueryTicket] = []
        self.running: List[QueryTicket] = []
        self.by_query: Dict[int, QueryTicket] = {}
        # fault-tolerance state (docs/robustness.md)
        self.ckpt = None                  # last sound PassCheckpoint
        self.dirty = True                 # membership changed since ckpt
        self.steps_since_ckpt = 0
        self.fails = 0                    # consecutive failed steps
        self.chunk: Optional[int] = None  # ladder override (OOM rung)
        self.force_host = False
        self.force_unsharded = False
        # effective per-round service-time multiplier for THIS pass.
        # Degradation rungs change what one round costs — unsharding an
        # n-rank pass puts the whole divided scan back on one device,
        # ~n x the per-round work — and both the SLO quotes and the
        # simulated service time must price rounds at the degraded
        # rate, not the admission-time one.
        self.cost_mult = 1.0


class QueryScheduler:
    """Deterministic event-driven serving loop (see module docstring).

    Args:
        server: the :class:`FrameServer` to serve through.
        clock: a :class:`SimClock` (default — fully deterministic) or
            :class:`WallClock`.
        sampling / start_block / seed / max_rounds: per-pass scan
            parameters, as in :meth:`FrameServer.run_batch`.
        max_slots: soft cap on concurrently-live fold slots across all
            passes — queued queries wait for retirement to free width.
            (At least one slot is always allowed to run, so the cap can
            never deadlock the queue.)
        round_cost_s: virtual service time of one OptStop round; the
            SLO admission test prices deadlines in these units, and the
            simulated clock advances by it per round stepped.
        chunk_rounds: device-loop dispatch granularity between admission
            boundaries (defaults to the engine config's sync cadence).
        on_stream: ``fn(ticket, t, rounds, width)`` called at every
            step boundary for every running query.
        checkpoint_every: snapshot the pass state every N steps in
            addition to the always-on membership-boundary checkpoints
            (``1`` = every boundary; ``None`` = membership only).
        fault_hook: injection hook with ``before_step(sched, pas, t)``
            and ``after_step(sched, pas, t) -> Optional[float]`` (clock
            skew seconds). Production
            code never constructs one (aqplint AQP104).
        max_retries: consecutive same-config retries before the
            degradation ladder changes the pass config.
        backoff_s: base retry backoff (default ``round_cost_s``),
            doubled per consecutive failure up to ``max_backoff_s``.
    """

    def __init__(self, server: FrameServer, clock=None, *,
                 sampling: str = "active_peek", start_block: int = 0,
                 seed: int = 0, max_rounds: int = 100_000,
                 max_slots: int = 8, round_cost_s: float = 1e-3,
                 chunk_rounds: Optional[int] = None,
                 on_stream: Optional[Callable] = None,
                 checkpoint_every: Optional[int] = None,
                 fault_hook=None, max_retries: int = 2,
                 backoff_s: Optional[float] = None,
                 max_backoff_s: float = 0.25):
        self.server = server
        self.frame = server.frame
        self.clock = clock if clock is not None else SimClock()
        self.sampling = sampling
        self.start_block = start_block
        self.seed = seed
        self.max_rounds = max_rounds
        self.max_slots = max_slots
        self.round_cost_s = round_cost_s
        self.chunk_rounds = chunk_rounds
        self.on_stream = on_stream
        self.checkpoint_every = checkpoint_every
        self.fault_hook = fault_hook
        self.max_retries = max_retries
        self.backoff_s = (round_cost_s if backoff_s is None
                          else float(backoff_s))
        self.max_backoff_s = float(max_backoff_s)
        self.tickets: List[QueryTicket] = []
        self.log: List[Tuple[float, int, str, tuple]] = []
        self._events: List[Tuple[float, int, str, object]] = []
        self._seq = 0
        self._passes: Dict[Tuple, _PassState] = {}  # (pkey, gen) -> ps
        self._route: Dict[Tuple, Tuple] = {}        # pkey -> live key
        self._gen = 0

    # -- event plumbing --------------------------------------------------------

    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self._events, (t, self._seq, kind, payload))
        self._seq += 1

    def _log(self, t: float, kind: str, *payload) -> None:
        self.log.append((round(t, 9), len(self.log), kind, payload))

    @property
    def live_slots(self) -> int:
        return sum(len(ps.pas.slots) for ps in self._passes.values())

    # -- submission ------------------------------------------------------------

    def submit(self, query: AggQuery, deadline: Optional[float] = None,
               at: Optional[float] = None) -> QueryTicket:
        """Enqueue a query (arrival at ``at``, default: now). ``deadline``
        is an absolute clock time; admission prices it into a round
        budget and rejects-with-quote when infeasible, and a deadline
        event freezes a still-running query at its current sound CI
        (``ticket.partial``) when the clock reaches it."""
        t = self.clock.now() if at is None else float(at)
        tk = QueryTicket(query=query, arrival_t=t, deadline=deadline,
                         _wall_arrival=time.perf_counter())
        self.tickets.append(tk)
        self._push(t, "arrival", tk)
        if deadline is not None:
            self._push(float(deadline), "deadline", tk)
        return tk

    def submit_trace(self, arrivals) -> List[QueryTicket]:
        """Submit a whole workload trace (``sim_workload`` arrivals:
        objects with ``.t``, ``.query`` and optional ``.deadline``)."""
        return [self.submit(a.query, deadline=getattr(a, "deadline", None),
                            at=a.t) for a in arrivals]

    # -- SLO quoting -----------------------------------------------------------

    def quote(self, query: AggQuery, now: Optional[float] = None,
              deadline: Optional[float] = None,
              round_cost: Optional[float] = None) -> AdmissionQuote:
        """Price a query's stopping width in rounds (Hoeffding-style
        width projection on the catalog bounds — distribution-free, so
        the quote is an upper-bound planning estimate, not a guarantee)
        and test it against the deadline's round budget. ``round_cost``
        is the effective per-round service time to price against — the
        degraded pass rate when quoting against a degraded pass
        (default: the scheduler's base ``round_cost_s``)."""
        now = self.clock.now() if now is None else now
        round_cost = (self.round_cost_s if round_cost is None
                      else float(round_cost))
        frame = self.frame
        cfg = frame.config
        R = frame.scramble.n_rows
        rows_per_round = max(
            1.0, cfg.round_blocks * float(np.mean(frame._valid_counts)))
        target = getattr(query.stop, "eps", None)
        budget = None
        if deadline is not None:
            budget = int(max(0.0, deadline - now) / round_cost)
        if target is None:
            # no width target (ordering/threshold conditions): admit;
            # the deadline budget is still recorded for observability
            return AdmissionQuote(
                feasible=True, target_width=None, est_rounds=None,
                est_seconds=None, round_budget=budget,
                width_at_deadline=None, reason="no width target")
        _, (a, b) = frame._values_and_bounds(query)
        span = {"avg": b - a, "sum": (b - a) * R, "count": float(R)}[
            query.agg]
        ln_term = math.log(2.0 / max(query.delta, 1e-300))

        def width_at(n_rows: float) -> float:
            return span * math.sqrt(ln_term / (2.0 * max(n_rows, 1.0)))

        n_needed = span * span * ln_term / (2.0 * target * target)
        est_rounds = max(1, math.ceil(n_needed / rows_per_round))
        est_seconds = est_rounds * round_cost
        if budget is None:
            return AdmissionQuote(
                feasible=True, target_width=float(target),
                est_rounds=est_rounds, est_seconds=est_seconds,
                round_budget=None, width_at_deadline=None,
                reason="no deadline")
        wad = width_at(budget * rows_per_round)
        if est_rounds <= budget:
            return AdmissionQuote(
                feasible=True, target_width=float(target),
                est_rounds=est_rounds, est_seconds=est_seconds,
                round_budget=budget, width_at_deadline=wad,
                reason="within deadline budget")
        return AdmissionQuote(
            feasible=False, target_width=float(target),
            est_rounds=est_rounds, est_seconds=est_seconds,
            round_budget=budget, width_at_deadline=wad,
            reason=(f"needs ~{est_rounds} rounds, deadline budget is "
                    f"{budget}; achievable width ~{wad:.3g}"))

    # -- main loop -------------------------------------------------------------

    def run_until_idle(self) -> List[QueryTicket]:
        """Process events until the queue drains and every pass
        finishes. Deterministic under :class:`SimClock`: identical
        submissions produce an identical event log."""
        while self._events:
            t, _, kind, payload = heapq.heappop(self._events)
            if kind == "deadline" and not self._clock_virtual() \
                    and self.clock.now() < t:
                # wall clock hasn't reached the deadline yet; requeue
                # behind the next actionable event (a live pass always
                # has a round event pending, so this never busy-spins).
                # With nothing else queued the deadline is moot — every
                # ticket already reached a terminal state.
                if self._events:
                    self._push(max(t, self._events[0][0]), "deadline",
                               payload)
                continue
            self.clock.advance_to(t)
            if kind == "arrival":
                self._on_arrival(t, payload)
            elif kind == "round":
                self._on_round(t, payload)
            elif kind == "deadline":
                self._on_deadline(t, payload)
        return self.tickets

    def _clock_virtual(self) -> bool:
        return getattr(self.clock, "virtual", True)

    def _pkey(self, q: AggQuery) -> Tuple:
        return tuple(f.key() for f in q.filters)

    def _open_pass_state(self, filters, pkey: Tuple) -> _PassState:
        key = (pkey, self._gen)
        self._gen += 1
        pas = self.server.open_pass(
            filters, sampling=self.sampling,
            start_block=self.start_block, seed=self.seed,
            max_rounds=self.max_rounds, chunk_rounds=self.chunk_rounds)
        ps = _PassState(pkey, pas, key)
        self._passes[key] = ps
        self._route[pkey] = key
        return ps

    def _close_pass_state(self, ps: _PassState) -> None:
        del self._passes[ps.key]
        if self._route.get(ps.pkey) == ps.key:
            del self._route[ps.pkey]

    def _on_arrival(self, t: float, tk: QueryTicket) -> None:
        pkey = self._pkey(tk.query)
        self._log(t, "arrival", str(tk.query.scan_signature()),
                  tk.deadline)
        key = self._route.get(pkey)
        ps = self._passes.get(key) if key is not None else None
        if ps is None:
            ps = self._open_pass_state(tk.query.filters, pkey)
            self._push(t, "round", ps.key)
        ps.pending.append(tk)

    def _admit(self, t: float, ps: _PassState) -> None:
        """Round-boundary admission: retire finished slots first (freed
        fold width is reclaimed here), then admit pending tickets in
        arrival order under the capacity cap and the SLO test. A ticket
        whose admission raises :class:`UnsupportedPassConfig` is routed
        to a fresh pass (same filters, new generation); a per-query
        admission error (bad column / shape) fails that ticket alone."""
        retired = ps.pas.retire()
        if retired:
            self._log(t, "retire", retired)
            ps.dirty = True
        still: List[QueryTicket] = []
        rerouted: List[QueryTicket] = []
        blocked = False
        for tk in ps.pending:
            q = (self.quote(tk.query, now=t, deadline=tk.deadline,
                            round_cost=self._round_cost(ps))
                 if tk.deadline is not None else None)
            if q is not None and not q.feasible:
                tk.status, tk.quote, tk.finish_t = "rejected", q, t
                self._log(t, "reject", q.reason)
                continue
            if blocked or (self.live_slots >= self.max_slots
                           and self.live_slots > 0):
                blocked = True       # strict FIFO: keep the rest queued
                still.append(tk)     # wait for retirement to free width
                continue
            tk.quote = q
            try:
                tk._qc = ps.pas.admit([tk.query],
                                      t0=tk._wall_arrival)[0]
            except UnsupportedPassConfig:
                rerouted.append(tk)  # raised before any state mutated
                self._log(t, "reroute", ps.pas.pos)
                continue
            except (ValueError, KeyError) as exc:
                tk.status, tk.finish_t = "failed", t
                self._log(t, "admit-error", type(exc).__name__)
                continue
            tk.status, tk.admit_t = "running", t
            ps.running.append(tk)
            ps.by_query[id(tk.query)] = tk
            ps.dirty = True
            self._log(t, "admit", ps.pas.pos, ps.pas.rounds)
        ps.pending = still
        if rerouted:
            nps = self._open_pass_state(rerouted[0].query.filters,
                                        ps.pkey)
            nps.pending = rerouted
            self._push(t + self.round_cost_s, "round", nps.key)

    def _maybe_checkpoint(self, t: float, ps: _PassState) -> None:
        """Snapshot at every membership boundary (always — a restore
        must never roll admission/retirement back) and, when
        ``checkpoint_every`` is set, every N successful steps."""
        due = ps.dirty or (self.checkpoint_every is not None
                           and ps.steps_since_ckpt
                           >= self.checkpoint_every)
        if not due:
            return
        ps.ckpt = ps.pas.checkpoint()
        ps.dirty = False
        ps.steps_since_ckpt = 0
        self._log(t, "checkpoint", ps.pas.pos, ps.pas.rounds)

    def _stream(self, t: float, ps: _PassState) -> None:
        for tk in ps.running:
            if tk.status != "running" or tk._qc.finished:
                continue
            qc = tk._qc
            valid = qc.slot.valid
            width = float(np.max((qc.hi - qc.lo)[valid])) \
                if valid.any() else 0.0
            rounds = ps.pas.rounds - next(
                s.join_round for s in ps.pas.slots if qc in s.qcis)
            tk.snapshots.append((t, rounds, width))
            self._log(t, "sync", width)
            if self.on_stream is not None:
                self.on_stream(tk, t, rounds, width)

    def _on_round(self, t: float, key: Tuple) -> None:
        ps = self._passes.get(key)
        if ps is None:
            return
        self._admit(t, ps)
        if ps.pas.can_step:
            self._maybe_checkpoint(t, ps)
            self._step_pass(t, ps)
            return
        # cannot step: pass is done (all finished / lap exhausted) or
        # nothing was ever admitted (capacity wait)
        if ps.pas.slots or ps.pas.rounds > 0:
            self._finish_pass(t, ps)     # recovery + final snapshots
            self._close_pass_state(ps)
            if ps.pending:
                # reopen a fresh pass for the still-queued tickets
                nps = self._open_pass_state(
                    ps.pending[0].query.filters, ps.pkey)
                nps.pending = ps.pending
                self._push(t + self.round_cost_s, "round", nps.key)
            return
        # virgin pass, capacity-blocked: poll the next boundary so
        # width freed by other passes' retirements can admit the queue
        if ps.pending:
            self._push(t + self.round_cost_s, "round", key)
        else:
            self._close_pass_state(ps)

    # -- stepping + failure handling -------------------------------------------

    def _round_cost(self, ps: _PassState) -> float:
        """Effective per-round service time of THIS pass: the base rate
        times the pass's degradation multiplier."""
        return self.round_cost_s * ps.cost_mult

    def _agree_fault(self, exc: Optional[BaseException]) -> Optional[str]:
        """The step's fault kind (None: no fault), the same on every
        rank of a divided frame's group: the largest kind any rank saw
        (one MAX ``all_reduce``). On an undivided frame, this process's
        own."""
        kind = None if exc is None else self._classify_failure(exc)
        shards = self.frame.block_shards()
        if shards is None:
            return kind
        code = 0 if kind is None else _FAULT_KINDS.index(kind) + 1
        code = agree_max(shards.mesh.group, code, shards.device)
        return None if code == 0 else _FAULT_KINDS[code - 1]

    def _step_pass(self, t: float, ps: _PassState) -> None:
        r0 = ps.pas.rounds
        hook = self.fault_hook
        skew = None
        fault = None
        try:
            if hook is not None:
                hook.before_step(self, ps.pas, t)
        except _STEP_FAULTS as exc:
            fault = exc
        # agreed before the step, whose collectives the other ranks
        # would otherwise wait in
        kind = self._agree_fault(fault)
        if kind is None:
            try:
                newly = ps.pas.step()
                if hook is not None:
                    skew = hook.after_step(self, ps.pas, t)
            except _STEP_FAULTS as exc:
                fault = exc
            kind = self._agree_fault(fault)
        if kind is not None:
            self._on_step_failure(t, ps, kind)
            return
        ps.fails = 0
        ps.steps_since_ckpt += 1
        t_done = t + (ps.pas.rounds - r0) * self._round_cost(ps)
        if skew:
            self._log(t, "skew", round(float(skew), 9))
            t_done += float(skew)
        # quarantine: evict slots whose folds went NaN/inf this step
        for q in ps.pas.quarantine():
            tk = ps.by_query.get(id(q))
            if tk is None:
                continue
            tk.status, tk.finish_t = "quarantined", t_done
            tk.result = None
            ps.dirty = True
            self._log(t_done, "quarantine",
                      str(q.scan_signature()))
        for q in newly:
            tk = ps.by_query[id(q)]
            if tk.status != "running":
                continue   # frozen/quarantined between boundaries
            tk.status, tk.finish_t = "done", t_done
            tk.result = ps.pas.result_of(q)
            self._log(t_done, "finish",
                      ps.pas.rounds, tk.result.rounds,
                      bool(tk.result.stopped_early))
        if not self._clock_virtual():
            # wall time advances during the step itself, so sweep for
            # deadlines the heap's deadline events haven't reached yet
            self._expire_deadlines(t_done, ps)
        self._stream(t_done, ps)
        self._push(t_done, "round", ps.key)

    def _classify_failure(self, exc: BaseException) -> str:
        msg = str(exc).lower()
        if isinstance(exc, MemoryError) or "resource_exhausted" in msg \
                or "out of memory" in msg:
            return "oom"
        if "shard" in msg or "device unavailable" in msg:
            return "shard"
        if "transfer" in msg:
            return "transfer"
        return "dispatch"

    def _on_step_failure(self, t: float, ps: _PassState,
                         kind: str) -> None:
        """Retry from the checkpoint with bounded exponential backoff;
        after ``max_retries`` consecutive failures move down the
        degradation ladder; when the ladder is exhausted, freeze every
        running query at its current sound CI (partial-with-guarantee)
        and fail the still-queued ones. ``kind`` is the step's agreed
        fault kind (:meth:`_agree_fault`)."""
        ps.fails += 1
        self._log(t, "fault", kind, ps.fails)
        backoff = min(self.backoff_s * (2 ** (ps.fails - 1)),
                      self.max_backoff_s)
        if ps.fails <= self.max_retries:
            self._restore(ps)
            self._log(t, "retry", ps.fails, round(backoff, 9))
            self._push(t + backoff, "round", ps.key)
            return
        action = self._degrade_action(ps, kind)
        if action is not None:
            ps.fails = 0
            self._log(t, "degrade", action)
            self._rebuild(ps)
            self._requote(t, ps)
            self._push(t + backoff, "round", ps.key)
            return
        self._restore(ps)
        self._log(t, "ladder-exhausted")
        for tk in ps.running:
            if tk.status != "running":
                continue
            self._freeze_ticket(t, ps, tk, "ladder-exhausted")
        for tk in ps.pending:
            tk.status, tk.finish_t = "failed", t
            self._log(t, "fail", "ladder-exhausted")
        ps.pending = []
        self._close_pass_state(ps)

    def _restore(self, ps: _PassState) -> None:
        """Roll the pass back to its last checkpoint in place (same
        config) and re-point tickets at the rebuilt interval states."""
        ps.pas.restore(ps.ckpt)
        self._remap(ps)

    def _rebuild(self, ps: _PassState) -> None:
        """Resume the pass from its checkpoint under the degraded
        config chosen by :meth:`_degrade_action`."""
        ps.pas = self.server.resume_pass(
            ps.ckpt, chunk_rounds=ps.chunk,
            force_host=ps.force_host,
            force_unsharded=ps.force_unsharded)
        self._remap(ps)

    def _remap(self, ps: _PassState) -> None:
        for tk in ps.running:
            qc = ps.pas._qc_of.get(id(tk.query))
            if qc is not None:
                tk._qc = qc

    def _requote(self, t: float, ps: _PassState) -> None:
        """A degrade changed the pass's effective round cost: re-price
        every SLO-bearing ticket still attached to it so no budget is
        stale. Running tickets keep running — an infeasible requote just
        means the deadline freeze will fire later — but their quotes
        (and the replayable log) now reflect the degraded rate; pending
        tickets are re-tested by :meth:`_admit` at the next boundary
        with the same degraded cost."""
        for tk in ps.running + ps.pending:
            if tk.deadline is None or tk.status not in ("running",
                                                        "queued"):
                continue
            q = self.quote(tk.query, now=t, deadline=tk.deadline,
                           round_cost=self._round_cost(ps))
            tk.quote = q
            self._log(t, "requote", q.feasible, q.est_rounds,
                      q.round_budget)

    def _degrade_action(self, ps: _PassState,
                        kind: str) -> Optional[str]:
        """Pick the next ladder rung for a repeatedly-failing pass:
        OOM first shrinks the dispatch chunk, then any failure falls
        back sharded -> single device -> host oracle loop. Returns a
        log label, or None when no rung is left. Rungs that change the
        per-round work also scale ``ps.cost_mult`` — the divided scan
        put back on one device does ``n_shards`` x the gather/fold per
        round — so quotes and service time re-price afterwards
        (:meth:`_requote`)."""
        pas = ps.pas
        if kind == "oom":
            cur = ps.chunk if ps.chunk is not None else pas.chunk
            if cur is not None and int(cur) > 1:
                ps.chunk = max(1, int(cur) // 2)
                return f"chunk_rounds={ps.chunk}"
        if pas.shards is not None and not ps.force_unsharded:
            ps.force_unsharded = True
            ps.cost_mult *= float(pas.shards.n_shards)
            return "unsharded"
        if pas.device_pass and not ps.force_host:
            ps.force_host = True
            return "host-loop"
        return None

    # -- deadlines -------------------------------------------------------------

    def _freeze_ticket(self, t: float, ps: _PassState, tk: QueryTicket,
                       reason: str) -> None:
        """Finalize a running ticket NOW at its current sound CI: a
        partial-with-guarantee answer (the interval is anytime-valid;
        only the width target is unmet)."""
        res = ps.pas.freeze_partial(tk.query)
        tk.result, tk.partial = res, True
        tk.status, tk.finish_t = "done", t
        ps.dirty = True
        self._log(t, "finish-partial", reason, ps.pas.rounds,
                  res.rounds)

    def _expire_deadlines(self, t: float, ps: _PassState) -> None:
        now = self.clock.now()
        for tk in ps.running:
            if (tk.status == "running" and tk.deadline is not None
                    and now >= tk.deadline and not tk._qc.finished):
                self._freeze_ticket(t, ps, tk, "deadline")

    def _on_deadline(self, t: float, tk: QueryTicket) -> None:
        """The clock reached a ticket's deadline: a still-queued ticket
        is rejected with a quote; a running one freezes at its current
        sound CI. Terminal tickets ignore the event."""
        if tk.status == "queued":
            q = self.quote(tk.query, now=t, deadline=tk.deadline)
            tk.status, tk.quote, tk.finish_t = "rejected", q, t
            for ps in self._passes.values():
                if tk in ps.pending:
                    ps.pending.remove(tk)
                    break
            self._log(t, "reject", "deadline expired while queued")
            return
        if tk.status != "running" or tk._qc is None or tk._qc.finished:
            return
        for ps in self._passes.values():
            if ps.by_query.get(id(tk.query)) is tk:
                self._freeze_ticket(t, ps, tk, "deadline")
                return

    # -- finish ----------------------------------------------------------------

    def _finish_pass(self, t: float, ps: _PassState) -> None:
        ps.pas.finish()
        for tk in ps.running:
            if tk.status != "running":
                continue
            tk.status, tk.finish_t = "done", t
            tk.result = ps.pas.result_of(tk.query)
            self._log(t, "finish", ps.pas.rounds, tk.result.rounds,
                      bool(tk.result.stopped_early))
        ps.running = [tk for tk in ps.running if tk.status == "running"]

    # -- reporting -------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Latency/throughput summary over completed tickets (virtual
        time under SimClock, wall time under WallClock)."""
        done = [tk for tk in self.tickets if tk.status == "done"]
        lats = sorted(tk.latency for tk in done)
        out = {"n_done": float(len(done)),
               "n_rejected": float(sum(tk.status == "rejected"
                                       for tk in self.tickets))}
        if done:
            span = (max(tk.finish_t for tk in done)
                    - min(tk.arrival_t for tk in done))
            out["makespan_s"] = span
            out["qps"] = len(done) / span if span > 0 else float("inf")
            out["p50_latency_s"] = lats[len(lats) // 2]
            out["p99_latency_s"] = lats[min(len(lats) - 1,
                                            int(len(lats) * 0.99))]
        return out
