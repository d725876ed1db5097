"""The port's QueryScheduler (``repro_torch.serve.scheduler``) on the CPU,
the mirror of ``tests/test_scheduler.py``: the continuous-batching
serving loop is (a) deterministic — same seeded trace, same event log;
(b) sound — every served result bitwise equal to its solo ``engine.run``
(rotated to the slot's admission anchor) and every streamed interval
containing the true aggregate; (c) well-behaved under load — capacity
queueing admits FIFO after retirement frees fold width, infeasible SLOs
are rejected *with a quote*.

The mirrored cases run the per-round host pass loop
(``device_loop=False``), as the reference's suite does without 64-bit
JAX; a burst through the device pass loop (chunks of 4 rounds) is held
bitwise to solo device-loop runs, resumed from a mid-pass checkpoint,
and replayed without building a new pass loop (in place of the
reference's retrace budget). No wall-clock sleeps: all timing is
virtual (SimClock).

The module runs torch on one thread (``one_torch_thread``): the eager
loops are thousands of small ops, which intra-op threads slow under
xdist.
"""

import numpy as np
import pytest

from repro.data import flights

from repro_torch.aqp import AggQuery, EngineConfig, FastFrame, build_scramble
from repro_torch.core.optstop import AbsoluteWidth, ThresholdSide
from repro_torch.serve import FrameServer, QueryScheduler, SimClock

from tests.helpers.sim_workload import (adversarial_trace, assert_same_log,
                                        burst_trace, poisson_trace)
from tests.helpers.torch_parity import one_torch_thread  # noqa: F401
from tests.test_torch_serve import assert_bitwise_equal

CFG = dict(round_blocks=16, lookahead_blocks=64, sync_lookahead_blocks=16,
           hist_bins=256, device_loop=False)


@pytest.fixture(scope="module")
def ds():
    return flights.generate(n_rows=100_000, n_airports=80, n_airlines=6,
                            seed=3)


@pytest.fixture(scope="module")
def scramble(ds):
    return build_scramble(ds.columns, catalog=ds.catalog, block_rows=256,
                          seed=4)


def fresh_frame(scramble, **over):
    kw = dict(CFG)
    kw.update(over)
    return FastFrame(scramble, EngineConfig(**kw), device="cpu")


# non-probe query mix (no GROUP BY): slot selection is
# membership-independent, so the bitwise-to-solo guarantee applies
def make_query(rng: np.random.Generator) -> AggQuery:
    agg = ["avg", "sum", "count"][int(rng.integers(3))]
    eps = {"avg": float(rng.uniform(0.5, 4.0)),
           "sum": float(rng.uniform(5e4, 5e5)),
           "count": float(rng.uniform(500.0, 5e3))}[agg]
    return AggQuery(agg=agg, column="dep_delay",
                    stop=AbsoluteWidth(eps=eps), delta=1e-9)


def make_scheduler(scramble, frame=None, cfg=None, **over):
    frame = frame if frame is not None else fresh_frame(
        scramble, **(cfg or {}))
    kw = dict(seed=1, round_cost_s=1e-3, max_slots=4)
    kw.update(over)
    return QueryScheduler(FrameServer(frame), SimClock(), **kw)


def run_trace(scramble, trace, **over):
    sched = make_scheduler(scramble, **over)
    sched.submit_trace(trace)
    sched.run_until_idle()
    return sched


# -- determinism / replay ------------------------------------------------------


def test_replay_identical_log(scramble):
    trace = poisson_trace(make_query, n=12, rate=300.0, seed=7)
    a = run_trace(scramble, trace)
    b = run_trace(scramble, trace)
    assert_same_log(a.log, b.log)
    for ta, tb in zip(a.tickets, b.tickets):
        assert ta.status == tb.status == "done"
        assert ta.finish_t == tb.finish_t
        assert_bitwise_equal(ta.result, tb.result)


def test_adversarial_trace_replays(scramble):
    trace = adversarial_trace(make_query, n=20, seed=11)
    a = run_trace(scramble, trace, max_slots=2)
    b = run_trace(scramble, trace, max_slots=2)
    assert_same_log(a.log, b.log)
    # the tight-deadline tickets exercised the reject path
    assert any(tk.status == "rejected" for tk in a.tickets)
    assert all(tk.status in ("done", "rejected") for tk in a.tickets)


# -- bitwise-to-solo (acceptance criterion) ------------------------------------


def test_poisson_workload_bitwise_vs_solo(scramble):
    """Seeded Poisson workload served end-to-end: every result bitwise
    equal to running the query alone, started at its admission anchor."""
    trace = poisson_trace(make_query, n=10, rate=250.0, seed=5)
    sched = run_trace(scramble, trace)
    nb = sched.frame.scramble.n_blocks
    anchors = set()
    for tk, arr in zip(sched.tickets, trace):
        assert tk.status == "done"
        anchor = tk._qc.slot.anchor
        anchors.add(anchor)
        solo = fresh_frame(scramble).run(
            arr.query, sampling="active_peek", seed=1,
            start_block=anchor % nb)
        assert_bitwise_equal(tk.result, solo)
    # the trace actually exercised mid-scan joins, not only fresh passes
    assert len(anchors) > 1, anchors


def test_mid_scan_join_pays_only_missed_blocks(scramble):
    """A late joiner's lap is the rotation starting at its anchor: it
    pays only blocks from the anchor on, never re-pays the prefix the
    pass already covered before it arrived."""
    sched = make_scheduler(scramble)
    q1 = AggQuery(agg="avg", column="dep_delay",
                  stop=AbsoluteWidth(eps=2.0), delta=1e-9)
    q2 = AggQuery(agg="avg", column="dep_delay",
                  stop=AbsoluteWidth(eps=3.0), delta=1e-9)
    sched.submit(q1, at=0.0)
    sched.submit(q2, at=0.005)      # joins ~5 rounds in
    sched.run_until_idle()
    t1, t2 = sched.tickets
    anchor = t2._qc.slot.anchor
    assert anchor > 0
    nb = sched.frame.scramble.n_blocks
    solo = fresh_frame(scramble).run(q2, sampling="active_peek", seed=1,
                                     start_block=anchor % nb)
    assert_bitwise_equal(t2.result, solo)
    assert t2.result.blocks_fetched <= nb


# -- admission / capacity / retirement -----------------------------------------


def test_capacity_queueing_fifo_after_retirement(scramble):
    """With one fold slot, the second signature waits in the queue until
    the first query's OptStop retirement frees the width."""
    sched = make_scheduler(scramble, max_slots=1)
    q1 = AggQuery(agg="avg", column="dep_delay",
                  stop=AbsoluteWidth(eps=2.0), delta=1e-9)
    q2 = AggQuery(agg="sum", column="dep_time",
                  stop=AbsoluteWidth(eps=5e5), delta=1e-9)
    sched.submit(q1, at=0.0)
    sched.submit(q2, at=0.001)
    sched.run_until_idle()
    t1, t2 = sched.tickets
    assert t1.status == t2.status == "done"
    assert t2.admit_t >= t1.finish_t         # queued behind the slot cap
    assert any(ev[2] == "retire" for ev in sched.log)


def test_same_boundary_same_signature_shares_a_slot(scramble):
    """Two same-signature queries admitted at one boundary merge into a
    single slot (one fold lane set, one cursor walk)."""
    sched = make_scheduler(scramble)
    qa = AggQuery(agg="avg", column="dep_delay",
                  stop=AbsoluteWidth(eps=2.0), delta=1e-9)
    qb = AggQuery(agg="avg", column="dep_delay",
                  stop=AbsoluteWidth(eps=4.0), delta=1e-9)
    ta = sched.submit(qa, at=0.0)
    tb = sched.submit(qb, at=0.0)
    sched.run_until_idle()
    assert ta._qc.slot is tb._qc.slot


def test_slo_reject_with_quote(scramble):
    sched = make_scheduler(scramble)
    hard = AggQuery(agg="avg", column="dep_delay",
                    stop=AbsoluteWidth(eps=1e-3), delta=1e-9)
    easy = AggQuery(agg="avg", column="dep_delay",
                    stop=AbsoluteWidth(eps=5.0), delta=1e-9)
    r = sched.submit(hard, deadline=0.002, at=0.0)
    ok = sched.submit(easy, deadline=30.0, at=0.0)
    sched.run_until_idle()
    assert r.status == "rejected"
    assert not r.quote.feasible
    assert r.quote.est_rounds > r.quote.round_budget
    # the quote tells the client what IS achievable by the deadline
    assert r.quote.width_at_deadline > r.quote.target_width
    assert "rounds" in r.quote.reason
    assert ok.status == "done" and ok.quote.feasible


def test_no_width_target_admits_without_quote_rejection(scramble):
    sched = make_scheduler(scramble)
    q = AggQuery(agg="avg", column="dep_delay", group_by="airline",
                 stop=ThresholdSide(threshold=0.0), delta=1e-6)
    tk = sched.submit(q, deadline=30.0, at=0.0)
    sched.run_until_idle()
    assert tk.status == "done"
    assert tk.quote.reason == "no width target"


# -- late-join soundness -------------------------------------------------------


def test_late_joiner_not_exact_until_prefix_covered(ds, scramble):
    """A query admitted at round r skipped the prefix ``[0, anchor)``;
    its views must not claim ``exact`` until its own lap (anchor ->
    anchor + nb) has covered every block, including that prefix."""
    frame = fresh_frame(scramble)
    srv = FrameServer(frame)
    p = srv.open_pass([])
    q1 = AggQuery(agg="avg", column="dep_delay",
                  stop=AbsoluteWidth(eps=1e-6), delta=1e-9)
    q2 = AggQuery(agg="sum", column="dep_delay",
                  stop=AbsoluteWidth(eps=1e-6), delta=1e-9)
    p.admit([q1])
    for _ in range(4):
        p.step()
    (qc2,) = p.admit([q2])
    anchor = qc2.slot.anchor
    assert anchor > 0
    lap_end = qc2.slot.lap_end
    while p.can_step:
        p.step()
        if p.pos < lap_end:
            assert not qc2.slot.exact.any(), (
                f"claimed exact at pos {p.pos} < lap_end {lap_end}")
    p.finish()
    assert p.pos >= lap_end
    assert bool(qc2.slot.exact.all())
    truth = float(ds.columns["dep_delay"].astype(np.float64).sum())
    r2 = p.result_of(q2)
    # engine folds per-block partial sums in f32: exact up to reorder
    assert r2.estimate[0] == pytest.approx(truth, rel=1e-4)
    assert bool(r2.exact.all())


def test_late_joiner_ci_contains_truth_at_every_sync(ds, scramble):
    """Every streamed snapshot of a mid-scan joiner must bracket the
    true aggregate — the skipped prefix is missing data, not bias."""
    frame = fresh_frame(scramble)
    truth = float(ds.columns["dep_delay"].astype(np.float64).mean())
    sched = QueryScheduler(FrameServer(frame), SimClock(), seed=1,
                           round_cost_s=1e-3, max_slots=4)
    q1 = AggQuery(agg="avg", column="dep_delay",
                  stop=AbsoluteWidth(eps=1.0), delta=1e-9)
    q2 = AggQuery(agg="avg", column="dep_delay",
                  stop=AbsoluteWidth(eps=0.5), delta=1e-9)
    seen = []
    # engine folds in f32; collapsed-exact endpoints carry reorder noise
    tol = 1e-4 * abs(truth)

    def on_stream(tk, t, rounds, width):
        if tk.query is q2:
            lo = float(tk._qc.lo[0])
            hi = float(tk._qc.hi[0])
            seen.append((lo, hi))
            assert lo - tol <= truth <= hi + tol, (t, rounds, lo, truth, hi)

    sched.on_stream = on_stream
    sched.submit(q1, at=0.0)
    sched.submit(q2, at=0.006)
    sched.run_until_idle()
    assert sched.tickets[1]._qc.slot.anchor > 0
    assert len(seen) > 3
    r2 = sched.tickets[1].result
    assert r2.lo[0] - tol <= truth <= r2.hi[0] + tol


# -- the device pass loop ------------------------------------------------------


def _burst_bitwise(scramble, n):
    frame = fresh_frame(scramble, device_loop=True)
    sched = QueryScheduler(FrameServer(frame), SimClock(), seed=1,
                           round_cost_s=1e-3, max_slots=4,
                           chunk_rounds=4)
    trace = burst_trace(make_query, n=n, seed=13)
    sched.submit_trace(trace)
    sched.run_until_idle()
    nb = frame.scramble.n_blocks
    for tk, arr in zip(sched.tickets, trace):
        assert tk.status == "done"
        anchor = tk._qc.slot.anchor
        solo = fresh_frame(scramble, device_loop=True).run(
            arr.query, sampling="active_peek", seed=1,
            start_block=anchor % nb)
        assert_bitwise_equal(tk.result, solo)
    return sched


def test_small_burst_bitwise_vs_solo_device_loop(scramble):
    """Six queries in a burst through the device pass loop (chunks of 4
    rounds, one membership epoch a step boundary): every result bit for
    bit its solo device-loop run."""
    sched = _burst_bitwise(scramble, 6)
    assert sched.frame.device_loops.misses >= 1


@pytest.mark.slow
def test_burst_bitwise_vs_solo_device_loop(scramble):
    """Device-resident chunked stepping through the scheduler stays
    bitwise-to-solo under a saturating burst."""
    _burst_bitwise(scramble, 16)


@pytest.mark.parametrize("loop", [False, True])
def test_pass_resumed_from_checkpoint_equals_uninterrupted(scramble, loop):
    """A pass checkpointed mid-scan (after a mid-scan join) and resumed
    through ``resume_pass`` finishes bit for bit the uninterrupted
    pass."""
    qs = [make_query(np.random.default_rng(i)) for i in range(4)]

    def open_and_admit(frame):
        p = FrameServer(frame).open_pass([], seed=1, chunk_rounds=3)
        p.admit(qs[:2])
        for _ in range(2):
            p.step()
        p.admit(qs[2:])
        p.step()
        return p

    frame = fresh_frame(scramble, device_loop=loop)
    a = open_and_admit(frame)
    cp = a.checkpoint()
    while a.can_step:
        a.step()
    a.finish()
    b = FrameServer(frame).resume_pass(cp, chunk_rounds=3)
    while b.can_step:
        b.step()
    b.finish()
    for q in qs:
        assert_bitwise_equal(b.result_of(q), a.result_of(q))


# -- soak (slow) ---------------------------------------------------------------


@pytest.mark.slow
def test_soak_500_query_trace(scramble):
    """Seeded 500-query simulated Poisson trace: zero dropped, zero
    duplicated, every per-query streamed CI width monotone
    non-increasing, and the whole interleaving replayable."""
    trace = poisson_trace(make_query, n=500, rate=400.0, seed=42)
    sched = run_trace(scramble, trace, max_slots=6)
    done = [tk for tk in sched.tickets if tk.status == "done"]
    # no SLOs in this trace -> nothing may be rejected or dropped
    assert len(done) == len(trace) == 500
    finishes = [ev for ev in sched.log if ev[2] == "finish"]
    assert len(finishes) == 500                     # no duplicates
    assert len({id(tk.result) for tk in done}) == 500
    for tk in done:
        assert tk.result is not None
        assert tk.finish_t >= tk.arrival_t
        widths = [w for (_, _, w) in tk.snapshots]
        assert all(b <= a + 1e-12
                   for a, b in zip(widths, widths[1:])), widths
    again = run_trace(scramble, trace, max_slots=6)
    assert_same_log(sched.log, again.log)


# -- a second trace of the same shape builds no new pass loop -----------------


def test_scheduler_rerun_builds_no_new_pass_loop(scramble):
    """The device pass loop is built once a membership epoch and cached
    on the frame: serving the same trace again (a fresh scheduler, the
    same frame) builds no new loop (no miss in ``frame.device_loops``)
    and gives the same results and event log."""
    frame = fresh_frame(scramble, device_loop=True)
    trace = poisson_trace(make_query, n=8, rate=50.0, seed=5)

    def run():
        sched = QueryScheduler(FrameServer(frame), SimClock(), seed=1,
                               round_cost_s=1e-3, max_slots=4,
                               chunk_rounds=4)
        sched.submit_trace(trace)
        sched.run_until_idle()
        return sched

    a = run()
    misses = frame.device_loops.misses
    assert misses >= 1
    b = run()
    assert frame.device_loops.misses == misses
    assert_same_log(a.log, b.log)
    for ta, tb in zip(a.tickets, b.tickets):
        assert ta.status == tb.status == "done"
        assert_bitwise_equal(ta.result, tb.result)
