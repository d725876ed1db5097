"""Fault-tolerant serving in the port (``repro_torch.serve`` driven by
``repro_torch.testing.faults``), the mirror of ``tests/test_faults.py``
case for case, on the CPU.

The contract under test, per the paper's anytime-valid semantics: a
fault never produces a wrong answer, only a later or wider one.

  * checkpoint/restore is **bitwise**: a pass resumed from the last
    merged-boundary snapshot finishes identically to one never
    interrupted, on both the host and device pass loops;
  * a faulted-and-retried scheduler run returns every result bitwise
    equal to the fault-free run of the same trace;
  * the degradation ladder's rungs are the existing oracle paths, so a
    degraded pass stays sound; when the ladder is exhausted (or an SLO
    deadline expires under a wall clock) running queries freeze at
    their current sound CI as partial-with-guarantee results;
  * a poison (NaN-fold) query is quarantined at a round boundary and
    its co-resident survivors are bitwise-identical to a run that never
    saw the poison;
  * fault schedules are pure functions of their seed (the reference's
    own events for the same arguments) and the whole chaos interleaving
    replays to an identical event log — the reference's log, for the
    same seeded workload and fault trace on the same scramble.

The reference's suite runs the host loop unless a case turns 64-bit JAX
on; the port's ``device_loop=None`` always resolves to the device pass
loop, so the mirrors of host-loop cases pin ``device_loop=False``
(``CFG``) and the device-loop cases ask for ``device_loop=True``. On a
frame divided over gloo ranks (``tests/helpers/torch_dist_world.py``), a
fault one rank alone sees moves every rank down the same rung.

All timing virtual (SimClock) except the wall-clock deadline test, which
needs real elapsed time to fire the deadline path. The module runs torch
on one thread (``one_torch_thread``).
"""

import types

import numpy as np
import pytest
import torch

import repro.aqp as R
from repro.core import optstop as Ro
from repro.serve import QueryScheduler as RQueryScheduler
from repro.serve import FrameServer as RFrameServer
from repro.serve import SimClock as RSimClock
from repro.testing import FaultInjector as RFaultInjector
from repro.testing import fault_schedule as r_fault_schedule
from repro.data import flights

from repro_torch.aqp import (AggQuery, EngineConfig, FastFrame,
                             build_scramble)
from repro_torch.core import optstop as To
from repro_torch.core.optstop import AbsoluteWidth
from repro_torch.serve import (FrameServer, QueryScheduler, SimClock,
                               UnsupportedPassConfig, WallClock)
from repro_torch.serve.frame_server import SharedPass
from repro_torch.testing import (FaultEvent, FaultInjector,
                                 InjectedOOM, fault_schedule)
from repro_torch.testing.faults import KINDS, InjectedFault

from tests.helpers.sim_workload import (assert_same_log, burst_trace,
                                        poisson_trace)
from tests.helpers.torch_parity import (  # noqa: F401 (module fixture)
    exact_flights_columns, one_torch_thread, port_scramble)
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


def query_maker(Q, opt):
    """The reference suite's query mix, built from ``Q`` / ``opt`` (the
    port's classes or the reference's)."""
    def make_query(rng: np.random.Generator):
        agg = ["avg", "sum", "count"][int(rng.integers(3))]
        eps = {"avg": float(rng.uniform(0.5, 4.0)),
               "sum": float(rng.uniform(5e4, 5e5)),
               "count": float(rng.uniform(500.0, 5e3))}[agg]
        return Q(agg=agg, column="dep_delay",
                 stop=opt.AbsoluteWidth(eps=eps), delta=1e-9)
    return make_query


make_query = query_maker(AggQuery, To)


def truth_of(ds, q: AggQuery) -> float:
    col = np.asarray(ds.columns["dep_delay"], dtype=np.float64)
    valid = np.isfinite(col)
    return {"avg": float(col[valid].mean()),
            "sum": float(col[valid].sum()),
            "count": float(valid.sum())}[q.agg]


def assert_sound(ds, q: AggQuery, res) -> None:
    t = truth_of(ds, q)
    tol = 1e-3 + 1e-4 * abs(t)   # float32 fold slack (cf. test_serve)
    assert float(res.lo[0]) - tol <= t <= float(res.hi[0]) + tol, (
        q.agg, float(res.lo[0]), t, float(res.hi[0]))


def make_scheduler(scramble, frame=None, **over):
    frame = frame if frame is not None else fresh_frame(scramble)
    kw = dict(seed=1, round_cost_s=1e-3, max_slots=4)
    kw.update(over)
    return QueryScheduler(FrameServer(frame), SimClock(), **kw)


# -- checkpoint / resume -------------------------------------------------------


def _run_out(p: SharedPass, queries):
    while p.can_step:
        p.step()
    p.finish()
    return [p.result_of(q) for q in queries]


def test_checkpoint_resume_bitwise_host(scramble):
    """Interrupt a host-loop pass mid-scan, resume from the snapshot:
    every result bitwise equal to the uninterrupted pass."""
    rng = np.random.default_rng(0)
    qs = [make_query(rng) for _ in range(3)]

    srv = FrameServer(fresh_frame(scramble))
    p = srv.open_pass([])
    p.admit(qs)
    for _ in range(4):
        p.step()
    cp = p.checkpoint()
    ref = _run_out(p, qs)             # the uninterrupted continuation

    resumed = srv.resume_pass(cp)     # "crash" + rebuild from snapshot
    out = _run_out(resumed, qs)
    for a, b in zip(ref, out):
        assert_bitwise_equal(a, b)


def test_checkpoint_resume_bitwise_carousel(scramble):
    """A late joiner's anchored slot (carousel coordinates) survives
    the snapshot: resume mid-lap stays bitwise."""
    rng = np.random.default_rng(1)
    q1, q2 = make_query(rng), make_query(rng)
    srv = FrameServer(fresh_frame(scramble))
    p = srv.open_pass([])
    p.admit([q1])
    for _ in range(3):
        p.step()
    p.admit([q2])                     # anchor > 0: wrapped pass
    p.step()
    cp = p.checkpoint()
    assert cp.wrap
    ref = _run_out(p, [q1, q2])
    out = _run_out(srv.resume_pass(cp), [q1, q2])
    for a, b in zip(ref, out):
        assert_bitwise_equal(a, b)


def test_checkpoint_resume_bitwise_device_loop(scramble):
    """Device-loop chunk boundaries are fully merged carries, so a
    snapshot there resumes bitwise too."""
    rng = np.random.default_rng(2)
    qs = [make_query(rng) for _ in range(2)]
    srv = FrameServer(fresh_frame(scramble, device_loop=True))
    p = srv.open_pass([], chunk_rounds=4)
    p.admit(qs)
    p.step()                          # one chunk dispatch
    assert p.device_pass
    cp = p.checkpoint()
    ref = _run_out(p, qs)
    out = _run_out(srv.resume_pass(cp, chunk_rounds=4), qs)
    for a, b in zip(ref, out):
        assert_bitwise_equal(a, b)


def test_resume_degraded_to_host_is_sound(ds, scramble):
    """The device->host ladder rung: a device-loop checkpoint resumed
    under force_host finishes every query with a sound CI (the host
    loop is the oracle, so only the remaining schedule changes)."""
    rng = np.random.default_rng(3)
    qs = [make_query(rng) for _ in range(2)]
    srv = FrameServer(fresh_frame(scramble, device_loop=True))
    p = srv.open_pass([], chunk_rounds=4)
    p.admit(qs)
    p.step()
    cp = p.checkpoint()
    degraded = srv.resume_pass(cp, force_host=True)
    assert not degraded.device_pass
    for q, res in zip(qs, _run_out(degraded, qs)):
        assert_sound(ds, q, res)


def test_checkpoint_keeps_finished_results(scramble):
    """Results finalized before the snapshot ride along: after resume,
    result_of answers for already-finished (even retired) queries."""
    rng = np.random.default_rng(4)
    easy = AggQuery(agg="count", column="dep_delay",
                    stop=AbsoluteWidth(eps=5e4), delta=1e-9)
    hard = make_query(rng)
    srv = FrameServer(fresh_frame(scramble))
    p = srv.open_pass([])
    p.admit([easy, hard])
    while id(p._qc_of[id(easy)]) not in p.finished:
        p.step()
    first = p.result_of(easy)
    p.retire()                        # drop the finished slot
    cp = p.checkpoint()
    resumed = srv.resume_pass(cp)
    assert_bitwise_equal(resumed.result_of(easy), first)
    out = _run_out(resumed, [hard])
    assert out[0] is not None


# -- deterministic fault injection ---------------------------------------------


def test_fault_schedule_is_pure():
    a = fault_schedule(7, 500, rate=0.1)
    b = fault_schedule(7, 500, rate=0.1)
    assert a == b
    assert a != fault_schedule(8, 500, rate=0.1)
    assert all(0 <= ev.step < 500 and ev.kind and 0 <= ev.arg < 1
               for ev in a)


@pytest.mark.parametrize("seed,n,rate,kinds", [
    (7, 500, 0.1, KINDS), (13, 400, 0.08, KINDS), (23, 3000, 0.05, KINDS),
    (0, 64, 1.0, KINDS), (5, 200, 0.3, ("dispatch", "nan"))])
def test_fault_schedule_equals_reference(seed, n, rate, kinds):
    """The same events, kinds and args as the reference's schedule."""
    got = fault_schedule(seed, n, rate=rate, kinds=kinds)
    want = r_fault_schedule(seed, n, rate=rate, kinds=kinds)
    assert [tuple(e) for e in got] == [tuple(e) for e in want]
    assert len(got) > 0


def test_injected_oom_is_torch_oom(scramble):
    """A handler for torch's OOM class catches the injected one, whose
    message holds the text the scheduler classifies on; the other kinds
    keep their markers."""
    with pytest.raises(torch.OutOfMemoryError, match="out of memory"):
        raise InjectedOOM("at step 3")
    assert isinstance(InjectedOOM(), InjectedFault)
    classify = make_scheduler(scramble)._classify_failure
    assert classify(InjectedOOM()) == "oom"
    assert classify(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")) == "oom"
    kinds = {}
    for kind in ("dispatch", "transfer", "shard"):
        inj = FaultInjector([FaultEvent(0, kind, 0.0)])
        pas = types.SimpleNamespace(rounds=5)
        with pytest.raises(InjectedFault) as err:
            inj.before_step(None, pas, 0.0)
        kinds[kind] = (classify(err.value), pas.rounds)
    assert kinds == {"dispatch": ("dispatch", 5), "transfer": ("transfer", 6),
                     "shard": ("shard", 5)}


def test_dispatch_fault_retry_is_bitwise(scramble):
    """Transient dispatch faults (incl. a partially-applied 'transfer'
    step) are retried from the checkpoint: every ticket's result is
    bitwise equal to the fault-free run of the same trace."""
    trace = burst_trace(make_query, n=3, seed=21)
    clean = make_scheduler(scramble)
    clean.submit_trace(trace)
    clean.run_until_idle()

    faults = [FaultEvent(2, "dispatch", 0.0),
              FaultEvent(5, "transfer", 0.0),
              FaultEvent(9, "shard", 0.0)]
    faulty = make_scheduler(scramble, fault_hook=FaultInjector(faults),
                            max_retries=10)
    faulty.submit_trace(trace)
    faulty.run_until_idle()

    kinds = [ev[2] for ev in faulty.log]
    assert "fault" in kinds and "retry" in kinds
    for tc, tf in zip(clean.tickets, faulty.tickets):
        assert tc.status == tf.status == "done"
        assert not tf.partial
        assert_bitwise_equal(tc.result, tf.result)


def test_fault_replay_identical_log(scramble):
    """Seeded faults x seeded workload: the whole interleaving —
    faults, retries, degradations included — replays to an identical
    event log with a fresh injector."""
    trace = poisson_trace(make_query, n=8, rate=200.0, seed=5)
    sched_faults = fault_schedule(13, 400, rate=0.08)

    def run():
        s = make_scheduler(scramble,
                           fault_hook=FaultInjector(sched_faults))
        s.submit_trace(trace)
        s.run_until_idle()
        return s

    a, b = run(), run()
    assert_same_log(a.log, b.log)
    for ta, tb in zip(a.tickets, b.tickets):
        assert ta.status == tb.status
        if ta.result is not None:
            assert_bitwise_equal(ta.result, tb.result)


def test_clock_skew_logged_and_deterministic(scramble):
    trace = burst_trace(make_query, n=2, seed=3)
    faults = [FaultEvent(1, "skew", 0.5), FaultEvent(3, "skew", 0.9)]

    def run():
        s = make_scheduler(scramble, fault_hook=FaultInjector(faults))
        s.submit_trace(trace)
        s.run_until_idle()
        return s

    a, b = run(), run()
    assert_same_log(a.log, b.log)
    assert sum(ev[2] == "skew" for ev in a.log) == 2


# -- the reference's scheduler under the same faults ---------------------------


@pytest.mark.parametrize("fault_seed,rate", [(13, 0.25), (29, 0.4),
                                             (7, 0.3)])
def test_fault_log_equals_reference_scheduler(ds, fault_seed, rate):
    """One seeded Poisson workload x one seeded fault trace over all six
    kinds through the reference's QueryScheduler + FaultInjector and the
    port's, each on its host pass loop over one scramble (integer data:
    the f32 folds are bitwise alike): the same event log — every fault,
    retry, degrade, quarantine, freeze and finish at the same virtual
    time, every logged width bit for bit — and every result's decisions
    exact, its CI endpoints within 1e-9. The three traces cover all six
    kinds between them, a quarantine and an exhausted ladder."""
    cols = exact_flights_columns(ds.columns)
    catalog = dict(ds.catalog, dep_delay=(0.0, 16.0))
    rsc = R.build_scramble(cols, catalog=catalog, block_rows=256, seed=4)
    r_frame = R.FastFrame(rsc, R.EngineConfig(**CFG))
    t_frame = FastFrame(port_scramble(rsc), EngineConfig(**CFG),
                        device="cpu")
    faults = r_fault_schedule(fault_seed, 400, rate=rate)
    kw = dict(seed=1, round_cost_s=1e-3, max_slots=4, checkpoint_every=2,
              max_retries=2)
    r_sched = RQueryScheduler(RFrameServer(r_frame), RSimClock(),
                              fault_hook=RFaultInjector(faults), **kw)
    t_sched = QueryScheduler(FrameServer(t_frame), SimClock(),
                             fault_hook=FaultInjector(
                                 fault_schedule(fault_seed, 400, rate=rate)),
                             **kw)
    r_sched.submit_trace(poisson_trace(query_maker(R.AggQuery, Ro), n=8,
                                       rate=200.0, seed=5))
    t_sched.submit_trace(poisson_trace(make_query, n=8, rate=200.0, seed=5))
    r_sched.run_until_idle()
    t_sched.run_until_idle()
    kinds = {ev[2] for ev in t_sched.log}
    assert "fault" in kinds and "retry" in kinds
    assert_same_log(t_sched.log, r_sched.log)
    for tt, rt in zip(t_sched.tickets, r_sched.tickets):
        assert (tt.status, tt.partial) == (rt.status, rt.partial)
        assert tt.finish_t == pytest.approx(rt.finish_t, rel=1e-12)
        if rt.result is None:
            assert tt.result is None
            continue
        for f in ("count_seen", "exact", "tainted", "rows_covered",
                  "blocks_fetched", "rounds", "stopped_early"):
            np.testing.assert_array_equal(getattr(tt.result, f),
                                          getattr(rt.result, f), f)
        for f in ("estimate", "lo", "hi"):
            np.testing.assert_allclose(getattr(tt.result, f),
                                       getattr(rt.result, f), rtol=1e-12,
                                       atol=1e-9, err_msg=f)


# -- degradation ladder --------------------------------------------------------


def test_ladder_exhausted_freezes_partial_sound(ds, scramble):
    """Permanent dispatch failure on a host-loop pass (no rung left):
    running queries freeze at their current sound CI as
    partial-with-guarantee results; nothing is dropped."""
    trace = burst_trace(make_query, n=2, seed=11)
    # let a few clean steps land first so the frozen CI is non-trivial
    faults_after = [FaultEvent(i + 3, "dispatch", 0.0)
                    for i in range(64)]
    sched = make_scheduler(scramble,
                           fault_hook=FaultInjector(faults_after),
                           max_retries=2)
    sched.submit_trace(trace)
    sched.run_until_idle()
    kinds = [ev[2] for ev in sched.log]
    assert "ladder-exhausted" in kinds
    for tk in sched.tickets:
        assert tk.status == "done"
        assert tk.partial
        assert tk.result.stopped_early
        assert_sound(ds, tk.query, tk.result)


def test_oom_degrades_chunk_then_host(scramble):
    """Repeated OOM on a device-loop pass walks the ladder: shrink
    chunk_rounds, then fall back to the host oracle loop; the queries
    still finish (not partial) and the rungs are logged."""
    frame = fresh_frame(scramble, device_loop=True)
    faults = [FaultEvent(i, "oom", 0.0) for i in range(256)]
    sched = make_scheduler(scramble, frame=frame, chunk_rounds=4,
                           fault_hook=FaultInjector(faults),
                           max_retries=1, max_backoff_s=1e-2)
    trace = burst_trace(make_query, n=2, seed=7)
    sched.submit_trace(trace)
    sched.run_until_idle()
    degrades = [ev[3][0] for ev in sched.log if ev[2] == "degrade"]
    assert degrades == ["chunk_rounds=2", "chunk_rounds=1", "host-loop"]
    # with every attempt faulting, the ladder ends exhausted and the
    # tickets freeze partial — sound but wide
    assert all(tk.status == "done" for tk in sched.tickets)


def test_oom_chunk_halving_recovers(scramble):
    """An OOM burst that stops once the chunk shrinks: the pass
    finishes normally at the smaller dispatch size (no freeze)."""
    # max_retries=1 -> attempts 1,2 fault then degrade to chunk//2,
    # after which injection stops and the pass completes
    faults = [FaultEvent(1, "oom", 0.0), FaultEvent(2, "oom", 0.0)]
    sched = make_scheduler(scramble, fault_hook=FaultInjector(faults),
                           max_retries=1, chunk_rounds=8)
    trace = burst_trace(make_query, n=2, seed=9)
    sched.submit_trace(trace)
    sched.run_until_idle()
    assert "chunk_rounds=4" in [ev[3][0] for ev in sched.log
                                if ev[2] == "degrade"]
    for tk in sched.tickets:
        assert tk.status == "done"
        assert not tk.partial


def test_host_loop_pass_has_no_chunk_rung(scramble):
    """A host-loop pass asked for no chunk has none to halve (as in the
    reference): an OOM there exhausts the ladder after its retries."""
    p = FrameServer(fresh_frame(scramble)).open_pass([])
    assert not p.device_pass and p.chunk is None
    sched = make_scheduler(scramble, max_retries=0, fault_hook=FaultInjector(
        [FaultEvent(i, "oom", 0.0) for i in range(8)]))
    sched.submit_trace(burst_trace(make_query, n=1, seed=2))
    sched.run_until_idle()
    assert not any(ev[2] == "degrade" for ev in sched.log)
    assert "ladder-exhausted" in [ev[2] for ev in sched.log]


def test_degrade_requotes_slo_tickets(scramble):
    """Regression (stale SLO budgets): a degrade must re-price every
    SLO-bearing ticket at the pass's post-degrade round cost — a
    ``requote`` event per ticket, the fresh quote on the ticket."""
    faults = [FaultEvent(0, "dispatch", 0.0),
              FaultEvent(1, "dispatch", 0.0)]
    frame = fresh_frame(scramble, device_loop=True)
    sched = make_scheduler(scramble, frame=frame, chunk_rounds=4,
                           fault_hook=FaultInjector(faults),
                           max_retries=1, checkpoint_every=1)
    rng = np.random.default_rng(3)
    tk = sched.submit(make_query(rng), deadline=60.0, at=0.0)
    sched.run_until_idle()
    kinds = [ev[2] for ev in sched.log]
    assert "degrade" in kinds
    assert "requote" in kinds
    assert tk.status == "done"
    assert tk.quote is not None
    # the requoted budget is priced from the degrade time, so it is
    # strictly below the admission-time budget of the full deadline
    assert tk.quote.round_budget < int(60.0 / sched.round_cost_s)


def test_unsharded_rung_scales_round_cost(scramble):
    """The unsharded rung puts the divided scan back on one device —
    ~n_shards x the per-round gather/fold — so the ladder scales the
    pass's effective round cost by n_shards; the host-loop rung keeps
    per-round work unchanged."""
    from repro_torch.serve.scheduler import _PassState
    sched = make_scheduler(scramble)
    fake_pas = types.SimpleNamespace(
        shards=types.SimpleNamespace(n_shards=4), device_pass=True,
        chunk=None)
    ps = _PassState(("k",), fake_pas, (("k",), 0))
    assert sched._degrade_action(ps, "dispatch") == "unsharded"
    assert ps.cost_mult == 4.0
    assert sched._round_cost(ps) == sched.round_cost_s * 4.0
    assert sched._degrade_action(ps, "dispatch") == "host-loop"
    assert ps.cost_mult == 4.0      # host loop: same per-round work


@pytest.fixture(scope="module")
def gloo_pair(tmp_path_factory):
    """Two gloo ranks on the CPU, for the agreement cases."""
    from tests.helpers.torch_dist_world import DistWorld
    w = DistWorld(2, tmp_path_factory.mktemp("gloo"))
    yield w
    w.close()


@pytest.mark.parametrize("faulty,kinds,rung", [
    ([0], ["shard", "shard", "shard"], "unsharded"),
    ([1], ["oom", "oom", "oom"], "chunk_rounds=1"),
    ([0, 1], ["dispatch", "dispatch", "dispatch"], "unsharded"),
])
def test_fault_one_rank_sees_moves_every_rank(gloo_pair, faulty, kinds,
                                              rung):
    """A scheduler burst on a frame divided over 2 gloo ranks, faults
    injected at step attempts 1-3 on the ranks in ``faulty`` only: the
    ranks agree on each fault (one MAX all-reduce of its kind), so both
    retry, then take the same rung, log the same events, and end with
    the same results; none hangs in a collective the other skipped."""
    outs = gloo_pair.run("fault_agreement", timeout=120, faults=faulty,
                         kinds=kinds)
    a, b = outs
    assert a["log"] == b["log"]
    assert a["results"] == b["results"]
    assert a["statuses"] == b["statuses"] == ["done"] * 3
    log = a["log"]
    assert sum("'fault'" in ev for ev in log) == 3
    assert sum("'retry'" in ev for ev in log) == 2
    degrades = [ev for ev in log if "'degrade'" in ev]
    assert len(degrades) == 1 and repr(rung) in degrades[0], degrades


# -- quarantine ----------------------------------------------------------------


def _poison_run(scramble, frame_over, **sched_over):
    trace = burst_trace(make_query, n=3, seed=31)
    clean = make_scheduler(scramble, frame=fresh_frame(scramble,
                                                       **frame_over),
                           **sched_over)
    clean.submit_trace(trace)
    clean.run_until_idle()

    faulty = make_scheduler(
        scramble, frame=fresh_frame(scramble, **frame_over),
        fault_hook=FaultInjector([FaultEvent(1, "nan", 0.0)]),
        **sched_over)
    faulty.submit_trace(trace)
    faulty.run_until_idle()

    statuses = [tk.status for tk in faulty.tickets]
    assert statuses.count("quarantined") >= 1
    assert "quarantine" in [ev[2] for ev in faulty.log]
    survivors = 0
    for tc, tf in zip(clean.tickets, faulty.tickets):
        if tf.status == "quarantined":
            assert tf.result is None
            continue
        assert tf.status == "done"
        assert_bitwise_equal(tc.result, tf.result)
        survivors += 1
    assert survivors >= 1
    return faulty


def test_nan_poison_quarantined_survivors_bitwise(scramble):
    """A NaN-poisoned slot is evicted at the round boundary; the other
    slots' queries finish bitwise-identical to a run with no poison."""
    _poison_run(scramble, {})


def test_nan_poison_quarantined_on_device_pass_loop(scramble):
    """The same poison on the device pass loop: the NaN lands in the
    slot's host views, which the next step uploads, so the slot is caught
    (by the host sentinel at once) and evicted, and the survivors stay
    bitwise their fault-free run."""
    faulty = _poison_run(scramble, dict(device_loop=True), chunk_rounds=4)
    assert faulty.frame.device_loops.misses >= 1


def test_admit_shape_error_isolated(scramble):
    """A per-query admission error (nonexistent column) fails that
    ticket alone; co-submitted queries are served normally."""
    rng = np.random.default_rng(41)
    good = [make_query(rng) for _ in range(2)]
    bad = AggQuery(agg="avg", column="no_such_column",
                   stop=AbsoluteWidth(eps=1.0), delta=1e-9)
    sched = make_scheduler(scramble)
    tks = [sched.submit(q, at=0.0) for q in [good[0], bad, good[1]]]
    sched.run_until_idle()
    assert tks[1].status == "failed"
    assert "admit-error" in [ev[2] for ev in sched.log]
    for tk in (tks[0], tks[2]):
        assert tk.status == "done"
        assert tk.result is not None


# -- unsupported admission + reroute -------------------------------------------


def test_unsupported_pass_config_raises_before_mutation(scramble):
    """The cadence-mid-scan-join check fires at the top of admit(): a
    typed error, no slot / live-count change (plain sharded carousels
    compose; only the merge_every > 1 collective cadence rejects a
    mid-lap joiner). admit()'s other refusal, a query whose filters are
    not the pass's, also raises before anything changes, and the pass
    stays healthy."""
    import types
    from repro_torch.aqp import Filter
    rng = np.random.default_rng(51)
    srv = FrameServer(fresh_frame(scramble))
    p = srv.open_pass([])
    p.admit([make_query(rng)])
    p.step()
    assert p.pos > 0
    # pretend the frame is sharded on a collective cadence
    p.shards = types.SimpleNamespace(merge_every=2)
    n_slots, n_live = len(p.slots), p.n_live
    with pytest.raises(UnsupportedPassConfig):
        p.admit([make_query(rng)])
    assert len(p.slots) == n_slots and p.n_live == n_live
    p.shards = None
    other = AggQuery(agg="avg", column="dep_delay",
                     filters=(Filter("day_of_week", "le", 5),),
                     stop=AbsoluteWidth(eps=1.0), delta=1e-9)
    with pytest.raises(ValueError, match="filters"):
        p.admit([make_query(rng), other])
    assert len(p.slots) == n_slots and p.n_live == n_live
    _run_out(p, [])                   # pass still healthy


def test_wrapped_restore_refused_on_a_cadence_pass(scramble):
    """A wrapped (carousel) checkpoint cannot be restored onto a pass
    running the collective cadence (the late joiner's refresh schedule
    would be quantized to merges): UnsupportedPassConfig before any
    state changes, and the same checkpoint restores onto a
    per-round-merge pass. The checkpoint records the layout it was taken
    on (None: one device)."""
    import types
    rng = np.random.default_rng(1)
    q1, q2 = make_query(rng), make_query(rng)
    srv = FrameServer(fresh_frame(scramble))
    p = srv.open_pass([])
    p.admit([q1])
    p.step()
    p.admit([q2])                     # anchor > 0: wrapped pass
    p.step()
    cp = p.checkpoint()
    assert cp.wrap and cp.layout is None
    fresh = srv.open_pass([])
    fresh.shards = types.SimpleNamespace(merge_every=2)
    with pytest.raises(UnsupportedPassConfig):
        fresh.restore(cp)
    assert fresh.slots == [] and fresh.rounds == 0
    fresh.shards = None
    fresh.restore(cp)
    assert fresh.rounds == p.rounds and len(fresh.slots) == len(p.slots)


class _NoCarouselPass(SharedPass):
    """Stand-in for a pass that refuses mid-scan admission."""

    def admit(self, queries, t0=None):
        if self.pos > 0 or self.wrap:
            raise UnsupportedPassConfig("no carousel (test stand-in)")
        return super().admit(queries, t0=t0)


class _NoCarouselServer(FrameServer):
    def open_pass(self, filters, sampling="active_peek",
                  start_block=None, seed=0, max_rounds=100_000,
                  chunk_rounds=None):
        return _NoCarouselPass(self.frame, filters, sampling,
                               start_block, seed, max_rounds,
                               chunk_rounds)


def test_scheduler_reroutes_unsupported_admission(scramble):
    """A late joiner whose admission raises UnsupportedPassConfig is
    routed to a fresh pass generation instead of crashing the loop —
    and, served from anchor 0, stays bitwise-to-solo."""
    rng = np.random.default_rng(61)
    q1, q2 = make_query(rng), make_query(rng)
    sched = QueryScheduler(_NoCarouselServer(fresh_frame(scramble)),
                           SimClock(), seed=1, round_cost_s=1e-3)
    t1 = sched.submit(q1, at=0.0)
    t2 = sched.submit(q2, at=0.005)   # arrives mid-scan of q1's pass
    sched.run_until_idle()
    assert "reroute" in [ev[2] for ev in sched.log]
    assert t1.status == t2.status == "done"
    solo = fresh_frame(scramble).run(q2, sampling="active_peek",
                                     start_block=0)
    assert_bitwise_equal(t2.result, solo)


# -- deadlines -----------------------------------------------------------------


def test_wallclock_deadline_freezes_partial(ds, scramble):
    """WallClock mode fires deadlines too. A feasible-at-admission query
    whose deadline elapses mid-run freezes at its current sound CI
    (partial), instead of running forever."""
    q = AggQuery(agg="avg", column="dep_delay",
                 stop=AbsoluteWidth(eps=1e-9), delta=1e-9)  # ~never stops
    # round_blocks=1: ~400 host rounds to exact completion (real seconds
    # of wall time); round_cost_s=1e-25 prices the quote's round budget
    # far above the Hoeffding projection, so admission is feasible and
    # the deadline can only fire through the wall-clock path
    sched = QueryScheduler(FrameServer(fresh_frame(scramble,
                                                   round_blocks=1)),
                           WallClock(), seed=1, round_cost_s=1e-25)
    tk = sched.submit(q, deadline=0.05)
    sched.run_until_idle()
    assert tk.status == "done"
    assert tk.partial
    assert tk.result.stopped_early
    assert_sound(ds, q, tk.result)
    assert "finish-partial" in [ev[2] for ev in sched.log]


def test_simclock_deadline_rejects_queued(scramble):
    """A ticket still queued (capacity-blocked) when its deadline
    passes is rejected with a quote, not left in limbo."""
    rng = np.random.default_rng(71)
    hogs = [make_query(rng) for _ in range(4)]
    late = make_query(rng)
    sched = make_scheduler(scramble, max_slots=1)
    for h in hogs:
        sched.submit(h, at=0.0)
    tk = sched.submit(late, deadline=0.001, at=0.0)
    sched.run_until_idle()
    assert tk.status == "rejected"
    assert tk.quote is not None


# -- chaos soak ----------------------------------------------------------------


def _chaos(ds, scramble, n, n_steps, frame_over=None, **sched_over):
    trace = poisson_trace(make_query, n=n, rate=400.0, seed=17)
    sched_faults = fault_schedule(23, n_steps, rate=0.05)

    def run():
        kw = dict(max_slots=4, checkpoint_every=2, max_retries=2)
        kw.update(sched_over)
        s = make_scheduler(scramble,
                           frame=fresh_frame(scramble, **(frame_over or {})),
                           fault_hook=FaultInjector(sched_faults), **kw)
        s.submit_trace(trace)
        s.run_until_idle()
        return s

    s1 = run()
    terminal = {"done", "rejected", "failed", "quarantined"}
    statuses = [tk.status for tk in s1.tickets]
    assert len(statuses) == len(trace)
    assert all(st in terminal for st in statuses), statuses
    n_results = 0
    for tk in s1.tickets:
        if tk.status == "done":
            assert tk.result is not None
            assert_sound(ds, tk.query, tk.result)
            n_results += 1
        else:
            assert tk.result is None
    # nothing duplicated: one finish-type log event per done ticket
    finishes = [ev for ev in s1.log
                if ev[2] in ("finish", "finish-partial")]
    assert len(finishes) == n_results
    assert n_results >= 1          # the chaos didn't kill everything

    s2 = run()
    assert_same_log(s1.log, s2.log)
    for ta, tb in zip(s1.tickets, s2.tickets):
        assert ta.status == tb.status
        if ta.result is not None:
            assert_bitwise_equal(ta.result, tb.result)
    return s1


@pytest.mark.parametrize("loop", ["host", "device"])
def test_chaos_soak_sound_and_replayable(ds, scramble, loop):
    """Seeded Poisson workload x seeded fault trace: every returned
    interval brackets ground truth, every ticket reaches a terminal
    state exactly once (nothing dropped, nothing duplicated), and the
    whole run replays to an identical event log — on the host pass loop
    (the reference's case) and on the device pass loop (chunks of 4)."""
    over = ({} if loop == "host"
            else dict(frame_over=dict(device_loop=True), chunk_rounds=4))
    s = _chaos(ds, scramble, 40, 3000, **over)
    kinds = [ev[2] for ev in s.log]
    assert kinds.count("fault") >= 2 and "retry" in kinds


# -- probe-slot co-residency ---------------------------------------------------


def test_probe_coresidency_bitwise(ds, scramble):
    """A GROUP BY probe slot sharing a pass with other queries is
    BITWISE identical to its solo run — every slot advances its own
    cursor with its own activity flags, so a co-resident's engagement
    bits never perturb the probe's selection."""
    probe = AggQuery(agg="avg", column="dep_delay", group_by="airline",
                     stop=AbsoluteWidth(eps=2.0), delta=1e-9)
    other = AggQuery(agg="count", column="dep_delay",
                     stop=AbsoluteWidth(eps=1e3), delta=1e-9)
    sched = make_scheduler(scramble)
    tp = sched.submit(probe, at=0.0)
    sched.submit(other, at=0.0)
    sched.run_until_idle()
    assert tp.status == "done"
    solo = fresh_frame(scramble).run(probe, sampling="active_peek",
                                     start_block=0)
    assert_bitwise_equal(tp.result, solo)
    # and the interval is still sound against ground truth per group
    res = tp.result
    col = np.asarray(ds.columns["dep_delay"], dtype=np.float64)
    gid = np.asarray(ds.columns["airline"])
    valid = np.isfinite(col)
    for g in range(len(res.group_codes)):
        sel = valid & (gid == g)
        if not sel.any() or not res.nonempty[g]:
            continue
        t = float(col[sel].mean())
        tol = 1e-3 + 1e-5 * abs(t)
        assert res.lo[g] - tol <= t <= res.hi[g] + tol, (g, t)


def test_poisoned_host_views_reach_the_device_sentinel(scramble):
    """The device pass loop uploads the slot's host views each step, so
    a NaN written there (what the ``nan`` fault does) is in the next
    chunk's carry: the kernel-layer sentinel flags that slot alone, and
    ``quarantine`` evicts it and no other."""
    rng = np.random.default_rng(81)
    q1 = make_query(rng)
    q2 = AggQuery(agg="avg", column="dep_time",
                  stop=AbsoluteWidth(eps=1.0), delta=1e-9)
    p = FrameServer(fresh_frame(scramble, device_loop=True)).open_pass(
        [], chunk_rounds=2)
    p.admit([q1, q2])
    p.step()
    assert p._sentinel == (False, False)
    victim = p.slots[1]
    mean = np.array(victim.views.state.mean, dtype=np.float64)
    mean[0] = np.nan
    victim.views.state = victim.views.state._replace(mean=mean)
    p.step()
    assert p._sentinel == (False, True)
    assert p.quarantine() == [q2]
    assert [s.qcis[0].q for s in p.slots] == [q1]
    _run_out(p, [q1])


def test_device_oom_hook_refuses_the_cpu():
    """The real-OOM hook asks the card for twice its memory; on the CPU
    such an allocation could succeed lazily, so it is refused."""
    from repro_torch.testing import DeviceOOMHook
    with pytest.raises(ValueError, match="needs a CUDA device"):
        DeviceOOMHook([1, 2], device="cpu")
