"""The port's FrameServer (``repro_torch.serve``) on the CPU, the mirror
of ``tests/test_serve.py``: a served single query is BITWISE identical
to ``FastFrame.run`` through both the per-round host pass loop and the
device pass loop (each against the solo loop of its kind), shared
multi-query passes stay sound (every interval covers the exact truth),
and the port's served results meet the port-against-reference contract
against the reference's ``FrameServer`` on the same scramble:

  * scan decisions, coverage, taint, ``exact`` and scan metrics EXACTLY;
  * CI endpoints and estimates within 1e-9 on exactly-representable data
    (rtol 1e-12 for SUM/COUNT endpoints of row-count scale), 1e-6
    relative on general f32 data (``tests/helpers/torch_parity.py``).

Coverage tolerance against the float64 truth: 1e-3 absolute, as the
reference's suite (the engine folds in float32).

The module runs torch on one thread (``one_torch_thread``): the eager
loops are thousands of small ops, which intra-op threads slow under
xdist.
"""

import numpy as np
import pytest
import torch

import repro.aqp as R
from repro.core import optstop as Ro
from repro.data import flights
from repro.serve import FrameServer as RFrameServer

from repro_torch.aqp import (AggQuery, EngineConfig, FastFrame, Filter,
                             build_scramble)
from repro_torch.core import optstop as To
from repro_torch.core.optstop import (AbsoluteWidth, GroupsOrdered,
                                      ThresholdSide, TopKSeparated)
from repro_torch.kernels import ops
from repro_torch.serve import FrameServer

from tests.helpers.torch_parity import (  # noqa: F401 (module fixture)
    assert_port_matches_ref, exact_flights_columns, one_torch_thread,
    port_scramble)

RESULT_FIELDS = [
    "group_codes", "estimate", "lo", "hi", "count_seen", "nonempty",
    "exact", "tainted", "rows_covered", "blocks_fetched",
    "blocks_skipped_active", "blocks_skipped_static", "bitmap_probes",
    "rounds", "stopped_early",
]

CFG = dict(round_blocks=16, lookahead_blocks=64, sync_lookahead_blocks=16,
           hist_bins=256)
LOOPS = {"host": dict(device_loop=False), "device": dict(device_loop=None)}


def assert_bitwise_equal(a_res, b_res):
    for f in RESULT_FIELDS:
        a, b = getattr(a_res, f), getattr(b_res, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, (f, a, b)


@pytest.fixture(scope="module")
def ds():
    return flights.generate(n_rows=100_000, n_airports=80, n_airlines=6,
                            seed=3)


def fresh_frame(ds, **over):
    kw = dict(CFG)
    kw.update(over)
    sc = build_scramble(ds.columns, catalog=ds.catalog, block_rows=256,
                        seed=4)
    return FastFrame(sc, EngineConfig(**kw), device="cpu")


SINGLE_QUERIES = [
    ("avg-group-topk",
     AggQuery(agg="avg", column="dep_delay", group_by="origin",
              stop=TopKSeparated(k=2, largest=True), delta=1e-9),
     "active_peek"),
    ("avg-group-thresh-sync",
     AggQuery(agg="avg", column="dep_delay", group_by="origin",
              stop=ThresholdSide(threshold=0.0), delta=1e-9),
     "active_sync"),
    ("sum-filter-scan",
     AggQuery(agg="sum", column="dep_delay",
              filters=(Filter("airline", "eq", 2),),
              stop=AbsoluteWidth(eps=1e6), delta=1e-9),
     "scan"),
    ("count-filter-peek",
     AggQuery(agg="count", filters=(Filter("origin", "eq", 3),),
              stop=AbsoluteWidth(eps=5e3), delta=1e-9),
     "active_peek"),
    ("avg-anderson-dkw-scan",
     AggQuery(agg="avg", column="dep_delay", bounder="anderson_dkw",
              rangetrim=False, stop=AbsoluteWidth(eps=30.0), delta=1e-9),
     "scan"),
    # eps too tight to satisfy -> exhaustion + recovery-path exactness
    ("avg-exhaust-peek",
     AggQuery(agg="avg", column="dep_delay", group_by="origin",
              stop=AbsoluteWidth(eps=1e-7), delta=1e-9),
     "active_peek"),
]


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("name,q,sampling", SINGLE_QUERIES,
                         ids=[s[0] for s in SINGLE_QUERIES])
def test_served_single_query_bitwise_equals_run(ds, name, q, sampling,
                                                loop):
    """A batch of one is indistinguishable from FastFrame.run through the
    same kind of loop: results AND scan metrics (fresh frames, so the
    caches are alike)."""
    r_run = fresh_frame(ds, **LOOPS[loop]).run(q, sampling=sampling, seed=1,
                                               start_block=0)
    r_srv = FrameServer(fresh_frame(ds, **LOOPS[loop])).run_batch(
        [q], sampling=sampling, seed=1, start_block=0)[0]
    assert_bitwise_equal(r_srv, r_run)


def test_served_single_query_matches_reference_oracle(ds):
    """Transitivity: served singleton == the per-block path (the
    engine's own oracle)."""
    q = AggQuery(agg="avg", column="dep_delay", group_by="airline",
                 filters=(Filter("dep_time", "gt", 400.0),),
                 stop=ThresholdSide(threshold=10.0), delta=1e-9)
    r_ref = fresh_frame(ds, fused=False).run(q, sampling="active_peek",
                                             seed=2, start_block=0)
    r_srv = FrameServer(fresh_frame(ds, device_loop=False)).run_batch(
        [q], sampling="active_peek", seed=2, start_block=0)[0]
    assert_bitwise_equal(r_srv, r_ref)


def exact_group_stats(ds, value_col, group_col=None, mask=None):
    v = ds.columns[value_col].astype(np.float64)
    if mask is None:
        mask = np.ones_like(v, dtype=bool)
    if group_col is None:
        return {0: v[mask].mean()}
    g = ds.columns[group_col]
    return {int(c): v[(g == c) & mask].mean()
            for c in np.unique(g[mask])}


def _fanout_queries():
    qs = []
    for i in range(8):
        stop = [AbsoluteWidth(eps=2.0 + i),
                ThresholdSide(threshold=float(5 * (i - 2))),
                TopKSeparated(k=2 + i % 3, largest=True),
                GroupsOrdered()][i % 4]
        qs.append(AggQuery(agg="avg", column="dep_delay",
                           group_by="origin", stop=stop,
                           delta=10.0 ** -(6 + i % 3)))
    return qs


@pytest.mark.parametrize("loop", list(LOOPS))
def test_shared_pass_multi_query_covers_truth(ds, loop):
    """8 queries, one scan signature (the dashboard fan-out): one shared
    pass answers all of them with covering intervals."""
    qs = _fanout_queries()
    server = FrameServer(fresh_frame(ds, **LOOPS[loop]))
    assert len(server.plan(qs)) == 1          # one pass
    res = server.run_batch(qs, sampling="active_peek", seed=5,
                           start_block=0)
    truth = exact_group_stats(ds, "dep_delay", "origin")
    for i, r in enumerate(res):
        for c, tv in truth.items():
            assert r.lo[c] - 1e-3 <= tv <= r.hi[c] + 1e-3, (i, c)
        assert r.rounds > 0 and r.blocks_fetched > 0


def _multi_slot_queries():
    filt = (Filter("day_of_week", "le", 3),)
    return [
        AggQuery(agg="avg", column="dep_delay", group_by="airline",
                 filters=filt, stop=AbsoluteWidth(eps=3.0), delta=1e-9),
        AggQuery(agg="avg", column="dep_time", group_by="origin",
                 filters=filt, stop=AbsoluteWidth(eps=30.0), delta=1e-9),
        AggQuery(agg="count", filters=filt,
                 stop=AbsoluteWidth(eps=4e3), delta=1e-9),
        AggQuery(agg="sum", column="dep_delay", filters=filt,
                 stop=AbsoluteWidth(eps=1e6), delta=1e-9),
    ]


@pytest.mark.parametrize("loop", list(LOOPS))
def test_shared_pass_multi_slot_covers_truth(ds, loop):
    """Queries with shared filters but different value/group columns run
    in one pass with per-slot folds."""
    mask = ds.columns["day_of_week"] <= 3
    qs = _multi_slot_queries()
    server = FrameServer(fresh_frame(ds, **LOOPS[loop]))
    assert len(server.plan(qs)) == 1          # shared filters: one pass
    res = server.run_batch(qs, sampling="active_peek", seed=6,
                           start_block=0)
    t_av = exact_group_stats(ds, "dep_delay", "airline", mask=mask)
    for c, tv in t_av.items():
        assert res[0].lo[c] - 1e-3 <= tv <= res[0].hi[c] + 1e-3, c
    t_dt = exact_group_stats(ds, "dep_time", "origin", mask=mask)
    for c, tv in t_dt.items():
        assert res[1].lo[c] - 1e-3 <= tv <= res[1].hi[c] + 1e-3, c
    cnt = float(mask.sum())
    assert res[2].lo[0] <= cnt <= res[2].hi[0]
    s = ds.columns["dep_delay"][mask].astype(np.float64).sum()
    tol = 1e-5 * abs(s)
    assert res[3].lo[0] - tol <= s <= res[3].hi[0] + tol


def test_mixed_filters_split_into_passes(ds):
    """Different filters cannot share a cursor walk: the planner splits
    them, results still cover."""
    qs = [
        AggQuery(agg="avg", column="dep_delay", group_by="airline",
                 stop=AbsoluteWidth(eps=3.0), delta=1e-9),
        AggQuery(agg="avg", column="dep_delay", group_by="airline",
                 filters=(Filter("origin", "eq", 3),),
                 stop=AbsoluteWidth(eps=8.0), delta=1e-9),
    ]
    server = FrameServer(fresh_frame(ds))
    assert len(server.plan(qs)) == 2
    res = server.run_batch(qs, sampling="active_peek", seed=7,
                           start_block=0)
    truth0 = exact_group_stats(ds, "dep_delay", "airline")
    for c, tv in truth0.items():
        assert res[0].lo[c] - 1e-3 <= tv <= res[0].hi[c] + 1e-3, c
    m = ds.columns["origin"] == 3
    truth1 = exact_group_stats(ds, "dep_delay", "airline", mask=m)
    for c, tv in truth1.items():
        assert res[1].lo[c] - 1e-3 <= tv <= res[1].hi[c] + 1e-3, c


def test_exact_mode_queries_delegate(ds):
    """stop=None / sampling='exact' queries bypass the shared pass and
    match a direct run exactly."""
    q = AggQuery(agg="avg", column="dep_delay", group_by="airline",
                 stop=None)
    r_run = fresh_frame(ds).run(q, sampling="exact", seed=0,
                                start_block=0)
    r_srv = FrameServer(fresh_frame(ds)).run_batch(
        [q], sampling="exact", seed=0, start_block=0)[0]
    assert_bitwise_equal(r_srv, r_run)
    assert r_srv.exact.all()


def test_materialization_cache_reused_across_batches(ds):
    """The device value/mask/gid buffers are cached on the frame, keyed
    by signature components, and reused across run_batch calls; so is
    the pass loop of a repeat batch."""
    frame = fresh_frame(ds)
    server = FrameServer(frame)
    q = AggQuery(agg="avg", column="dep_delay", group_by="origin",
                 filters=(Filter("airline", "eq", 2),),
                 stop=AbsoluteWidth(eps=5.0), delta=1e-9)
    server.run_batch([q], seed=1, start_block=0)
    vkey, gkey = q.value_key, "origin"
    mkey = tuple(f.key() for f in q.filters)
    vals = frame._dev_values[vkey]
    mask = frame._dev_masks[mkey]
    gids = frame._dev_gids[gkey]
    misses = frame.device_loops.misses
    server.run_batch([q], seed=1, start_block=0)
    assert frame._dev_values[vkey] is vals
    assert frame._dev_masks[mkey] is mask
    assert frame._dev_gids[gkey] is gids
    assert frame.device_loops.misses == misses
    # equal-by-value filters constructed separately hit the same entry
    q2 = AggQuery(agg="avg", column="dep_delay", group_by="origin",
                  filters=(Filter("airline", "eq", 2),),
                  stop=AbsoluteWidth(eps=9.0), delta=1e-9)
    server.run_batch([q2], seed=1, start_block=0)
    assert len(frame._dev_masks) == 1
    assert len(frame._dev_values) == 1


def test_materialization_cache_is_bounded(ds):
    """Ad-hoc filter values must not pin device buffers without limit:
    the caches evict LRU beyond config.mat_cache_entries."""
    frame = fresh_frame(ds, mat_cache_entries=4)
    for t in range(10):
        frame._device_mask((Filter("dep_time", "gt", float(t)),))
    assert len(frame._dev_masks) == 4
    # most-recent keys survive
    key9 = (Filter("dep_time", "gt", 9.0).key(),)
    assert key9 in frame._dev_masks


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("nblocks,g,q", [(512, 64, 1), (300, 100, 5)])
def test_active_blocks_multi_matches_per_row(nblocks, g, q, windowed):
    """(Q, W) stacked probe == Q independent single-mask probes (the
    serving path's per-query active-word stacks), over all rows and
    through a window of row ids."""
    rng = np.random.default_rng(nblocks + q)
    words = (g + 31) // 32
    bitmap = torch.from_numpy(rng.integers(0, 2**32, size=(nblocks, words),
                                           dtype=np.uint32).view(np.int32))
    stack = torch.from_numpy(rng.integers(0, 2**32, size=(q, words),
                                          dtype=np.uint32).view(np.int32))
    win = (torch.from_numpy(rng.integers(0, nblocks, 200).astype(np.int32))
           if windowed else None)
    got = ops.active_blocks_multi(bitmap, stack, win=win)
    n = nblocks if win is None else 200
    assert got.shape == (q, n) and got.dtype == torch.int32
    for qi in range(q):
        want = ops.active_blocks(bitmap, stack[qi],
                                 win=None if win is None else win.long())
        np.testing.assert_array_equal(got[qi].numpy(), want.numpy(),
                                      err_msg=str(qi))


def test_shared_pass_taint_stays_per_query_sound():
    """Activity skipping in a shared pass: blocks are skipped only when
    inactive for EVERY query, so each query's tainted views still carry
    valid frozen intervals."""
    rng = np.random.default_rng(0)
    n = 40_000
    g = (rng.random(n) < 0.02).astype(np.int32)  # rare group 1
    v = np.where(g == 1, rng.normal(50.0, 30.0, n),
                 rng.normal(100.0, 1.0, n)).astype(np.float32)
    sc = build_scramble({"g": g, "v": v}, catalog={"v": (-100.0, 250.0)},
                        block_rows=64, seed=1)
    frame = FastFrame(sc, EngineConfig(round_blocks=8, lookahead_blocks=64,
                                       sync_lookahead_blocks=16),
                      device="cpu")
    qs = [AggQuery(agg="avg", column="v", group_by="g",
                   stop=ThresholdSide(threshold=50.0), delta=1e-6),
          AggQuery(agg="avg", column="v", group_by="g",
                   stop=ThresholdSide(threshold=80.0), delta=1e-6)]
    res = FrameServer(frame).run_batch(qs, sampling="active_peek", seed=1,
                                       start_block=0)
    truth0 = v[g == 0].astype(np.float64).mean()
    truth1 = v[g == 1].astype(np.float64).mean()
    for r in res:
        assert r.lo[0] - 1e-3 <= truth0 <= r.hi[0] + 1e-3
        assert r.lo[1] - 1e-3 <= truth1 <= r.hi[1] + 1e-3


@pytest.mark.parametrize("loop", list(LOOPS))
def test_retired_result_snapshot_frozen_while_pass_continues(ds, loop):
    """A query that finishes (its slot kept) while the shared pass keeps
    scanning has its result frozen at finish time: rounds, blocks paid,
    count_seen and intervals do NOT drift with the surviving pass (the
    device loop's snapshot is a host copy, never a view of live
    state)."""
    frame = fresh_frame(ds, **LOOPS[loop], chunk_rounds=2)
    srv = FrameServer(frame)
    p = srv.open_pass([])
    fast = AggQuery(agg="avg", column="dep_delay",
                    stop=AbsoluteWidth(eps=8.0), delta=1e-9)
    slow = AggQuery(agg="avg", column="dep_delay",
                    stop=AbsoluteWidth(eps=1e-6), delta=1e-9)
    p.admit([fast, slow])      # same signature -> one shared slot
    done = []
    while p.can_step and not done:
        done = p.step()
    assert done == [fast], "fast query should stop early"
    r_at_finish = p.result_of(fast)
    frozen = {f: np.copy(getattr(r_at_finish, f)) for f in RESULT_FIELDS}
    p.retire()                 # slot survives: slow is still running
    while p.can_step:
        p.step()
    p.finish()
    r_after = p.result_of(fast)
    assert r_after is r_at_finish          # one snapshot, not recomputed
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(r_after, f), frozen[f],
                                      err_msg=f)
    r_slow = p.result_of(slow)
    assert r_slow.rounds > r_at_finish.rounds
    assert r_slow.blocks_fetched > r_at_finish.blocks_fetched


# -- the port's served results against the reference's -------------------------


def _ref_queries(Q, opt):
    """The same batch in either package (``Q``: the package's AggQuery /
    Filter, ``opt``: its optstop): a three-slot pass under one filter and
    a singleton pass with none."""
    filt = (Q[1]("day_of_week", "le", 4),)
    return [
        Q[0](agg="avg", column="dep_delay", group_by="airline",
             filters=filt, stop=opt.ThresholdSide(threshold=10.0),
             delta=1e-9),
        Q[0](agg="avg", column="dep_delay", group_by="airline",
             filters=filt, stop=opt.AbsoluteWidth(eps=1.5), delta=1e-9),
        Q[0](agg="sum", column="dep_delay", filters=filt,
             stop=opt.AbsoluteWidth(eps=2e5), delta=1e-9),
        Q[0](agg="avg", column="dep_delay", group_by="origin",
             filters=filt, bounder="anderson_dkw", rangetrim=False,
             stop=opt.AbsoluteWidth(eps=60.0), delta=1e-9),
        Q[0](agg="count", stop=opt.AbsoluteWidth(eps=3e3), delta=1e-9),
    ]


@pytest.mark.parametrize("exact_data", [True, False])
def test_served_batch_matches_reference_server(ds, exact_data):
    """The same batch through both packages' FrameServer (the host pass
    loop of each) on one scramble: decisions equal, CIs within 1e-9 on
    exact data and 1e-6 relative on f32 data."""
    cols = exact_flights_columns(ds.columns) if exact_data else ds.columns
    catalog = dict(ds.catalog)
    if exact_data:
        catalog["dep_delay"] = (0.0, 16.0)
    rsc = R.build_scramble(cols, catalog=catalog, block_rows=256, seed=4)
    r_frame = R.FastFrame(rsc, R.EngineConfig(device_loop=False, **CFG))
    t_frame = FastFrame(port_scramble(rsc),
                        EngineConfig(device_loop=False, **CFG), device="cpu")
    kw = dict(sampling="active_peek", seed=3, start_block=11)
    r_res = RFrameServer(r_frame).run_batch(
        _ref_queries((R.AggQuery, R.Filter), Ro), **kw)
    t_res = FrameServer(t_frame).run_batch(
        _ref_queries((AggQuery, Filter), To), **kw)
    for a, b in zip(t_res, r_res):
        assert_port_matches_ref(a, b, exact_data)
