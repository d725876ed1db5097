"""The port's device-resident round loop (``EngineConfig(device_loop=
True)``, the default) on the CPU, where its chunks run eagerly, against
the port's own per-round host loop (``device_loop=False``, the oracle)
and against the reference's device loop under 64-bit JAX, on one
scramble made from a seed:

  * folds, coverage, soundness flags (exact / tainted) and scan metrics
    match EXACTLY, against both;
  * against the host loop, CI endpoints / estimates agree to <= 1e-9
    (rtol 1e-12 for SUM/COUNT endpoints of row-count scale), the
    reference's device-loop contract; against the reference's device
    loop, to the port's contract on general f32 data (<= 1e-6 relative:
    its XLA fold may order a group's f32 sums otherwise, which moves a
    wide expression's mean by ~1e-11 relative);
  * chunking (``sync_every`` / ``chunk_rounds``, and the fixed chunk the
    port replays when neither is set) changes dispatch granularity only:
    every chunk size gives results identical to every other, and a stop
    inside a chunk scans no further;
  * a float32 state is refused instead of silently demoting the float64
    bound math.

The reference's two serving cases wait for the serving slice."""

import numpy as np
import pytest
import torch

import repro.aqp as R
from repro.core import optstop as Ro
from repro.data import flights

import repro_torch.aqp as T
from repro_torch.aqp import engine as Teng
from repro_torch.core import optstop as To

from tests.helpers.torch_parity import (assert_port_matches_ref,
                                        port_scramble)

EXACT_FIELDS = [
    "group_codes", "count_seen", "nonempty", "exact", "tainted",
    "rows_covered", "blocks_fetched", "blocks_skipped_active",
    "blocks_skipped_static", "bitmap_probes", "rounds", "stopped_early",
]
CI_FIELDS = ["estimate", "lo", "hi"]


@pytest.fixture(scope="module", autouse=True)
def _x64(x64_module):
    yield


def assert_loops_agree(a_res, b_res, atol=1e-9):
    for f in EXACT_FIELDS:
        a, b = getattr(a_res, f), getattr(b_res, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, (f, a, b)
    for f in CI_FIELDS:
        a, b = getattr(a_res, f), getattr(b_res, f)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                      err_msg=f)
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-12, atol=atol,
                                   err_msg=f)


def assert_bitwise_equal(a_res, b_res):
    for f in EXACT_FIELDS + CI_FIELDS:
        a, b = getattr(a_res, f), getattr(b_res, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, (f, a, b)


@pytest.fixture(scope="module")
def scs():
    ds = flights.generate(n_rows=80_000, n_airports=60, n_airlines=6,
                          seed=3)
    sc = R.build_scramble(ds.columns, catalog=ds.catalog, block_rows=256,
                          seed=4)
    return sc, port_scramble(sc)


def run_three(sc_pair, q_pair, sampling, seed=1, start=0, **cfg_kw):
    """The port's device loop, the port's host loop and the reference's
    device loop on one scramble: ``(port device, port host, ref
    device)``."""
    sc_r, sc_t = sc_pair
    q_r, q_t = q_pair
    kw = dict(sampling=sampling, seed=seed, start_block=start)
    r_d = T.FastFrame(sc_t, T.EngineConfig(device_loop=True, **cfg_kw),
                      device="cpu").run(q_t, **kw)
    r_h = T.FastFrame(sc_t, T.EngineConfig(device_loop=False, **cfg_kw),
                      device="cpu").run(q_t, **kw)
    r_ref = R.FastFrame(sc_r, R.EngineConfig(device_loop=True,
                                             **cfg_kw)).run(q_r, **kw)
    return r_d, r_h, r_ref


def _scenarios(m, opt):
    """name -> (query, sampling) of package ``m`` (``R`` or ``T``)."""
    expr = m.Expression(fn=lambda c: (c["dep_delay"] / 60.0) ** 2,
                        columns=("dep_delay",), convex=True)
    return {
        "avg-group-topk-peek": (m.AggQuery(
            agg="avg", column="dep_delay", group_by="origin",
            stop=opt.TopKSeparated(k=2, largest=True), delta=1e-9),
            "active_peek"),
        "avg-group-bottomk-peek": (m.AggQuery(
            agg="avg", column="dep_delay", group_by="origin",
            stop=opt.TopKSeparated(k=3, largest=False), delta=1e-9),
            "active_peek"),
        "avg-group-thresh-sync": (m.AggQuery(
            agg="avg", column="dep_delay", group_by="origin",
            stop=opt.ThresholdSide(threshold=0.0), delta=1e-9),
            "active_sync"),
        "avg-group-relwidth-peek": (m.AggQuery(
            agg="avg", column="dep_delay", group_by="airline",
            stop=opt.RelativeWidth(eps=0.5), delta=1e-6), "active_peek"),
        "avg-group-fixedsamples-scan": (m.AggQuery(
            agg="avg", column="dep_delay", group_by="airline",
            stop=opt.FixedSamples(m=4000), delta=1e-9), "scan"),
        "sum-filter-scan": (m.AggQuery(
            agg="sum", column="dep_delay",
            filters=(m.Filter("airline", "eq", 2),),
            stop=opt.AbsoluteWidth(eps=1e6), delta=1e-9), "scan"),
        "count-filter-peek": (m.AggQuery(
            agg="count", filters=(m.Filter("origin", "eq", 3),),
            stop=opt.AbsoluteWidth(eps=5e3), delta=1e-9), "active_peek"),
        "avg-anderson-dkw-scan": (m.AggQuery(
            agg="avg", column="dep_delay", bounder="anderson_dkw",
            rangetrim=False, stop=opt.AbsoluteWidth(eps=30.0),
            delta=1e-9), "scan"),
        "avg-hoeffding-serfling-rt-peek": (m.AggQuery(
            agg="avg", column="dep_delay", group_by="airline",
            bounder="hoeffding_serfling", rangetrim=True,
            stop=opt.AbsoluteWidth(eps=15.0), delta=1e-9), "active_peek"),
        "expr-composite-ordered-peek": (m.AggQuery(
            agg="avg", column=expr, group_by=("airline", "day_of_week"),
            stop=opt.GroupsOrdered(), delta=1e-6), "active_peek"),
        # eps too tight to ever satisfy -> full-sweep exhaustion
        "avg-exhaust-peek": (m.AggQuery(
            agg="avg", column="dep_delay", group_by="origin",
            stop=opt.AbsoluteWidth(eps=1e-7), delta=1e-9), "active_peek"),
    }


SCEN = {"R": _scenarios(R, Ro), "T": _scenarios(T, To)}


@pytest.mark.parametrize("name", list(SCEN["T"]))
def test_device_loop_matches_host_loop(scs, name):
    (q_r, sampling), (q_t, _) = SCEN["R"][name], SCEN["T"][name]
    r_d, r_h, r_ref = run_three(scs, (q_r, q_t), sampling, seed=1, start=0,
                                round_blocks=16, lookahead_blocks=64,
                                sync_lookahead_blocks=16, hist_bins=256)
    assert_loops_agree(r_d, r_h)
    if name.startswith("expr"):
        # the expression's a-priori range comes from each package's box
        # minimiser (core/derived_bounds.py), which agree to ~1.5e-8 here;
        # the trivial intervals of views still at that range carry it
        assert_loops_agree(r_d, r_ref, atol=1e-7)
    else:
        assert_port_matches_ref(r_d, r_ref, exact_data=False)
    if name == "avg-exhaust-peek":
        assert r_d.exact.all()


def _randomized_query(m, opt):
    return m.AggQuery(agg="avg", column="dep_delay", group_by="airline",
                      filters=(m.Filter("dep_time", "gt", 400.0),),
                      stop=opt.ThresholdSide(threshold=10.0), delta=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_loop_randomized_starts(scs, seed):
    """Random scan starts (wrap-around windows) and unknown-N filters."""
    r_d, r_h, r_ref = run_three(
        scs, (_randomized_query(R, Ro), _randomized_query(T, To)),
        "active_peek", seed=seed, start=None, round_blocks=8,
        lookahead_blocks=64)
    assert_loops_agree(r_d, r_h)
    assert_port_matches_ref(r_d, r_ref, exact_data=False)


def _taint_scramble():
    rng = np.random.default_rng(0)
    n = 40_000
    g = (rng.random(n) < 0.02).astype(np.int32)  # rare group 1
    v = np.where(g == 1, rng.normal(50.0, 30.0, n),
                 rng.normal(100.0, 1.0, n)).astype(np.float32)
    sc = R.build_scramble({"g": g, "v": v}, catalog={"v": (-100.0, 250.0)},
                          block_rows=64, seed=1)
    return sc, port_scramble(sc)


@pytest.mark.parametrize("sampling", ["active_peek", "active_sync"])
def test_device_loop_taint_propagates_out_of_the_loop(sampling):
    """Taint accrued in the device carry surfaces identically to the host
    loop's accounting (and the recovery pass sees it)."""
    qs = tuple(m.AggQuery(agg="avg", column="v", group_by="g",
                          stop=opt.ThresholdSide(threshold=50.0),
                          delta=1e-6) for m, opt in ((R, Ro), (T, To)))
    r_d, r_h, r_ref = run_three(_taint_scramble(), qs, sampling, seed=1,
                                start=0, round_blocks=8,
                                lookahead_blocks=64,
                                sync_lookahead_blocks=16)
    assert_loops_agree(r_d, r_h)
    assert_port_matches_ref(r_d, r_ref, exact_data=False)
    assert r_d.blocks_skipped_active > 0
    assert r_d.tainted[0] and not r_d.tainted[1]


def test_on_sync_streams_snapshots(scs):
    """sync_every chunks the loop and surfaces a monotone stream of
    interval snapshots, as the reference's does."""
    q = SCEN["T"]["avg-group-thresh-sync"][0]
    snaps = []
    T.FastFrame(scs[1], T.EngineConfig(device_loop=True, sync_every=2,
                                       round_blocks=16,
                                       lookahead_blocks=64),
                device="cpu").run(q, seed=1, start_block=0,
                                  on_sync=snaps.append)
    assert len(snaps) >= 2
    rounds = [s["rounds"] for s in snaps]
    assert rounds == sorted(rounds)
    assert all(r2 - r1 <= 2 for r1, r2 in zip(rounds, rounds[1:]))
    assert snaps[-1]["live"] is False
    for s1, s2 in zip(snaps, snaps[1:]):
        assert (s2["lo"] >= s1["lo"] - 1e-12).all()
        assert (s2["hi"] <= s1["hi"] + 1e-12).all()


def test_device_loop_float64_guard(scs):
    """A loop carry whose state is float32 is refused with the guard's
    message (torch keeps f32 * f64-scalar in float32: a silent demotion
    that would invalidate the guarantees); the default resolves to the
    device loop, since torch always has float64."""
    sc = scs[1]
    q = T.AggQuery(agg="avg", column="dep_delay", group_by="airline",
                   stop=To.AbsoluteWidth(eps=20.0), delta=1e-6)
    frame = T.FastFrame(sc, T.EngineConfig(round_blocks=16,
                                           lookahead_blocks=64),
                        device="cpu")
    slot = Teng._ScanViews(frame, q)
    qci = Teng._QueryIntervals(frame, q, slot)
    dl = Teng._DeviceLoop(frame, q, slot, qci, probe=True, lookahead=64,
                          max_rounds=100)
    order = np.arange(sc.n_blocks)
    dl.set_order(order, np.cumsum(frame._valid_counts[order]))
    carry = dl.init_carry(slot, qci)
    f32 = carry._replace(state=type(carry.state)(
        *(f.to(torch.float32) for f in carry.state)))
    with pytest.raises(RuntimeError, match="float64") as ei:
        dl.run(f32)
    assert "float32" in str(ei.value) and "device_loop=False" in str(ei.value)
    assert T.EngineConfig(device_loop=None).resolve_device_loop() is True
    assert T.EngineConfig(device_loop=False).resolve_device_loop() is False
    r = frame.run(q, seed=0, start_block=0)  # the default: device loop
    assert r.rounds >= 1 and len(frame.device_loops) == 1


def test_device_loop_requires_fused():
    with pytest.raises(ValueError, match="fused"):
        T.EngineConfig(device_loop=True, fused=False).resolve_device_loop()
    assert T.EngineConfig(fused=False).resolve_device_loop() is False
    with pytest.raises(ValueError, match="chunk_rounds"):
        T.EngineConfig(chunk_rounds=0)


def _run_device(sc, q, **cfg_kw):
    return T.FastFrame(sc, T.EngineConfig(device_loop=True, round_blocks=16,
                                          lookahead_blocks=64, **cfg_kw),
                       device="cpu").run(q, sampling="active_peek", seed=1,
                                         start_block=0)


def test_device_chunking_is_result_invariant(scs):
    """``sync_every`` / ``chunk_rounds`` change dispatch granularity
    only: any chunk size gives results identical to the default chunk
    (:data:`GRAPH_CHUNK_ROUNDS`) — including a chunk boundary exactly on,
    just before and just after the stopping round."""
    q = SCEN["T"]["count-filter-peek"][0]
    base = _run_device(scs[1], q)
    assert base.stopped_early  # the boundary cases below are meaningful
    assert base.rounds < Teng.GRAPH_CHUNK_ROUNDS
    for cfg_kw in (dict(sync_every=1), dict(sync_every=3),
                   dict(sync_every=base.rounds),
                   dict(sync_every=base.rounds - 1),
                   dict(sync_every=base.rounds + 1),
                   dict(chunk_rounds=2),
                   dict(sync_every=2, chunk_rounds=1000)):
        got = _run_device(scs[1], q, **cfg_kw)
        assert_bitwise_equal(got, base)


def test_device_early_stop_inside_chunk_no_overscan(scs):
    """A stop firing mid-chunk ends the scan at that round: the rounds
    after it run on nothing, so the coverage accounting (rows_covered /
    blocks_fetched / rounds / probes) equals the host loop's, which
    checks the stop test every round. The chunk (2,000 rounds, eagerly
    on the CPU) is far larger than the stopping round."""
    q = SCEN["T"]["count-filter-peek"][0]
    r_host = T.FastFrame(scs[1], T.EngineConfig(device_loop=False,
                                                round_blocks=16,
                                                lookahead_blocks=64),
                         device="cpu").run(q, sampling="active_peek",
                                           seed=1, start_block=0)
    r_dev = _run_device(scs[1], q, sync_every=2000)
    assert r_dev.stopped_early and r_host.stopped_early
    assert r_dev.rounds == r_host.rounds
    assert r_dev.rows_covered == r_host.rows_covered
    assert r_dev.blocks_fetched == r_host.blocks_fetched
    assert r_dev.bitmap_probes == r_host.bitmap_probes


def test_device_loop_is_cached_and_reused(scs):
    """A repeat query reuses the frame's cached loop (on the card, its
    captured graph) and gives the same result from another start."""
    q = SCEN["T"]["avg-group-thresh-sync"][0]
    frame = T.FastFrame(scs[1], T.EngineConfig(round_blocks=16,
                                               lookahead_blocks=64),
                        device="cpu")
    first = frame.run(q, sampling="active_sync", seed=1, start_block=5)
    (key,) = frame.device_loops.keys()
    loop = frame.device_loops[key]
    chunks = loop.chunks
    again = frame.run(q, sampling="active_sync", seed=1, start_block=5)
    other = frame.run(q, sampling="active_sync", seed=1, start_block=40)
    assert frame.device_loops[key] is loop and loop.chunks > chunks
    assert_bitwise_equal(again, first)
    r_h = T.FastFrame(scs[1], T.EngineConfig(device_loop=False,
                                             round_blocks=16,
                                             lookahead_blocks=64),
                      device="cpu").run(q, sampling="active_sync", seed=1,
                                        start_block=40)
    assert_loops_agree(other, r_h)
