"""The port's sharded-vs-oracle scenarios: the mirror of
``tests/helpers/sharded_scenarios.py`` on ``torch.distributed`` ranks.

Each scenario runs on every rank of an initialized default group (gloo
on the CPU in the tests: ``tests/helpers/torch_dist_worker.py``), builds
the same scramble from the same seed, runs the query divided over the
ranks (``EngineConfig(shard_rows=True)``) and on the single-device
device loop (``shard_rows=False``), and holds the two to the reference's
contract on every rank:

  * scan decisions, coverage, taint, fold counts and every scan metric
    EXACTLY (selection and accounting are replicated computations);
  * CI endpoints and estimates bit for bit where each rank's float32
    partial sums are exact (``scenario_exhaustion_bitwise``,
    ``scenario_early_stop_bitwise``, the carousel lap), else within
    ``CI_RTOL`` relative (+ ``CI_ATOL``): the merge reorders the float32
    row sum;
  * the collective cadence (``merge_every > 1``) against the sharded
    per-round merge under the reference's cadence contracts
    (``CADENCE_TOL``: f64 association order on exact data).

Imports nothing of JAX or the JAX package. ``DEVICE`` is where the
frames run (the CPU in the tests).
"""

import numpy as np

from repro_torch.aqp import (AggQuery, EngineConfig, FastFrame, Filter,
                             build_scramble)
from repro_torch.aqp.distributed import world
from repro_torch.core.optstop import (AbsoluteWidth, ThresholdSide,
                                      TopKSeparated)
from repro_torch.data import flights
from repro_torch.serve import FrameServer

DEVICE = "cpu"

EXACT_FIELDS = [
    "group_codes", "count_seen", "nonempty", "exact", "tainted",
    "rows_covered", "blocks_fetched", "blocks_skipped_active",
    "blocks_skipped_static", "bitmap_probes", "rounds", "stopped_early",
]
CI_FIELDS = ["estimate", "lo", "hi"]
CI_RTOL = 1e-3     # f32-reorder noise bound on general data (reference's)
CI_ATOL = 1e-6
CADENCE_TOL = 1e-5   # f64 association-order bound on exact-integer data

CFG = dict(device_loop=True, round_blocks=16, lookahead_blocks=64,
           sync_lookahead_blocks=16, hist_bins=256)


def frame(sc, **cfg) -> FastFrame:
    return FastFrame(sc, EngineConfig(**cfg), device=DEVICE)


def assert_sharded_matches_oracle(r_sh, r_or, bitwise_ci=False):
    """Exact fields equal; CI endpoints bitwise (``bitwise_ci``, for
    exactly-representable data) or within the f32-reorder bound."""
    for f in EXACT_FIELDS:
        a, b = getattr(r_sh, f), getattr(r_or, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, (f, a, b)
    for f in CI_FIELDS:
        a, b = getattr(r_sh, f), getattr(r_or, f)
        if bitwise_ci:
            np.testing.assert_array_equal(a, b, err_msg=f)
            continue
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                      err_msg=f)
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=CI_RTOL,
                                   atol=CI_ATOL, err_msg=f)


def run_pair(sc, q, sampling="active_peek", mesh_shape=None, seed=1,
             start=0, **over):
    """Run one query sharded (``shard_rows=True``) and on the
    single-device oracle (``shard_rows=False``), fresh frames each."""
    kw = dict(CFG)
    kw.update(over)
    r_sh = frame(sc, shard_rows=True, mesh_shape=mesh_shape, **kw).run(
        q, sampling=sampling, seed=seed, start_block=start)
    r_or = frame(sc, shard_rows=False, **kw).run(
        q, sampling=sampling, seed=seed, start_block=start)
    return r_sh, r_or


def flights_scramble(n_rows=60_000, block_rows=256):
    ds = flights.generate(n_rows=n_rows, n_airports=30, n_airlines=5,
                          seed=3)
    return build_scramble(ds.columns, catalog=ds.catalog,
                          block_rows=block_rows, seed=4)


def integer_scramble(n=50_000, groups=8):
    """Exactly-representable data: small-integer values, cyclic groups —
    every rank's f32 partial sum is an exact integer, so the merge
    computes the same real numbers as the single-device fold."""
    g = (np.arange(n) % groups).astype(np.int32)
    v = (((np.arange(n) * 7) // 5 + g) % 5).astype(np.float32)
    return build_scramble({"g": g, "v": v}, catalog={"v": (0.0, 4.0)},
                          block_rows=256, seed=1)


# the queries the reference's own sharded loop also runs (``tests/
# helpers/dist_ref_sharded.py``), shared by the scenario and that check
def topk_query():
    return AggQuery(agg="avg", column="dep_delay", group_by="origin",
                    stop=TopKSeparated(k=2, largest=True), delta=1e-9)


def exhaustion_query():
    return AggQuery(agg="avg", column="v", group_by="g",
                    stop=AbsoluteWidth(eps=1e-9), delta=1e-9)  # never fires


def airline_width_query(eps):
    return AggQuery(agg="avg", column="dep_delay", group_by="airline",
                    stop=AbsoluteWidth(eps=eps), delta=1e-6)


def origin_threshold_query(t):
    return AggQuery(agg="avg", column="dep_delay", group_by="origin",
                    stop=ThresholdSide(threshold=t), delta=1e-6)


def scenario_groupby_topk():
    """GROUP BY + TopK early stop: activity skipping + probe metrics."""
    assert_sharded_matches_oracle(*run_pair(flights_scramble(),
                                            topk_query()))


def scenario_groupby_threshold_2d_mesh():
    """Explicit 2-D mesh_shape (it only orders the ranks). Needs >= 4
    ranks."""
    n = world()[0]
    assert n >= 4, f"needs >= 4 ranks, have {n}"
    q = AggQuery(agg="avg", column="dep_delay", group_by="origin",
                 stop=ThresholdSide(threshold=0.0), delta=1e-9)
    assert_sharded_matches_oracle(*run_pair(flights_scramble(), q,
                                            mesh_shape=(2, n // 2)))


def scenario_filtered_sum():
    """Unknown-N SUM with a filter (static prefilter + N+ bound math)."""
    q = AggQuery(agg="sum", column="dep_delay",
                 filters=(Filter("airline", "eq", 2),),
                 stop=AbsoluteWidth(eps=1e6), delta=1e-9)
    assert_sharded_matches_oracle(*run_pair(flights_scramble(), q,
                                            sampling="scan"))


def scenario_taint():
    """Taint accrued in the sharded loop's carry surfaces identically
    (the rare group goes inactive, its blocks activity-skip)."""
    rng = np.random.default_rng(0)
    n = 40_000
    g = (rng.random(n) < 0.02).astype(np.int32)
    v = np.where(g == 1, rng.normal(50.0, 30.0, n),
                 rng.normal(100.0, 1.0, n)).astype(np.float32)
    sc = build_scramble({"g": g, "v": v}, catalog={"v": (-100.0, 250.0)},
                        block_rows=64, seed=1)
    q = AggQuery(agg="avg", column="v", group_by="g",
                 stop=ThresholdSide(threshold=50.0), delta=1e-6)
    r_sh, r_or = run_pair(sc, q, round_blocks=8)
    assert_sharded_matches_oracle(r_sh, r_or)
    assert r_sh.blocks_skipped_active > 0
    assert r_sh.tainted[0] and not r_sh.tainted[1]


def scenario_exhaustion_bitwise():
    """Scan exhaustion on exactly-representable data: the whole result,
    intervals included, BITWISE the oracle's."""
    r_sh, r_or = run_pair(integer_scramble(), exhaustion_query())
    assert_sharded_matches_oracle(r_sh, r_or, bitwise_ci=True)
    assert r_sh.exact.all()


def scenario_early_stop_bitwise():
    """Early stop on exactly-representable data: bitwise, and the stop
    decision itself (rounds / stopped_early) identical."""
    q = AggQuery(agg="avg", column="v", group_by="g",
                 stop=ThresholdSide(threshold=2.0), delta=1e-6)
    assert_sharded_matches_oracle(*run_pair(integer_scramble(), q),
                                  bitwise_ci=True)


def scenario_uneven_tail():
    """A block count no rank count divides, and rows a block no rank
    count divides evenly either: the last slices are zero-padded; no
    row may be dropped or double-counted (counts are exact)."""
    n_dev = world()[0]
    sc = flights_scramble(n_rows=61 * 128, block_rows=128)
    assert sc.n_blocks % n_dev != 0, (sc.n_blocks, n_dev)
    q = AggQuery(agg="avg", column="dep_delay", group_by="airline",
                 stop=AbsoluteWidth(eps=1e-9), delta=1e-9)  # exhaustion
    r_sh, r_or = run_pair(sc, q, round_blocks=8)
    assert_sharded_matches_oracle(r_sh, r_or)
    assert r_sh.exact.all()


def scenario_server_pass():
    """A mixed FrameServer batch through the sharded pass loop (per-slot
    cursors, the slots' folds merged across ranks once a round,
    finish-time snapshots)."""
    sc = flights_scramble()
    queries = [
        AggQuery(agg="avg", column="dep_delay", group_by="origin",
                 stop=TopKSeparated(k=2), delta=1e-9),
        AggQuery(agg="avg", column="dep_delay", group_by="origin",
                 stop=ThresholdSide(threshold=0.0), delta=1e-6),
        AggQuery(agg="sum", column="dep_delay", group_by="airline",
                 stop=AbsoluteWidth(eps=1e6), delta=1e-9),
        AggQuery(agg="count", group_by="airline",
                 stop=AbsoluteWidth(eps=5e3), delta=1e-9),
        AggQuery(agg="avg", column="dep_delay", bounder="anderson_dkw",
                 rangetrim=False, stop=AbsoluteWidth(eps=30.0),
                 delta=1e-9),
    ]
    res_sh = FrameServer(frame(sc, shard_rows=True, **CFG)).run_batch(
        queries, start_block=0, seed=1)
    res_or = FrameServer(frame(sc, shard_rows=False, **CFG)).run_batch(
        queries, start_block=0, seed=1)
    for r_sh, r_or in zip(res_sh, res_or):
        assert_sharded_matches_oracle(r_sh, r_or)


def scenario_carousel_sharded_lap():
    """Carousel lap on a sharded merge_every=1 pass: a query admitted
    mid-scan advances its own slot cursor through the divided scan,
    wraps past the last block, and its full lap is BITWISE a
    single-device solo run rotated to its admission anchor, intervals
    included (exact data), the probe slot included."""
    sc = integer_scramble()          # nb = 196 at block_rows=256
    nb = sc.n_blocks
    p = FrameServer(frame(sc, shard_rows=True, **CFG)).open_pass(
        (), seed=1, start_block=0, chunk_rounds=2)
    q0 = AggQuery(agg="avg", column="v", group_by="g",
                  stop=AbsoluteWidth(eps=1e-9), delta=1e-9)  # probe slot
    q1 = AggQuery(agg="sum", column="v",
                  stop=AbsoluteWidth(eps=1e-9), delta=1e-9)
    p.admit([q0])
    for _ in range(2):                # 2 chunks x 2 rounds
        p.step()
    (qc1,) = p.admit([q1])            # late joiner, mid-scan
    assert qc1.slot.anchor > 0 and p.wrap, (qc1.slot.anchor, p.wrap)
    p.run_to_completion()
    assert p.checkpoint().layout == (world()[0], p.shards.shard_rows, 1)
    p.finish()
    r0 = p.result_of(q0)
    r1 = p.result_of(q1)
    assert_sharded_matches_oracle(
        r0, frame(sc, shard_rows=False, **CFG).run(q0, seed=1,
                                                   start_block=0),
        bitwise_ci=True)
    assert_sharded_matches_oracle(
        r1, frame(sc, shard_rows=False, **CFG).run(
            q1, seed=1, start_block=qc1.slot.anchor % nb),
        bitwise_ci=True)
    assert r0.exact.all() and r1.exact.all()


# -- collective cadence (merge_every > 1): see sharded_scenarios.py -----------


def run_cadence_pair(sc, q, merge_every=4, sampling="scan", seed=1,
                     start=0, on_sync=None, **over):
    """Run one query sharded at ``merge_every=K`` and at the per-round
    oracle ``merge_every=1`` (both ``shard_rows=True``), fresh frames."""
    kw = dict(CFG)
    kw.update(over)
    snaps_k, snaps_1 = [], []
    r_k = frame(sc, shard_rows=True, merge_every=merge_every, **kw).run(
        q, sampling=sampling, seed=seed, start_block=start,
        on_sync=snaps_k.append if on_sync else None)
    r_1 = frame(sc, shard_rows=True, merge_every=1, **kw).run(
        q, sampling=sampling, seed=seed, start_block=start,
        on_sync=snaps_1.append if on_sync else None)
    if on_sync:
        return (r_k, snaps_k), (r_1, snaps_1)
    return r_k, r_1


def scenario_cadence_superset_sync():
    """Staleness soundness at every host sync: the cadence CI is a
    superset-or-equal of the oracle CI on the same scanned prefix
    (within ``CADENCE_TOL`` on exact-integer data)."""
    (r_k, snaps_k), (r_1, snaps_1) = run_cadence_pair(
        integer_scramble(), exhaustion_query(), merge_every=4,
        sync_every=3, on_sync=True)
    assert len(snaps_k) == len(snaps_1) > 1
    for a, b in zip(snaps_k, snaps_1):
        assert a["rounds"] == b["rounds"]
        fin = np.isfinite(b["lo"]) & np.isfinite(b["hi"])
        np.testing.assert_array_equal(np.isfinite(a["lo"]), fin)
        tol = CADENCE_TOL * np.maximum(1.0, np.abs(b["est"][fin]))
        assert (a["lo"][fin] <= b["lo"][fin] + tol).all(), \
            ("cadence lo tighter than oracle",
             (a["lo"][fin] - b["lo"][fin]).max())
        assert (a["hi"][fin] >= b["hi"][fin] - tol).all(), \
            ("cadence hi tighter than oracle",
             (b["hi"][fin] - a["hi"][fin]).max())
    np.testing.assert_array_equal(r_k.count_seen, r_1.count_seen)
    assert r_k.rounds == r_1.rounds and r_k.exact.all()


def scenario_cadence_merge_confirm():
    """A query never terminates on unmerged stats: within every block the
    rows of rank d's slice are 49 (even d) or 51 (odd d), so each rank's
    local view is one-sided while every block's mean is exactly the
    threshold 50; the scan must run to exhaustion on both paths."""
    n_dev = world()[0]
    assert n_dev >= 2 and n_dev % 2 == 0, n_dev
    nb, block_rows = 16, 128
    assert block_rows % n_dev == 0, (block_rows, n_dev)
    slice_rows = block_rows // n_dev
    n = nb * block_rows
    g = np.zeros(n, np.int32)
    owner = (np.arange(n) % block_rows) // slice_rows
    v = np.where(owner % 2 == 0, np.float32(49.0), np.float32(51.0))
    sc = build_scramble({"g": g, "v": v}, catalog={"v": (49.0, 51.0)},
                        block_rows=block_rows, seed=1)
    sc.columns["v"][:] = v.reshape(sc.columns["v"].shape)
    q = AggQuery(agg="avg", column="v", group_by="g",
                 stop=ThresholdSide(threshold=50.0), delta=1e-6)
    r_k, r_1 = run_cadence_pair(sc, q, merge_every=4, round_blocks=2)
    for r in (r_k, r_1):
        assert not r.stopped_early, r.rounds
        assert r.exact.all()
        np.testing.assert_array_equal(r.estimate, np.float64(50.0))
    assert r_k.rounds == r_1.rounds == nb // 2
    np.testing.assert_array_equal(r_k.count_seen, r_1.count_seen)


def scenario_cadence_exhaustion():
    """Full-scan cadence run on general data: every scan metric exact vs
    the merge_every=1 oracle, CIs within the f32-reorder class."""
    q = AggQuery(agg="avg", column="dep_delay", group_by="origin",
                 stop=AbsoluteWidth(eps=1e-9), delta=1e-9)  # never fires
    r_k, r_1 = run_cadence_pair(flights_scramble(), q, merge_every=4)
    assert_sharded_matches_oracle(r_k, r_1)
    assert r_k.exact.all()


def scenario_cadence_early_stop():
    """Early stop under cadence: termination waits for a merge, so the
    cadence path may scan extra rounds but never fewer, and the final
    (merged) answer matches the oracle's."""
    r_k, r_1 = run_cadence_pair(flights_scramble(), topk_query(),
                                merge_every=4)
    assert r_k.rounds >= r_1.rounds, (r_k.rounds, r_1.rounds)
    assert r_k.stopped_early == r_1.stopped_early
    np.testing.assert_array_equal(r_k.group_codes, r_1.group_codes)
    fin = np.isfinite(r_1.estimate)
    np.testing.assert_allclose(r_k.estimate[fin], r_1.estimate[fin],
                               rtol=CI_RTOL, atol=CI_ATOL)


def scenario_cadence_server_pass():
    """FrameServer batch through the cadence pass loop (replicated
    pend_rounds, per-slot pending folds, the flush before each chunk
    returns); exhaustion queries keep every slot's schedule the
    merge_every=1 oracle's."""
    sc = flights_scramble()
    queries = [
        AggQuery(agg="avg", column="dep_delay", group_by="origin",
                 stop=AbsoluteWidth(eps=1e-9), delta=1e-9),
        AggQuery(agg="sum", column="dep_delay",
                 filters=(Filter("airline", "eq", 2),),
                 stop=AbsoluteWidth(eps=1e-9), delta=1e-9),
        AggQuery(agg="count", group_by="airline",
                 stop=AbsoluteWidth(eps=1e-9), delta=1e-9),
        AggQuery(agg="avg", column="dep_delay", bounder="anderson_dkw",
                 rangetrim=False, stop=AbsoluteWidth(eps=1e-9),
                 delta=1e-9),
    ]
    res = []
    for k in (4, 1):
        res.append(FrameServer(frame(sc, shard_rows=True, merge_every=k,
                                     **CFG)).run_batch(
            queries, start_block=0, seed=1))
    for r_k, r_1 in zip(*res):
        assert_sharded_matches_oracle(r_k, r_1)


# the reference's 13 scenarios of tests/test_sharded_scan.py, in its order
ALL = [
    scenario_groupby_topk, scenario_filtered_sum, scenario_taint,
    scenario_exhaustion_bitwise, scenario_early_stop_bitwise,
    scenario_uneven_tail, scenario_server_pass,
    scenario_carousel_sharded_lap,
    scenario_cadence_superset_sync, scenario_cadence_merge_confirm,
    scenario_cadence_exhaustion, scenario_cadence_early_stop,
    scenario_cadence_server_pass,
]
