"""Hypothesis properties of the port's serving (the mirror of
``tests/test_serve_property.py``, at a bounded number of examples so it
runs with the tier-1 suite): a random batch through
``FrameServer.run_batch`` is bitwise identical to sequential
``FastFrame.run`` calls — across random filters, aggregates, group-bys,
bounders, stopping conditions and ``device_loop`` on/off — where every
query carries a distinct filter set (singleton passes, the regime where
the server guarantees bitwise identity); and shared-signature non-probe
queries joining an in-flight pass mid-scan and retiring early, under any
drawn admission / retirement schedule, stay bitwise identical to solo
runs rotated to their admission anchor.

The module runs torch on one thread (``one_torch_thread``): the eager
loops are thousands of small ops, which intra-op threads slow under
xdist.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.data import flights

from repro_torch.aqp import (AggQuery, EngineConfig, FastFrame, Filter,
                             build_scramble)
from repro_torch.core.optstop import (AbsoluteWidth, ThresholdSide,
                                      TopKSeparated)
from repro_torch.serve import FrameServer

from tests.helpers.torch_parity import one_torch_thread  # noqa: F401
from tests.test_torch_serve import assert_bitwise_equal

CFG = dict(round_blocks=16, lookahead_blocks=64, hist_bins=128)


@pytest.fixture(scope="module")
def sc():
    ds = flights.generate(n_rows=40_000, n_airports=12, n_airlines=4,
                          seed=3)
    return build_scramble(ds.columns, catalog=ds.catalog, block_rows=256,
                          seed=4)


def _query(agg, group_by, bounder, rangetrim, stop_kind, days):
    filters = (Filter("day_of_week", "isin", tuple(sorted(days))),)
    if stop_kind == "topk" and group_by is not None:
        stop = TopKSeparated(k=2, largest=True)
    elif stop_kind == "threshold" and agg == "avg":
        stop = ThresholdSide(threshold=10.0)
    else:
        eps = {"avg": 20.0, "count": 5e3, "sum": 1e6}[agg]
        stop = AbsoluteWidth(eps=eps)
    return AggQuery(
        agg=agg, column=None if agg == "count" else "dep_delay",
        filters=filters, group_by=group_by, stop=stop,
        bounder=bounder, rangetrim=rangetrim, delta=1e-9)


_aggs = st.sampled_from(["avg", "sum", "count"])
_groups = st.sampled_from([None, "airline", "origin"])
_bounders = st.sampled_from([("bernstein", True), ("bernstein", False),
                             ("hoeffding_serfling", True),
                             ("anderson_dkw", False)])
_stops = st.sampled_from(["width", "threshold", "topk"])
_qspec = st.tuples(_aggs, _groups, _bounders, _stops)


def _frame(sc, device_loop):
    return FastFrame(sc, EngineConfig(**dict(CFG, device_loop=device_loop)),
                     device="cpu")


@settings(max_examples=12, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data(), device_loop=st.booleans())
def test_run_batch_bitwise_equals_sequential_runs(sc, data, device_loop):
    n = data.draw(st.integers(min_value=2, max_value=4), label="n_queries")
    # distinct filter day-sets -> distinct filter keys -> singleton passes
    day_sets = data.draw(
        st.lists(st.frozensets(st.integers(0, 6), min_size=1, max_size=7),
                 min_size=n, max_size=n, unique=True),
        label="day_sets")
    specs = data.draw(st.lists(_qspec, min_size=n, max_size=n),
                      label="specs")
    queries = [
        _query(agg, group_by, bounder, rangetrim, stop_kind, days)
        for (agg, group_by, (bounder, rangetrim), stop_kind), days
        in zip(specs, day_sets)]

    server = FrameServer(_frame(sc, device_loop))
    res_batch = server.run_batch(queries, seed=1, start_block=0)
    seq_frame = _frame(sc, device_loop)
    for q, r_batch in zip(queries, res_batch):
        r_seq = seq_frame.run(q, seed=1, start_block=0)
        assert_bitwise_equal(r_batch, r_seq)


@settings(max_examples=10, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data(), device_loop=st.booleans())
def test_shared_pass_any_admission_retirement_schedule_bitwise(
        sc, data, device_loop):
    """Carousel property: for ANY admission / retirement schedule over
    shared-signature non-probe queries (mid-scan joins at drawn round
    boundaries, retirement at drawn boundaries, early stops and
    full-lap exhaustion mixed), each query's final ``QueryResult`` is
    bitwise identical to its solo ``engine.run`` started at the slot's
    admission anchor."""
    days = data.draw(
        st.frozensets(st.integers(0, 6), min_size=2, max_size=7),
        label="days")
    filters = (Filter("day_of_week", "isin", tuple(sorted(days))),)
    n = data.draw(st.integers(min_value=2, max_value=4), label="n_queries")
    specs = []
    for i in range(n):
        agg = data.draw(_aggs, label=f"agg{i}")
        scale = data.draw(st.sampled_from([0.05, 1.0, 10.0]),
                          label=f"eps_scale{i}")
        eps = {"avg": 20.0, "count": 5e3, "sum": 1e6}[agg] * scale
        delay = data.draw(st.integers(min_value=0, max_value=6),
                          label=f"join_delay{i}")
        q = AggQuery(agg=agg,
                     column=None if agg == "count" else "dep_delay",
                     filters=filters, stop=AbsoluteWidth(eps=eps),
                     delta=1e-9)
        specs.append((q, delay))

    frame = _frame(sc, device_loop)
    seq_frame = _frame(sc, device_loop)
    # the static prefilter's probes are paid once a frame and cached:
    # warm both frames so bitmap_probes compares the dynamic probing
    frame._static_ok(specs[0][0])
    seq_frame._static_ok(specs[0][0])
    chunk = data.draw(st.integers(1, 4), label="chunk") \
        if device_loop else None
    p = FrameServer(frame).open_pass(filters, seed=1, start_block=0,
                                     chunk_rounds=chunk)
    order = sorted(range(n), key=lambda i: (specs[i][1], i))
    anchors = {}
    idx, steps = 0, 0
    while idx < n or p.can_step:
        while idx < n and (specs[order[idx]][1] <= steps
                           or not p.can_step):
            i = order[idx]
            (qc,) = p.admit([specs[i][0]])
            anchors[i] = qc.slot.anchor
            idx += 1
        if data.draw(st.booleans(), label="retire_here"):
            p.retire()
        if not p.can_step:
            break
        p.step()
        steps += 1
    p.finish()

    nb = frame.scramble.n_blocks
    for i, (q, _) in enumerate(specs):
        r_served = p.result_of(q)
        r_solo = seq_frame.run(q, seed=1, start_block=anchors[i] % nb)
        assert_bitwise_equal(r_served, r_solo)
