"""The pieces of the port's shared-pass loop on the CPU, held against
the reference and against the port's own solo pieces:

  * ``ref.active_blocks_multi_ref`` row q == ``active_blocks_ref``
    against stack[q] (bitwise);
  * the round head's plain version for a slot of a pass: with lap end
    ``nb``, no wrap and one row it is bit for bit the solo head; a stack
    of rows is bit for bit the solo head against the rows' OR; with
    ``wrap`` and an anchor, bit for bit the solo head on the scan order
    rotated to the anchor (cursor shifted by the anchor);
  * ``fused_round_multi`` against the reference's ``fused_round_multi``
    (``impl="ref"``) on the same inputs: verdicts, flag stacks and
    cursors equal; the float32 deltas bit for bit on exactly
    representable data, within 1e-6 relative on general data (both fold
    rows in row order);
  * one chunk of the pass loop (``SharedPass.step`` with
    ``chunk_rounds=3``) against the reference's device pass loop under
    64-bit JAX, on the same scramble (exact data): cursors, coverage,
    taint, metrics and each query's active / finished state equal,
    moments and intervals within 1e-9.

The module runs torch on one thread (``one_torch_thread``): the eager
loops are thousands of small ops, which intra-op threads slow under
xdist.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.aqp as R
from repro.core import optstop as Ro
from repro.data import flights
from repro.kernels import fused_scan as Rfused
from repro.serve import FrameServer as RFrameServer

from repro_torch.aqp import AggQuery, EngineConfig, FastFrame, Filter
from repro_torch.core import optstop as To
from repro_torch.kernels import fused_scan, ref
from repro_torch.serve import FrameServer

from tests.helpers.torch_parity import (  # noqa: F401 (module fixture)
    exact_flights_columns, one_torch_thread, port_scramble)


def _words(rng, nb, W, density=0.05):
    one_bit = (np.uint64(1) << rng.integers(0, 32, (nb, W)).astype(
        np.uint64)).astype(np.uint32)
    return np.where(rng.random((nb, W)) < density, one_bit, np.uint32(0))


@pytest.mark.parametrize("n,W,Q", [(300, 1, 1), (257, 3, 4), (64, 40, 7)])
def test_active_blocks_multi_ref_is_per_row(n, W, Q):
    rng = np.random.default_rng(n + W + Q)
    words = torch.from_numpy(_words(rng, n, W).view(np.int32))
    stack = torch.from_numpy(rng.integers(0, 2**32, (Q, W),
                                          dtype=np.uint32).view(np.int32))
    got = ref.active_blocks_multi_ref(words, stack)
    assert got.shape == (Q, n) and got.dtype == torch.int32
    for q in range(Q):
        assert torch.equal(got[q], ref.active_blocks_ref(words, stack[q]))


NB, WINDOW, BUDGET = 2000, 256, 16


def _head_case(seed, W):
    rng = np.random.default_rng(seed)
    order = rng.permutation(NB).astype(np.int32)
    static_ok = torch.from_numpy(rng.random(NB) < 0.85)
    words = torch.from_numpy(_words(rng, NB, W).view(np.int32))
    stack = torch.from_numpy(rng.integers(0, 2**32, (3, W),
                                          dtype=np.uint32).view(np.int32))
    return rng, order, static_ok, words, stack


def _cur(p, go=True):
    return torch.tensor(p, dtype=torch.int64), torch.tensor(go)


def _pad(order, wrap):
    tail = order[np.arange(WINDOW) % NB] if wrap else np.zeros(WINDOW,
                                                               np.int32)
    return torch.from_numpy(np.concatenate([order, tail]))


@pytest.mark.parametrize("W", [1, 5])
def test_head_at_the_solo_lap_is_the_solo_head(W):
    """lap_end = nb, wrap off, a (1, W) stack: the solo head's bits, at
    cursors inside the scan, near its end, at nb, past it, and with go
    false."""
    _, order, static_ok, words, stack = _head_case(W, W)
    opad = _pad(order, wrap=False)
    kw = dict(nb=NB, window=WINDOW, budget=BUDGET, probe=True)
    for p, go in [(0, True), (731, True), (NB - 90, True), (NB, True),
                  (NB + 3, True), (-1, True), (400, False)]:
        want = ref.round_select_ref(opad, static_ok, words, stack[0],
                                    *_cur(p, go), **kw)
        got = ref.round_select_ref(opad, static_ok, words, stack[:1],
                                   *_cur(p, go), lap_end=NB, wrap=False,
                                   **kw)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and torch.equal(x, y), (p, go)


def test_head_with_a_stack_is_the_head_of_the_union():
    """A stack's flags are the union of its rows': bit for bit the head
    against the OR of the rows."""
    _, order, static_ok, words, stack = _head_case(11, 4)
    opad = _pad(order, wrap=False)
    union = stack[0] | stack[1] | stack[2]
    kw = dict(nb=NB, window=WINDOW, budget=BUDGET, probe=True)
    for p in (0, 500, NB - 30):
        a = ref.round_select_ref(opad, static_ok, words, stack, *_cur(p),
                                 **kw)
        b = ref.round_select_ref(opad, static_ok, words, union, *_cur(p),
                                 **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("start,anchor", [(0, 700), (1311, 1999),
                                          (5, 0), (1500, 1024)])
def test_wrapped_lap_is_the_rotated_solo_scan(start, anchor):
    """A slot anchored at ``anchor`` of a pass started at ``start`` reads
    a wrap-filled order from ``pos % nb``: at every cursor of its lap
    its head is the solo head over the order rotated to ``(start +
    anchor) % nb`` at cursor ``pos - anchor`` (new_pos shifted alike)."""
    _, perm, static_ok, words, stack = _head_case(start + anchor, 3)
    del perm
    base = (start + np.arange(NB)) % NB
    rotated = (start + anchor + np.arange(NB)) % NB
    opad = _pad(base.astype(np.int32), wrap=True)
    solo_pad = _pad(rotated.astype(np.int32), wrap=False)
    kw = dict(nb=NB, window=WINDOW, budget=BUDGET, probe=True)
    for off in (0, 1, 333, NB - WINDOW - 1, NB - 50, NB):
        p = anchor + off
        got = ref.round_select_ref(opad, static_ok, words, stack, *_cur(p),
                                   lap_end=anchor + NB, wrap=True, **kw)
        want = ref.round_select_ref(solo_pad, static_ok, words, stack,
                                    *_cur(off), **kw)
        ok, flags, new_pos, blk, tvalid = got
        assert torch.equal(ok, want[0]) and torch.equal(flags, want[1])
        assert int(new_pos) - anchor == int(want[2])
        assert torch.equal(blk, want[3]) and torch.equal(tvalid, want[4])


@pytest.mark.parametrize("exact", [True, False])
def test_fused_round_multi_matches_reference(exact):
    """Three slots (a probe slot, a non-probe slot, a histogram slot),
    two of them anchored mid-scan, against the reference's
    ``fused_round_multi`` on the same inputs."""
    rng = np.random.default_rng(7 + exact)
    nb, br, window, budget = 300, 64, 128, 8
    order = ((41 + np.arange(nb)) % nb).astype(np.int32)
    opad = np.concatenate([order, order[np.arange(window) % nb]])
    static_ok = rng.random(nb) < 0.9
    mask = (rng.random((nb, br)) < 0.8).astype(np.float32)
    G = (40, 1, 6)
    if exact:
        vals = [rng.integers(0, 17, (nb, br)).astype(np.float32)
                for _ in G]
        grid = (0.0, 16.0)
    else:
        vals = [rng.normal(40.0, 25.0, (nb, br)).astype(np.float32)
                for _ in G]
        grid = (-60.0, 180.0)
    gids = [rng.integers(0, g, (nb, br)).astype(np.int32) for g in G]
    words = [_words(rng, nb, 2), np.ones((nb, 1), np.uint32),
             _words(rng, nb, 1)]
    active = [rng.integers(0, 2**32, (3, 2), dtype=np.uint32),
              np.asarray([[1], [0]], np.uint32),
              rng.integers(0, 2**32, (1, 1), dtype=np.uint32)]
    center = 0.5 * (grid[0] + grid[1])
    meta = tuple((g, 32, h, grid[0], grid[1], center)
                 for g, h in zip(G, (False, False, True)))
    anchors = (0, 120, 299)
    pos = (57, 140, 299 + 250)
    kw = dict(nb=nb, window=window, budget=budget, meta=meta)
    r = Rfused.fused_round_multi(
        jnp.asarray(mask), jnp.asarray(opad), jnp.asarray(static_ok),
        jnp.asarray(pos, jnp.int32), tuple(map(jnp.asarray, vals)),
        tuple(map(jnp.asarray, gids)), tuple(map(jnp.asarray, words)),
        tuple(map(jnp.asarray, active)), impl="ref",
        anchors=jnp.asarray(anchors, jnp.int32), **kw)
    t = fused_scan.fused_round_multi(
        torch.from_numpy(mask), torch.from_numpy(opad),
        torch.from_numpy(static_ok), torch.tensor(pos, dtype=torch.int64),
        tuple(map(torch.from_numpy, vals)),
        tuple(map(torch.from_numpy, gids)),
        tuple(torch.from_numpy(w.view(np.int32)) for w in words),
        tuple(torch.from_numpy(a.view(np.int32)) for a in active),
        anchors=anchors, **kw)
    r_states, r_hists, r_fl, r_ok, r_pos = r
    t_states, t_hists, t_fl, t_ok, t_pos = t
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(r_pos))
    for s in range(3):
        np.testing.assert_array_equal(t_ok[s].numpy(), np.asarray(r_ok[s]))
        np.testing.assert_array_equal(t_fl[s].numpy(), np.asarray(r_fl[s]))
        for a, b in zip(t_states[s], r_states[s]):
            a, b = a.numpy(), np.asarray(b)
            if exact:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
        if meta[s][2]:
            np.testing.assert_array_equal(t_hists[s].numpy(),
                                          np.asarray(r_hists[s]))
        else:
            assert t_hists[s] is None and r_hists[s] is None


def _chunk_queries(Q, opt):
    filt = (Q[1]("day_of_week", "le", 4),)
    return [Q[0](agg="avg", column="dep_delay", group_by="airline",
                 filters=filt, stop=opt.ThresholdSide(threshold=8.0),
                 delta=1e-9),
            Q[0](agg="avg", column="dep_delay", group_by="airline",
                 filters=filt, stop=opt.AbsoluteWidth(eps=1.0), delta=1e-9),
            Q[0](agg="sum", column="dep_delay", filters=filt,
                 stop=opt.AbsoluteWidth(eps=5e4), delta=1e-9),
            Q[0](agg="avg", column="dep_delay", group_by="origin",
                 filters=filt, bounder="anderson_dkw", rangetrim=False,
                 stop=opt.AbsoluteWidth(eps=40.0), delta=1e-9)]


def test_pass_loop_chunk_matches_reference(x64):
    """Chunks of the device pass loop (three rounds each, a mid-scan
    admission between them) on the same exact-data scramble in both
    packages: slot cursors, coverage, taint, exactness and metrics
    equal, moments and intervals within 1e-9 (rtol 1e-12), each query's
    activity and finished flag equal."""
    ds = flights.generate(n_rows=60_000, n_airports=30, n_airlines=6,
                          seed=5)
    cols = exact_flights_columns(ds.columns)
    catalog = dict(ds.catalog, dep_delay=(0.0, 16.0))
    rsc = R.build_scramble(cols, catalog=catalog, block_rows=256, seed=6)
    cfg = dict(round_blocks=8, lookahead_blocks=32, hist_bins=64)
    r_frame = R.FastFrame(rsc, R.EngineConfig(device_loop=True, **cfg))
    t_frame = FastFrame(port_scramble(rsc),
                        EngineConfig(device_loop=True, **cfg), device="cpu")
    r_qs = _chunk_queries((R.AggQuery, R.Filter), Ro)
    t_qs = _chunk_queries((AggQuery, Filter), To)
    kw = dict(seed=1, start_block=9, chunk_rounds=3)
    rp = RFrameServer(r_frame).open_pass(r_qs[0].filters, **kw)
    tp = FrameServer(t_frame).open_pass(t_qs[0].filters, **kw)
    for p, qs in ((rp, r_qs), (tp, t_qs)):
        p.admit(qs[:3])
        p.step()
        p.admit(qs[3:])
        p.step()
        p.step()
    assert tp.rounds == rp.rounds == 9
    assert len(tp.slots) == len(rp.slots) == 3
    for ts, rs in zip(tp.slots, rp.slots):
        assert (ts.pos, ts.anchor, ts.lap_done_round) == (
            rs.pos, rs.anchor, rs.lap_done_round)
        assert ts.metrics == rs.metrics
        tv, rv = ts.views, rs.views
        for f in ("seen_presence", "processed", "exact", "tainted"):
            np.testing.assert_array_equal(getattr(tv, f), getattr(rv, f),
                                          err_msg=f)
        assert tv.blocks_fetched == rv.blocks_fetched
        for a, b in zip(tv.state, rv.state):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12,
                                       atol=1e-9)
        if tv.use_hist:
            np.testing.assert_array_equal(tv.hist, np.asarray(rv.hist))
        for tq, rq in zip(ts.qcis, rs.qcis):
            assert tq.finished == rq.finished
            np.testing.assert_array_equal(tq.active, rq.active)
            for f in ("lo", "hi", "est"):
                a, b = getattr(tq, f), getattr(rq, f)
                np.testing.assert_array_equal(np.isfinite(a),
                                              np.isfinite(b))
                fin = np.isfinite(a)
                np.testing.assert_allclose(a[fin], b[fin], rtol=1e-12,
                                           atol=1e-9, err_msg=f)


def test_nan_sentinel_flags_only_the_poisoned_slot():
    """``carry_nonfinite_slots``: a NaN in one slot's moments (or a
    non-finite histogram mass) flags that slot alone; ``±inf`` extremes
    of untouched groups are not poison."""
    def slot(G, hist):
        st = fused_scan.MomentState(
            torch.zeros(G, dtype=torch.float64),
            torch.zeros(G, dtype=torch.float64),
            torch.zeros(G, dtype=torch.float64),
            torch.full((G,), float("inf"), dtype=torch.float64),
            torch.full((G,), -float("inf"), dtype=torch.float64))
        z = torch.zeros((), dtype=torch.int64)
        return fused_scan.SlotCarry(
            pos=z, state=st, hist=hist,
            seen_presence=torch.zeros(G, dtype=torch.int32),
            tainted=torch.zeros(G, dtype=torch.bool),
            exact=torch.zeros(G, dtype=torch.bool),
            processed=torch.zeros(4, dtype=torch.bool), blocks_fetched=z,
            skipped_static=z, skipped_active=z, probes=z, lap_rounds=z)

    slots = [slot(3, None), slot(2, torch.zeros((2, 4),
                                                dtype=torch.float64)),
             slot(1, None)]
    z = torch.zeros((), dtype=torch.int64)
    carry = fused_scan.PassCarry(rounds=z, it=z, n_live=z,
                                 slots=tuple(slots), queries=((), (), ()))
    assert fused_scan.carry_nonfinite_slots(carry) == (False, False, False)
    slots[0].state.mean[1] = float("nan")
    slots[1].hist[0, 2] = float("inf")
    assert fused_scan.carry_nonfinite_slots(carry) == (True, True, False)
