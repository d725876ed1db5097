"""The port's host bound stack against the JAX package's, on random
``StatsBatch`` inputs: the five bounders with and without RangeTrim,
COUNT / SUM intervals and N+, the six stopping conditions, the OptStop
schedule and reference driver, the host state algebra, and derived
expression ranges. The port is the same float64 numpy, so results agree
to <= 1e-12 relative (in practice bit for bit)."""

import numpy as np
import pytest
import torch

from repro.core import bounders as Rb
from repro.core import count_sum as Rcs
from repro.core import derived_bounds as Rdb
from repro.core import optstop as Ro
from repro.core import state as Rs

from repro_torch.core import bounders as Tb
from repro_torch.core import count_sum as Tcs
from repro_torch.core import derived_bounds as Tdb
from repro_torch.core import optstop as To
from repro_torch.core import state as Ts

RTOL = 1e-12
A, B = -60.0, 1800.0


def _batch(seed, G=257, K=64, mod=Rs):
    rng = np.random.default_rng(seed)
    count = rng.integers(0, 400, G).astype(np.float64)
    count[:5] = [0, 1, 2, 3, 1000]
    lo = rng.uniform(A, 100.0, G)
    hi = np.minimum(lo + rng.exponential(200.0, G), B)
    mean = np.where(count > 0, rng.uniform(lo, hi), 0.0)
    m2 = np.where(count > 1, count * rng.uniform(0, 1, G)
                  * ((hi - lo) / 2) ** 2, 0.0)
    hist = np.zeros((G, K))
    for g in range(G):
        if count[g]:
            hist[g] = rng.multinomial(int(count[g]), np.ones(K) / K)
    return mod.StatsBatch(count=count, mean=mean, m2=m2,
                          vmin=np.where(count > 0, lo, np.inf),
                          vmax=np.where(count > 0, hi, -np.inf), hist=hist)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=0)


_BOUNDERS = [("hoeffding", False), ("hoeffding", True),
             ("hoeffding_serfling", False), ("hoeffding_serfling", True),
             ("bernstein", False), ("bernstein", True),
             ("anderson_dkw", False)]


@pytest.mark.parametrize("name,rt", _BOUNDERS)
@pytest.mark.parametrize("seed", [0, 1])
def test_bounders_match_reference(name, rt, seed):
    sr, st = _batch(seed), _batch(seed, mod=Ts)
    br, bt = Rb.get_bounder(name, rangetrim=rt), Tb.get_bounder(name,
                                                                rangetrim=rt)
    assert br.name == bt.name and br.has_phos == bt.has_phos
    rng = np.random.default_rng(seed + 10)
    G = len(sr)
    n_vec = sr.count + rng.integers(0, 10_000, G)
    for N in (1e6, n_vec):
        for delta in (1e-15, 0.05):
            _close(bt.lbound_batch(st, A, B, N, delta),
                   br.lbound_batch(sr, A, B, N, delta))
            _close(bt.rbound_batch(st, A, B, N, delta),
                   br.rbound_batch(sr, A, B, N, delta))
            for x, y in zip(bt.interval_batch(st, A, B, N, delta),
                            br.interval_batch(sr, A, B, N, delta)):
                _close(x, y)
    assert bt.interval(st[4], A, B, 1e6, 1e-9) == \
        pytest.approx(br.interval(sr[4], A, B, 1e6, 1e-9), rel=RTOL)


def test_bernstein_serfling_known_sigma_and_refusals():
    sr, st = _batch(3), _batch(3, mod=Ts)
    br = Rb.BernsteinSerflingBounder(sigma=40.0)
    bt = Tb.BernsteinSerflingBounder(sigma=40.0)
    for x, y in zip(bt.interval_batch(st, A, B, 1e5, 1e-6),
                    br.interval_batch(sr, A, B, 1e5, 1e-6)):
        _close(x, y)
    with pytest.raises(ValueError):
        Tb.get_bounder("anderson_dkw", rangetrim=True)
    with pytest.raises(ValueError):
        Tb.AndersonDKWBounder().lbound_batch(_batch(3, mod=Ts),
                                             np.linspace(0, 1, 257), B,
                                             1e5, 0.1)


def test_count_sum_match_reference():
    rng = np.random.default_rng(4)
    m_v = rng.integers(0, 5000, 300).astype(np.float64)
    r = np.maximum(m_v + rng.integers(-5, 20_000, 300), 0).astype(float)
    R = 1e6
    for d in (1e-15, 0.01):
        for fr, ft in ((Rcs.selectivity_ci, Tcs.selectivity_ci),
                       (Rcs.count_ci, Tcs.count_ci)):
            for x, y in zip(ft(m_v, r, R, d), fr(m_v, r, R, d)):
                _close(x, y)
        _close(Tcs.n_plus(m_v, r, R, d), Rcs.n_plus(m_v, r, R, d))
        assert Tcs.n_plus(7.0, 100.0, R, d) == Rcs.n_plus(7.0, 100.0, R, d)
    cnt = (rng.uniform(0, 10, 50), rng.uniform(10, 20, 50))
    avg = (rng.uniform(-5, 1, 50), rng.uniform(1, 5, 50))
    for x, y in zip(Tcs.sum_ci(cnt, avg), Rcs.sum_ci(cnt, avg)):
        _close(x, y)


_CONDS = [("FixedSamples", dict(m=100)), ("AbsoluteWidth", dict(eps=30.0)),
          ("RelativeWidth", dict(eps=0.2)),
          ("ThresholdSide", dict(threshold=10.0)),
          ("TopKSeparated", dict(k=3, largest=True)),
          ("TopKSeparated", dict(k=2, largest=False)),
          ("TopKSeparated", dict(k=500)), ("GroupsOrdered", {})]


@pytest.mark.parametrize("cls,kw", _CONDS)
def test_stopping_conditions_match_reference(cls, kw):
    rng = np.random.default_rng(5)
    est = rng.normal(10.0, 20.0, 200)
    w = rng.exponential(5.0, 200)
    lo, hi = est - w, est + w
    lo[:3] = hi[:3] = [0.0, 1.0, -2.0]   # point intervals, one at zero
    counts = rng.integers(0, 300, 200).astype(float)
    got = getattr(To, cls)(**kw).active(lo, hi, est, counts)
    want = getattr(Ro, cls)(**kw).active(lo, hi, est, counts)
    np.testing.assert_array_equal(got, want)


def test_optstop_schedule_and_reference_driver():
    for k in (1, 2, 17, 10_000):
        assert To.delta_schedule(1e-9, k) == Ro.delta_schedule(1e-9, k)
    data = np.random.default_rng(6).normal(20.0, 15.0, 30_000)
    data = np.clip(data, A, B)
    kw = dict(batch=512, rng=None)
    stop = lambda lo, hi: hi - lo < 10.0
    got = To.optstop_reference(data, Tb.get_bounder("bernstein", True), A,
                               B, 1e-9, stop, **kw)
    want = Ro.optstop_reference(data, Rb.get_bounder("bernstein", True), A,
                                B, 1e-9, stop, **kw)
    assert got == want


def test_state_algebra_matches_reference():
    rng = np.random.default_rng(7)
    mk = lambda mod, s: mod.MomentState(*(np.asarray(f) for f in s))
    fields = [rng.integers(0, 50, 64).astype(float), rng.normal(0, 5, 64),
              rng.uniform(0, 100, 64), rng.normal(-10, 1, 64),
              rng.normal(10, 1, 64)]
    fields2 = [f[::-1].copy() for f in fields]
    fields[0][:4] = fields2[0][:4] = 0.0
    got = Ts.merge_moments_host(mk(Ts, fields), mk(Ts, fields2))
    want = Rs.merge_moments_host(mk(Rs, fields), mk(Rs, fields2))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    # to_host takes torch tensors, casting to float64 before arithmetic
    t32 = Ts.MomentState(*(torch.tensor(f, dtype=torch.float32)
                           for f in fields))
    for x, y in zip(Ts.to_host(t32), Rs.to_host(Rs.MomentState(
            *(np.asarray(f, np.float32) for f in fields)))):
        assert x.dtype == np.float64
        np.testing.assert_array_equal(x, y)
    for which in ("max", "min"):
        a = Ts.downdate_extreme_batch(_batch(8, mod=Ts), which)
        b = Rs.downdate_extreme_batch(_batch(8), which)
        for f in ("count", "mean", "m2", "vmin", "vmax", "hist"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    poison = [f.copy() for f in fields]
    poison[1][3] = np.nan
    assert Ts.moments_nonfinite(mk(Ts, poison)) == \
        Rs.moments_nonfinite(mk(Rs, poison)) is True
    assert Ts.moments_nonfinite(mk(Ts, fields)) is False
    h = rng.uniform(0, 3, (4, 8))
    np.testing.assert_array_equal(Ts.merge_hist_host(h, h),
                                  Rs.merge_hist_host(h, h))
    s = Ts.Stats.of_sample(data := rng.normal(0, 1, 99), 16, (-4.0, 4.0))
    r = Rs.Stats.of_sample(data, 16, (-4.0, 4.0))
    assert (s.count, s.mean, s.m2, s.vmin, s.vmax) == \
        (r.count, r.mean, r.m2, r.vmin, r.vmax)
    np.testing.assert_array_equal(s.hist, r.hist)


def test_derived_range_monotone_exact_and_convex_close():
    boxes = [(-60.0, 1800.0), (0.0, 1440.0)]
    mono = lambda x: x[0] * 0.5 - x[1] / 60.0
    assert Tdb.derived_range(mono, boxes, monotone=(1, -1)) == \
        Rdb.derived_range(mono, boxes, monotone=(1, -1))
    # convex, unique minimum (interior or on the boundary): the multi-start
    # points differ from jax.random's, the optimum does not
    convex_fns = [
        lambda x: ((x[0] - 300.0) / 60.0) ** 2
        + ((x[1] - 700.0) / 100.0) ** 2,
        lambda x: (x[0] / 60.0) ** 2 + ((x[1] - 700.0) / 100.0) ** 2,
        lambda x: ((x[0] + 100.0) / 60.0) ** 2 + (x[1] / 100.0) ** 2,
    ]
    for conv in convex_fns:
        lo_t, hi_t = Tdb.derived_range(conv, boxes, convex=True)
        lo_r, hi_r = Rdb.derived_range(conv, boxes, convex=True)
        assert hi_t == hi_r
        assert abs(lo_t - lo_r) <= 1e-4
    conc = lambda x: -(((x[0] + 100.0) / 60.0) ** 2)
    lo_t, hi_t = Tdb.derived_range(conc, boxes[:1], convex=False)
    lo_r, hi_r = Rdb.derived_range(conc, boxes[:1], convex=False)
    assert lo_t == lo_r and abs(hi_t - hi_r) <= 1e-4
    with pytest.raises(ValueError):
        Tdb.derived_range(convex_fns[0], boxes)
