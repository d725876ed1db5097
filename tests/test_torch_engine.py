"""The slice as a whole: ``FastFrame.run`` of the port (on the CPU, where
its kernels are their plain versions) against the JAX package's host
loop on one scramble, for the quickstart query, F-q1..F-q9 and a
G=10240 ``("origin", "airline")`` GROUP BY, over the four sampling modes
and the per-block path (``fused=False``), and for F-q2 and the GROUP BY
under the Anderson/DKW bounder (``rangetrim=False``, 256 histogram bins),
whose rounds fold the per-group histogram too.

On exactly-representable data every scan decision and metric is equal
and CIs agree to <= 1e-9. On FLIGHTS data scan decisions are equal, both
packages cover the numpy truth alike, and CIs agree to <= 1e-6 relative
(slack for f32 reordering; both fold in row order, so they agree
bitwise in practice)."""

import numpy as np
import pytest

import repro.aqp as R
from repro.aqp import flights_queries as Rfq
from repro.core import optstop as Ro
from repro.data import flights

import repro_torch.aqp as T
from repro_torch.aqp import flights_queries as Tfq
from repro_torch.core import optstop as To

from tests.helpers.torch_parity import (assert_port_matches_ref,
                                        exact_flights_columns,
                                        port_scramble)

# device_loop=False on both sides: these cases hold the port's per-round
# host loop against the reference's (tests/test_torch_device_loop.py holds
# the device loop)
CFG = dict(round_blocks=16, lookahead_blocks=64, sync_lookahead_blocks=16,
           hist_bins=256, device_loop=False)


def _queries(mod, fq, opt):
    """name -> query of package ``mod`` (``R`` or ``T``)."""
    qs = {name: build() for name, build in fq.ALL.items()}
    qs["quickstart"] = mod.AggQuery(
        agg="avg", column="dep_delay",
        filters=(mod.Filter("origin", "eq", 0),),
        stop=opt.RelativeWidth(eps=0.5), bounder="bernstein",
        rangetrim=True, delta=1e-15)
    qs["G10240"] = mod.AggQuery(
        agg="avg", column="dep_delay", group_by=("origin", "airline"),
        stop=opt.ThresholdSide(threshold=10.0), delta=1e-6)
    adkw = dict(bounder="anderson_dkw", rangetrim=False)
    qs["F-q2-adkw"] = fq.ALL["F-q2"](**adkw)
    qs["G10240-adkw"] = mod.AggQuery(
        agg="avg", column="dep_delay", group_by=("origin", "airline"),
        stop=opt.ThresholdSide(threshold=10.0), delta=1e-6, **adkw)
    return qs


QUERIES = {"R": _queries(R, Rfq, Ro), "T": _queries(T, Tfq, To)}


@pytest.fixture(scope="module")
def scrambles():
    """(reference scramble, port scramble, truth columns) per data set.
    160 airports x 64 airlines gives the G=10240 composite GROUP BY."""
    ds = flights.generate(n_rows=120_000, n_airports=160, n_airlines=64,
                          seed=0)
    out = {}
    for data in ("flights", "exact"):
        cols = ds.columns if data == "flights" else \
            exact_flights_columns(ds.columns)
        catalog = dict(ds.catalog)
        if data == "exact":
            catalog["dep_delay"] = (0.0, 16.0)
        sc = R.build_scramble(cols, catalog=catalog, block_rows=256, seed=1)
        out[data] = (sc, port_scramble(sc), cols)
    return out


def _truth(cols, q):
    """Per-group exact AVG (float64) and which groups exist."""
    mask = np.ones(len(cols["dep_delay"]), bool)
    for f in q.filters:
        mask &= f.evaluate(cols)
    codes = np.zeros(mask.shape, np.int64)
    G = 1
    for c in q.group_cols:
        card = int(cols[c].max()) + 1
        codes, G = codes * card + cols[c], G * card
    v = cols["dep_delay"].astype(np.float64)
    cnt = np.bincount(codes[mask], minlength=G)
    tot = np.bincount(codes[mask], weights=v[mask], minlength=G)
    return tot / np.maximum(cnt, 1), cnt > 0


def _covered(res, truth, exists):
    # f32 data path: 1e-4 relative, as examples/quickstart.py, but at
    # least 1e-4 absolute — an exact view's point estimate carries f32
    # rounding of (v - centre) sums even when its mean is near zero
    tol = 1e-4 * np.maximum(np.abs(truth), 1.0)
    n = min(len(truth), len(res.lo))
    ok = (res.lo[:n] - tol[:n] <= truth[:n]) & \
        (truth[:n] <= res.hi[:n] + tol[:n])
    return ok | ~exists[:n]


ADKW = ("F-q2-adkw", "G10240-adkw")
CASES = ([(d, name, "active_peek", True)
          for d in ("exact", "flights") for name in QUERIES["T"]
          if name not in ADKW]
         + [(d, name, s, True) for d in ("exact", "flights")
            for name in ("F-q3", "G10240")
            for s in ("active_sync", "scan", "exact")]
         + [(d, name, s, False) for d in ("exact", "flights")
            for name, s in (("quickstart", "active_peek"),
                            ("F-q6", "active_sync"), ("G10240", "scan"))]
         + [(d, name, s, fused) for d in ("exact", "flights")
            for name, s, fused in (("F-q2-adkw", "active_peek", True),
                                   ("G10240-adkw", "active_peek", True),
                                   ("F-q2-adkw", "scan", True),
                                   ("G10240-adkw", "exact", True),
                                   ("F-q2-adkw", "active_peek", False))])


@pytest.mark.parametrize("data,name,sampling,fused", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_run_matches_reference(scrambles, data, name, sampling, fused):
    sc_r, sc_t, cols = scrambles[data]
    kw = dict(CFG, fused=fused)
    r_ref = R.FastFrame(sc_r, R.EngineConfig(**kw)).run(
        QUERIES["R"][name], sampling=sampling, seed=3)
    r_port = T.FastFrame(sc_t, T.EngineConfig(**kw), device="cpu").run(
        QUERIES["T"][name], sampling=sampling, seed=3)
    assert_port_matches_ref(r_port, r_ref, exact_data=(data == "exact"))
    truth, exists = _truth(cols, QUERIES["T"][name])
    cov_port = _covered(r_port, truth, exists)
    np.testing.assert_array_equal(cov_port, _covered(r_ref, truth, exists))
    if data == "flights":
        assert cov_port.all()


@pytest.mark.parametrize("data", ["exact", "flights"])
def test_anderson_run_matches_reference_at_100_bins(scrambles, data):
    """A bin count that is not a multiple of 128: both packages bin on
    the logical 100-bin grid (the reference's host loop folds through its
    ``ref`` path here), so the runs agree as at 256 bins."""
    sc_r, sc_t, cols = scrambles[data]
    kw = dict(CFG, hist_bins=100)
    r_ref = R.FastFrame(sc_r, R.EngineConfig(**kw)).run(
        QUERIES["R"]["F-q2-adkw"], sampling="active_peek", seed=3)
    r_port = T.FastFrame(sc_t, T.EngineConfig(**kw), device="cpu").run(
        QUERIES["T"]["F-q2-adkw"], sampling="active_peek", seed=3)
    assert_port_matches_ref(r_port, r_ref, exact_data=(data == "exact"))
