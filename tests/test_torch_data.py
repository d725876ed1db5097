"""The port's host data layer against the JAX package's: the same seed
gives the same FLIGHTS data, scramble, bitmap words, packed masks and
scan signatures (exact equality)."""

import numpy as np
import pytest

import repro.aqp as R
from repro.aqp import bitmap as Rbm
from repro.aqp import flights_queries as Rfq
from repro.core.lru import LRUCache as RLRU
from repro.data import flights as Rfl

import repro_torch.aqp as T
from repro_torch.aqp import bitmap as Tbm
from repro_torch.aqp import flights_queries as Tfq
from repro_torch.core.lru import LRUCache as TLRU
from repro_torch.data import flights as Tfl

from tests.helpers.torch_parity import port_scramble


@pytest.mark.parametrize("seed", [0, 7])
def test_flights_generate_identical(seed):
    a = Rfl.generate(n_rows=20_000, n_airports=30, n_airlines=5, seed=seed)
    b = Tfl.generate(n_rows=20_000, n_airports=30, n_airlines=5, seed=seed)
    assert a.columns.keys() == b.columns.keys()
    for k in a.columns:
        assert a.columns[k].dtype == b.columns[k].dtype
        np.testing.assert_array_equal(a.columns[k], b.columns[k], err_msg=k)
    np.testing.assert_array_equal(a.airports, b.airports)
    np.testing.assert_array_equal(a.airlines, b.airlines)
    assert a.catalog == b.catalog


@pytest.mark.parametrize("block_rows", [64, 300])
def test_scramble_and_bitmaps_identical(block_rows):
    ds = Rfl.generate(n_rows=30_001, n_airports=70, n_airlines=6, seed=1)
    ra = R.build_scramble(ds.columns, catalog=ds.catalog,
                          block_rows=block_rows, seed=2)
    ta = T.build_scramble(ds.columns, catalog=ds.catalog,
                          block_rows=block_rows, seed=2)
    np.testing.assert_array_equal(ra.valid, ta.valid)
    for k in ra.columns:
        np.testing.assert_array_equal(ra.columns[k], ta.columns[k],
                                      err_msg=k)
    assert (ra.n_rows, ra.block_rows, ra.catalog, ra.categorical) == \
        (ta.n_rows, ta.block_rows, ta.catalog, ta.categorical)
    for col in ("origin", "airline", "day_of_week"):
        rb, tb = Rbm.build_bitmap(ra, col), Tbm.build_bitmap(ta, col)
        assert rb.words.dtype == tb.words.dtype == np.uint32
        np.testing.assert_array_equal(rb.words, tb.words)
        np.testing.assert_array_equal(
            Rbm.unpack_words(rb.words, rb.cardinality),
            Tbm.unpack_words(tb.words, tb.cardinality))


def test_scramble_from_arrays_copies_and_checks():
    ds = Rfl.generate(n_rows=5_000, seed=3)
    ra = R.build_scramble(ds.columns, catalog=ds.catalog, block_rows=128,
                          seed=4)
    ta = port_scramble(ra)
    for k in ra.columns:
        np.testing.assert_array_equal(ra.columns[k], ta.columns[k])
        assert not np.shares_memory(ra.columns[k], ta.columns[k])
    assert ta.n_blocks == ra.n_blocks and ta.seed == ra.seed
    with pytest.raises(ValueError, match="rows per block"):
        T.scramble_from_arrays(ra.columns, ra.valid, ra.n_rows, 64,
                               ra.catalog, ra.categorical, ra.seed)
    bad = dict(ra.columns, origin=ra.columns["origin"][:, :5])
    with pytest.raises(ValueError, match="origin"):
        T.scramble_from_arrays(bad, ra.valid, ra.n_rows, 128, ra.catalog,
                               ra.categorical, ra.seed)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 77, 320])
def test_pack_mask_identical(n):
    rng = np.random.default_rng(n)
    for p in (0.0, 0.3, 1.0):
        mask = rng.random(n) < p
        a, b = Rbm.pack_mask(mask), Tbm.pack_mask(mask)
        assert a.dtype == b.dtype == np.uint32
        np.testing.assert_array_equal(a, b)


def test_scan_signatures_identical():
    for name in Rfq.ALL:
        assert Rfq.ALL[name]().scan_signature() == \
            Tfq.ALL[name]().scan_signature(), name
    q_r = R.AggQuery(agg="count", filters=(
        R.Filter("origin", "isin", np.array([3, 1])),
        R.Filter("dep_time", "between", (10.0, 20.0))),
        group_by=("airline", "day_of_week"))
    q_t = T.AggQuery(agg="count", filters=(
        T.Filter("origin", "isin", np.array([3, 1])),
        T.Filter("dep_time", "between", (10.0, 20.0))),
        group_by=("airline", "day_of_week"))
    assert q_r.scan_signature() == q_t.scan_signature()


def test_lru_cache_behaves_like_reference():
    r, t = RLRU(2), TLRU(2)
    for key in ["a", "b", "a", "c", "b", "d"]:
        assert r.get_or_build(key, lambda: key.upper()) == \
            t.get_or_build(key, lambda: key.upper())
        assert list(r.keys()) == list(t.keys())
    with pytest.raises(ValueError):
        TLRU(0)
