"""The port's fused scan round against the reference's
``fused_round(impl='ref')`` from the same cursor, over randomised starts
and budgets: ``ok``, ``flags`` and ``new_pos`` equal, the moment delta
bit for bit (row-order folds on both sides). Plus the device twins of
``pack_mask`` and of the float64 merge."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.aqp import bitmap as Rbm
from repro.core import state as Rs
from repro.kernels import fused_scan as Rfs

from repro_torch.core import state as Ts
from repro_torch.kernels import fused_scan as Tfs

from tests.helpers.torch_parity import exact_flights_columns


@pytest.fixture(scope="module")
def scan_inputs():
    from repro.aqp import build_scramble
    from repro.data import flights
    ds = flights.generate(n_rows=80_000, n_airports=50, n_airlines=6,
                          seed=8)
    sc = build_scramble(ds.columns, catalog=ds.catalog, block_rows=128,
                        seed=9)
    nb = sc.n_blocks
    G = sc.categorical["origin"]
    words = Rbm.build_bitmap(sc, "origin").words
    rng = np.random.default_rng(10)
    return dict(
        nb=nb, G=G, words=words,
        gids=sc.columns["origin"].astype(np.int32),
        mask=(sc.valid & (sc.columns["dep_time"] > 300.0)).astype(
            np.float32),
        flights=sc.columns["dep_delay"].astype(np.float32),
        exact=exact_flights_columns(sc.columns)["dep_delay"],
        static_ok=rng.random(nb) < 0.85, rng=rng)


def _case(inp, seed):
    rng = np.random.default_rng(seed)
    nb = inp["nb"]
    window = int(rng.choice([32, 64, 192]))
    budget = int(rng.choice([1, 8, 20, 64]))
    start = int(rng.integers(nb))
    order = (start + np.arange(nb)) % nb
    opad = np.zeros(nb + window, np.int32)
    opad[:nb] = order
    pos = int(rng.choice([0, int(rng.integers(nb)), nb - 3]))
    active = rng.random(inp["G"]) < rng.choice([0.05, 0.5, 1.0])
    return window, budget, opad, pos, Rbm.pack_mask(active)


@pytest.mark.parametrize("data", ["exact", "flights"])
@pytest.mark.parametrize("probe", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_fused_round_matches_reference(scan_inputs, data, probe, seed):
    inp = scan_inputs
    window, budget, opad, pos, act = _case(inp, seed * 2 + probe)
    values = inp[data]
    center, a, b = ((8.0, 0.0, 16.0) if data == "exact"
                    else (870.0, -60.0, 1800.0))
    kw = dict(nb=inp["nb"], window=window, budget=budget, center=center,
              num_groups=inp["G"], probe=probe)
    st_r, _, ok_r, fl_r, np_r = Rfs.fused_round(
        jnp.asarray(values), jnp.asarray(inp["gids"]),
        jnp.asarray(inp["mask"]), jnp.asarray(inp["words"]),
        jnp.asarray(opad), jnp.asarray(inp["static_ok"]),
        jnp.asarray(pos, jnp.int32), jnp.asarray(act), impl="ref", a=a,
        b=b, nbins=64, use_hist=False, **kw)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    st_t, ok_t, fl_t, np_t = Tfs.fused_round(
        t(values), t(inp["gids"]), t(inp["mask"]),
        t(inp["words"].view(np.int32)), t(opad), t(inp["static_ok"]), pos,
        t(act.view(np.int32)), **kw)
    assert int(np_t) == int(np_r)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_r))
    np.testing.assert_array_equal(fl_t.numpy(), np.asarray(fl_r))
    for x, y in zip(st_t, st_r):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("seed", range(3))
def test_selection_helpers_match_reference(seed):
    rng = np.random.default_rng(seed)
    window, budget, nb = 96, int(rng.integers(1, 40)), 500
    pos = int(rng.integers(0, nb))
    flags = rng.random(window) < rng.choice([0.0, 0.1, 0.6])
    win = rng.integers(0, nb, window).astype(np.int32)
    take_r, new_r = Rfs._budget_select(jnp.asarray(flags),
                                       jnp.asarray(pos, jnp.int32), nb,
                                       window, budget)
    take_t, new_t, csum = Tfs._budget_select(torch.from_numpy(flags), pos,
                                             nb, window, budget)
    np.testing.assert_array_equal(take_t.numpy(), np.asarray(take_r))
    assert int(new_t) == int(new_r)
    got = Tfs._gather_blocks(take_t, csum, torch.from_numpy(win), window,
                             budget)
    want = Rfs._gather_blocks(take_r, jnp.asarray(win), window, budget)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("G", [1, 31, 32, 45, 2800])
def test_pack_active_device_matches_pack_mask(G):
    rng = np.random.default_rng(G)
    for p in (0.0, 0.4, 1.0):
        active = rng.random(G) < p
        n_words = -(-G // 32)
        got = Tfs.pack_active_device(torch.from_numpy(active), n_words)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      Rbm.pack_mask(active))


def test_merge_f64_matches_host_merge():
    rng = np.random.default_rng(12)
    G = 64
    run = Rs.MomentState(rng.integers(0, 90, G).astype(float),
                         rng.normal(0, 9, G), rng.uniform(0, 99, G),
                         rng.normal(-9, 1, G), rng.normal(9, 1, G))
    delta32 = [rng.integers(0, 30, G).astype(np.float32),
               rng.normal(0, 9, G).astype(np.float32),
               rng.uniform(0, 99, G).astype(np.float32),
               rng.normal(-9, 1, G).astype(np.float32),
               rng.normal(9, 1, G).astype(np.float32)]
    delta32[0][:5] = 0.0
    run.count[:3] = 0.0
    want = Rs.merge_moments_host(run, Rs.to_host(
        Rs.MomentState(*delta32)))
    got = Tfs._merge_f64(
        Ts.MomentState(*(torch.from_numpy(f.copy()) for f in run)),
        Ts.MomentState(*(torch.from_numpy(f) for f in delta32)))
    for x, y in zip(got, want):
        assert x.dtype == torch.float64
        np.testing.assert_array_equal(x.numpy(), y)
