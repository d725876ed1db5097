"""Kernel level, on the CPU: the port's plain versions against the JAX
package's oracles and its Pallas kernels under the interpreter.

``block_agg_ref`` folds rows in row order with ``index_add_``, the order
of the reference's ``.at[].add`` scatter, so the two agree bit for bit on
all data. The Pallas kernel sums by one-hot matmul tiles, another order:
bit for bit on exactly-representable data, within 1e-6 relative on
general data (f32 reordering)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as Rops
from repro.kernels import ref as Rref

from repro_torch.kernels import ops as Tops
from repro_torch.kernels import ref as Tref


def _rows(seed, n, G, exact, nan_rows):
    """Flat fold inputs with an uneven tail of ``mask == 0`` padding rows;
    exact data keeps every partial sum an integer below 2**24."""
    rng = np.random.default_rng(seed)
    if exact:
        v = rng.integers(0, 17, n).astype(np.float32)
        center = 8.0
    else:
        v = rng.uniform(10.0, 50.0, n).astype(np.float32)
        center = 0.0   # all terms positive: relative error is meaningful
    g = rng.integers(0, G, n).astype(np.int32)
    m = (rng.random(n) < 0.7).astype(np.float32)
    m[-(n % 97 + 3):] = 0.0                       # padding tail
    if nan_rows:
        v[[1, n // 2]] = np.nan
    return v, g, m, center


def _as_np(xs):
    return [np.asarray(x) for x in xs]


@pytest.mark.parametrize("G", [1, 7, 130, 300])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("n", [1000, 3333])
def test_block_agg_ref_matches_reference(G, exact, n):
    v, g, m, c = _rows(G + n, n, G, exact, nan_rows=False)
    got = _as_np(Tref.block_agg_ref(torch.from_numpy(v),
                                    torch.from_numpy(g),
                                    torch.from_numpy(m), c, num_groups=G))
    # the JAX oracle: same row order -> same bits on any data
    want = _as_np(Rref.block_agg_ref(jnp.asarray(v), jnp.asarray(g),
                                     jnp.asarray(m), c, num_groups=G))
    for x, y in zip(got, want):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    # the Pallas kernel under the interpreter: another summation order
    pal = _as_np(Rops.grouped_sums(jnp.asarray(v), jnp.asarray(g),
                                   jnp.asarray(m), G, c, impl="interpret"))
    if exact:
        for x, y in zip(got, pal):
            np.testing.assert_array_equal(x, y)
    else:
        np.testing.assert_allclose(got[0], pal[0], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got[1], pal[1])   # extremes: exact
        np.testing.assert_array_equal(got[2], pal[2])


@pytest.mark.parametrize("G", [1, 7, 300])
def test_block_agg_ref_nan_rows_fold_like_reference(G):
    """NaN values poison the sums of their group even when masked (the
    fold multiplies every row by its mask), and the extremes only when
    masked in — exactly as the reference."""
    v, g, m, c = _rows(G, 2000, G, exact=False, nan_rows=True)
    m[1] = 0.0   # one masked NaN row, one live
    got = _as_np(Tref.block_agg_ref(torch.from_numpy(v),
                                    torch.from_numpy(g),
                                    torch.from_numpy(m), c, num_groups=G))
    want = _as_np(Rref.block_agg_ref(jnp.asarray(v), jnp.asarray(g),
                                     jnp.asarray(m), c, num_groups=G))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    assert np.isnan(got[0]).any()


def test_index_add_row_order_bitwise_large():
    """The ROADMAP probe: CPU ``index_add_`` equals JAX ``.at[].add`` bit
    for bit on a 100k-row, 8-group general-data fold."""
    rng = np.random.default_rng(11)
    n, G = 100_000, 8
    v = rng.normal(870.0, 300.0, n).astype(np.float32)
    g = rng.integers(0, G, n).astype(np.int32)
    m = (rng.random(n) < 0.9).astype(np.float32)
    got = _as_np(Tref.block_agg_ref(torch.from_numpy(v),
                                    torch.from_numpy(g),
                                    torch.from_numpy(m), 870.0,
                                    num_groups=G))
    want = _as_np(Rref.block_agg_ref(jnp.asarray(v), jnp.asarray(g),
                                     jnp.asarray(m), 870.0, num_groups=G))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))


def test_grouped_moments_matches_reference():
    v, g, m, c = _rows(3, 4096, 120, exact=False, nan_rows=False)
    got = Tops.grouped_moments(torch.from_numpy(v), torch.from_numpy(g),
                               torch.from_numpy(m), 120, 30.0)
    want = Rops.grouped_moments(jnp.asarray(v), jnp.asarray(g),
                                jnp.asarray(m), 120, 30.0, impl="ref")
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_grouped_sums_block_selection_equals_gathered_rows():
    """Slabs + (blk, tvalid) fold exactly the rows the reference gathers
    (padding lanes fold with mask 0)."""
    rng = np.random.default_rng(4)
    nb, br, G = 50, 64, 9
    v = rng.integers(0, 17, (nb, br)).astype(np.float32)
    g = rng.integers(0, G, (nb, br)).astype(np.int32)
    m = (rng.random((nb, br)) < 0.8).astype(np.float32)
    blk = np.array([7, 3, 41, 0, 0], np.int32)
    tvalid = np.array([1, 1, 1, 0, 0], bool)
    got = _as_np(Tops.grouped_sums(
        *(torch.from_numpy(a) for a in (v, g, m)), G, 8.0,
        blk=torch.from_numpy(blk), tvalid=torch.from_numpy(tvalid)))
    mm = m[blk] * tvalid[:, None].astype(np.float32)
    want = _as_np(Rref.block_agg_ref(jnp.asarray(v[blk].reshape(-1)),
                                     jnp.asarray(g[blk].reshape(-1)),
                                     jnp.asarray(mm.reshape(-1)), 8.0,
                                     num_groups=G))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def _words(seed, nb, W, density):
    rng = np.random.default_rng(seed)
    bits = (np.uint64(1) << rng.integers(0, 32, (nb, W)).astype(np.uint64))
    return np.where(rng.random((nb, W)) < density, bits.astype(np.uint32),
                    np.uint32(0))


@pytest.mark.parametrize("W", [1, 7, 33, 320])
def test_active_blocks_ref_matches_reference(W):
    words = _words(W, 777, W, 0.05)
    rng = np.random.default_rng(W + 1)
    cases = [rng.integers(0, 2**32, W, dtype=np.uint64).astype(np.uint32),
             np.full(W, 0xFFFFFFFF, np.uint32),      # all active
             np.zeros(W, np.uint32)]                 # none active
    for act in cases:
        got = Tops.active_blocks(torch.from_numpy(words.view(np.int32)),
                                 torch.from_numpy(act.view(np.int32)))
        want = Rops.active_blocks(jnp.asarray(words), jnp.asarray(act),
                                  impl="ref")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        pal = Rref.active_blocks_ref(jnp.asarray(words), jnp.asarray(act))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(pal).reshape(-1))
    all_on = Tops.active_blocks(torch.from_numpy(words.view(np.int32)),
                                torch.from_numpy(cases[1].view(np.int32)))
    assert np.array_equal(all_on.numpy(), (words != 0).any(1))
    assert int(Tops.active_blocks(torch.from_numpy(words.view(np.int32)),
                                  torch.from_numpy(cases[2].view(np.int32))
                                  ).sum()) == 0


def test_active_blocks_window_rows():
    words = _words(5, 300, 4, 0.3)
    win = np.random.default_rng(6).integers(0, 300, 128).astype(np.int32)
    act = np.array([0x00FF00FF, 0, 0x80000000, 1], np.uint32)
    got = Tops.active_blocks(torch.from_numpy(words.view(np.int32)),
                             torch.from_numpy(act.view(np.int32)),
                             win=torch.from_numpy(win))
    want = Rops.active_blocks(jnp.asarray(words[win]), jnp.asarray(act),
                              impl="interpret", block_tile=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
