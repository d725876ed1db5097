"""The histogram fold on the CPU: the port's plain versions
``grouped_hist_ref`` and ``fused_fold_ref`` (and ``ops``, which picks
them for CPU tensors) against the JAX package's oracle
``repro.kernels.ref.grouped_hist_ref`` / ``ops.grouped_hist(impl='ref')``
and against its Pallas ``fused_fold`` under the interpreter.

Inputs hold a value on every bin edge of the grid and on both of its
float32 neighbours, values below and above the range, NaN and +-inf, and
masked rows (with any of those values). Histograms are compared bit for
bit: bins are computed in float32 exactly as the reference computes them
and every count is a whole number. Moments of the fused fold equal the
port's ``block_agg_ref`` bit for bit and the Pallas kernel (another
summation order) to ``tests/test_fused_scan.py``'s tolerances."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import fused_scan as Rfs
from repro.kernels import ops as Rops
from repro.kernels import ref as Rref

from repro_torch.kernels import ops as Tops
from repro_torch.kernels import ref as Tref

A, B = -60.0, 1800.0    # FLIGHTS dep_delay's catalog range


def _edge_values(a, b, nbins, rng, n_random, poison):
    """Every bin edge of the float32 grid and its two float32 neighbours,
    uniform values 10 % beyond both ends, and (``poison``) NaN, +inf and
    -inf, shuffled."""
    inv_width = np.float32(nbins / max(b - a, 1e-30))
    edges = (np.arange(nbins + 1, dtype=np.float32) / inv_width
             + np.float32(a)).astype(np.float32)
    pad = 0.1 * (b - a)
    parts = [edges, np.nextafter(edges, np.float32(np.inf)),
             np.nextafter(edges, np.float32(-np.inf)),
             rng.uniform(a - pad, b + pad, n_random).astype(np.float32)]
    if poison:
        parts.append(np.array([np.nan, np.inf, -np.inf] * 4, np.float32))
    v = np.concatenate(parts)
    return v[rng.permutation(len(v))]


def _rows(seed, G, nbins, poison=True, n_random=3000):
    rng = np.random.default_rng(seed)
    v = _edge_values(A, B, nbins, rng, n_random, poison)
    n = len(v)
    g = rng.integers(0, G, n).astype(np.int32)
    m = (rng.random(n) < 0.75).astype(np.float32)
    return v, g, m


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("nbins", [100, 256, 1024])
@pytest.mark.parametrize("G", [1, 7, 14, 130, 300])
def test_grouped_hist_ref_bitwise_equals_reference(G, nbins):
    v, g, m = _rows(G * 7 + nbins, G, nbins)
    want = np.asarray(Rref.grouped_hist_ref(
        jnp.asarray(v), jnp.asarray(g), jnp.asarray(m), A, B,
        num_groups=G, nbins=nbins))
    got = Tref.grouped_hist_ref(_t(v), _t(g), _t(m), A, B, num_groups=G,
                                nbins=nbins)
    assert got.dtype == torch.float32 and got.shape == (G, nbins)
    np.testing.assert_array_equal(got.numpy(), want)
    # every masked row is counted once, NaN and +-inf included
    assert got.sum().item() == m.sum()
    # ops on CPU tensors is the plain version; the reference's ops too
    via_ops = Tops.grouped_hist(_t(v), _t(g), _t(m), G, A, B, nbins=nbins)
    np.testing.assert_array_equal(via_ops.hist.numpy(), want)
    ref_ops = Rops.grouped_hist(jnp.asarray(v), jnp.asarray(g),
                                jnp.asarray(m), G, A, B, nbins=nbins,
                                impl="ref")
    np.testing.assert_array_equal(np.asarray(ref_ops.hist), want)


def test_hist_bins_ref_edges_nan_and_inf():
    """Each float32 bin edge opens its bin, the value just below it stays
    in the bin before; NaN and -inf go to bin 0, +inf to the last bin."""
    nbins = 100
    inv_width = np.float32(nbins / (B - A))
    bins = Tref.hist_bins_ref(
        _t(np.array([np.nan, -np.inf, np.inf, A - 1.0, B + 1.0],
                    np.float32)), A, B, nbins)
    assert bins.tolist() == [0, 0, nbins - 1, 0, nbins - 1]
    edges = (np.arange(nbins, dtype=np.float32) / inv_width
             + np.float32(A)).astype(np.float32)
    got = Tref.hist_bins_ref(_t(edges), A, B, nbins).numpy()
    # the bin of an edge is where float32 arithmetic puts it: compare the
    # reference's own formula, value by value
    want = np.clip((edges - np.float32(A)) * inv_width, 0.0,
                   nbins - 1.0).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def _slabs(seed, G, nbins, poison, block_rows=256):
    """The rows of :func:`_rows` as ``(nb, block_rows)`` slabs, with a
    selection that skips and reorders blocks and ends in two padding
    lanes (block 0, ``tvalid`` False)."""
    v, g, m = _rows(seed, G, nbins, poison)
    nb = -(-len(v) // block_rows)
    pad = nb * block_rows - len(v)
    v = np.concatenate([v, np.zeros(pad, np.float32)]).reshape(nb, -1)
    g = np.concatenate([g, np.zeros(pad, np.int32)]).reshape(nb, -1)
    m = np.concatenate([m, np.zeros(pad, np.float32)]).reshape(nb, -1)
    rng = np.random.default_rng(seed + 1)
    blk = np.concatenate([rng.permutation(nb)[: nb - 1], [0, 0]]).astype(
        np.int32)
    tvalid = np.ones(len(blk), np.int32)
    tvalid[-2:] = 0
    return v, g, m, blk, tvalid


def _gathered(v, g, m, blk, tvalid):
    """The selected rows, flat, with padding lanes masked out: what the
    reference's fused round folds."""
    return (v[blk].reshape(-1), g[blk].reshape(-1),
            (m[blk] * tvalid[:, None].astype(np.float32)).reshape(-1))


@pytest.mark.parametrize("nbins", [100, 256, 1024])
@pytest.mark.parametrize("G", [1, 7, 130, 300])
def test_fused_fold_ref_bitwise_equals_parts(G, nbins):
    """fused_fold_ref = block_agg_blocks_ref's moments + the reference
    oracle's histogram of the same selected rows, bit for bit."""
    v, g, m, blk, tvalid = _slabs(G + nbins, G, nbins, poison=True)
    center = 0.5 * (A + B)
    got = Tops.grouped_fold_hist(_t(v), _t(g), _t(m), G, center, A, B,
                                 nbins, blk=_t(blk), tvalid=_t(tvalid))
    want_mom = Tref.block_agg_blocks_ref(_t(v), _t(g), _t(m), _t(blk),
                                         _t(tvalid), center, num_groups=G)
    for x, y in zip(got[:3], want_mom):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    fv, fg, fm = _gathered(v, g, m, blk, tvalid)
    want_h = np.asarray(Rref.grouped_hist_ref(
        jnp.asarray(fv), jnp.asarray(fg), jnp.asarray(fm), A, B,
        num_groups=G, nbins=nbins))
    np.testing.assert_array_equal(got[3].numpy(), want_h)
    assert got[3].sum().item() == fm.sum()


@pytest.mark.parametrize("nbins", [256, 1024])
@pytest.mark.parametrize("G", [1, 7, 130, 300])
def test_fused_fold_ref_matches_pallas_interpret(G, nbins):
    """Against the TPU kernel under the interpreter, where its padded bin
    count equals the logical one (``nbins % 128 == 0``): the histogram
    exactly, the moments to test_fused_scan's tolerances (the kernel
    sums by one-hot matmul tiles). Finite values only: the one-hot
    matmul spreads a NaN row to every group of its tile."""
    v, g, m, blk, tvalid = _slabs(G * 3 + nbins, G, nbins, poison=False)
    center = 0.5 * (A + B)
    fv, fg, fm = _gathered(v, g, m, blk, tvalid)
    n = len(fv)
    rpad = (-n) % Rfs.ROW_TILE
    gpad = -(-G // Rfs.GROUP_TILE) * Rfs.GROUP_TILE
    pv, pg, pm = (np.concatenate([x, np.zeros(rpad, x.dtype)])
                  for x in (fv, fg, fm))
    sums, vmin, vmax, hist = Rfs.fused_fold(
        jnp.asarray(pv), jnp.asarray(pg), jnp.asarray(pm),
        jnp.float32(center), a=A, b=B, num_groups=gpad, nbins=nbins,
        interpret=True)
    got = Tops.grouped_fold_hist(_t(v), _t(g), _t(m), G, center, A, B,
                                 nbins, blk=_t(blk), tvalid=_t(tvalid))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(hist)[:G])
    want = Rops.moments_from_sums(sums[:, :G], vmin[:, :G], vmax[:, :G],
                                  center)
    mine = Tops.moments_from_sums(*got[:3], center)
    for x, y, tol in zip(mine, want, [1e-6, 1e-4, 5e-2, 1e-6, 1e-6]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y).reshape(-1),
                                   rtol=tol, atol=tol)


def test_logical_bin_contract_at_100_bins():
    """At ``nbins = 100`` (not a multiple of 128) the port bins on the
    logical 100-bin grid, as the reference's ``ref`` path does, and keeps
    every row. (The reference's Pallas fused fold computes its grid from
    the padded 128 bins and loses the top bins' rows there; the port does
    not copy that.)"""
    rng = np.random.default_rng(5)
    n, G, nbins = 2048, 3, 100
    v = rng.uniform(0.0, 100.0, n).astype(np.float32)
    g = rng.integers(0, G, n).astype(np.int32)
    m = np.ones(n, np.float32)
    a, b = 0.0, 100.0
    _, _, _, want = Rfs._fold_local(jnp.asarray(v), jnp.asarray(g),
                                    jnp.asarray(m), 50.0, a, b, G, nbins,
                                    True, "ref")
    slab = lambda x: _t(x.reshape(2, -1))
    lanes = _t(np.arange(2, dtype=np.int32))
    got = Tops.grouped_fold_hist(slab(v), slab(g), slab(m), G, 50.0, a, b,
                                 nbins, blk=lanes, tvalid=lanes * 0 + 1)[3]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum().item() == n
    # the top bin holds the rows of [99, 100): on the 128-bin grid they
    # would land in bins 126..127 and be sliced off
    top = ((v >= 99.0) & (v < 100.0)).sum()
    assert top > 0 and got[:, nbins - 1].sum().item() == top
