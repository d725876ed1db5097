"""Card-only checks of the port's CUDA kernels against their plain
PyTorch versions, and of the engine on the card against the engine on the
CPU. Marked ``cuda``; each test skips when no CUDA device is present.
This file imports nothing of JAX, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
        -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)
"""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.aqp import (AggQuery, EngineConfig, FastFrame, Filter,
                             build_scramble)
from repro_torch.aqp import flights_queries as fq
from repro_torch.core.optstop import ThresholdSide
from repro_torch.data import flights
from repro_torch.configs import get as get_config
from repro_torch.kernels import (_build, bitmap_active, block_agg,
                                 fused_fold, fused_scan, grouped_hist, ops,
                                 ref, selective_scan)
from repro_torch.models import build as build_model

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


def _slabs(seed, nb, br, G, exact):
    """Value / group / mask slabs; exact data keeps every partial sum an
    integer below 2**24. General data carries a NaN and an inf row."""
    rng = np.random.default_rng(seed)
    if exact:
        v = rng.integers(0, 17, (nb, br)).astype(np.float32)
    else:
        v = rng.normal(40.0, 25.0, (nb, br)).astype(np.float32)
        v[3, 5] = np.nan
        v[7, 1] = np.inf
    g = rng.integers(0, G, (nb, br)).astype(np.int32)
    m = (rng.random((nb, br)) < 0.8).astype(np.float32)
    return [torch.from_numpy(x) for x in (v, g, m)]


def _lanes(seed, nb, budget, n_pad):
    rng = np.random.default_rng(seed)
    blk = rng.choice(nb, budget, replace=False).astype(np.int32)
    tvalid = np.ones(budget, np.int32)
    blk[budget - n_pad:] = 0   # padding lanes point at block 0, invalid
    tvalid[budget - n_pad:] = 0
    return torch.from_numpy(blk), torch.from_numpy(tvalid)


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())


def _cursor(pos, dev="cpu", go=True):
    """The round head's device cursor and ``go`` flag."""
    return (torch.tensor(pos, dtype=torch.int64, device=dev),
            torch.tensor(go, device=dev))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("G", [1, 7, 130, 300, 2800, 10240])
def test_block_agg_bitwise_equals_plain(cuda, G, exact):
    """Row-order folding: the kernel equals the CPU plain version bit for
    bit on all data (NaN / inf rows included), and repeats its bits."""
    nb, br, center = 120, 700, 8.0   # 700 rows: blocks straddle tiles
    v, g, m = _slabs(G, nb, br, G, exact)
    blk, tvalid = _lanes(G + 1, nb, 40, 5)
    want = ops.grouped_sums(v, g, m, G, center, blk=blk, tvalid=tvalid)
    args = [t.to(cuda) for t in (v, g, m)]
    got = ops.grouped_sums(*args, G, center, blk=blk.to(cuda),
                           tvalid=tvalid.to(cuda))
    again = ops.grouped_sums(*args, G, center, blk=blk.to(cuda),
                             tvalid=tvalid.to(cuda))
    torch.cuda.synchronize()
    _same(got, want)
    for x, y in zip(got, again):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("cells,G", [(1, 13), (91, 13), (130, 2000)])
def test_block_agg_chunked_equals_plain(cuda, monkeypatch, cells, G):
    """A small start table forces the fold into chunks of lanes (warp
    mode at G 13: two lanes a chunk at ``cells=1``, 17 at 91; lane mode
    at G 2000: five); each walk continues the last one's sums, so the
    bits are those of one row-order pass."""
    monkeypatch.setattr(block_agg, "TABLE_CELLS", cells)
    nb, br, center = 60, 700, 870.0
    assert block_agg.plan(24, br, G)[0] < 24
    v, g, m = _slabs(cells, nb, br, G, False)
    blk, tvalid = _lanes(cells + 1, nb, 24, 3)
    want = ops.grouped_sums(v, g, m, G, center, blk=blk, tvalid=tvalid)
    got = ops.grouped_sums(*(t.to(cuda) for t in (v, g, m)), G, center,
                           blk=blk.to(cuda), tvalid=tvalid.to(cuda))
    _same(got, want)


def test_block_agg_all_blocks_and_launch_count(cuda):
    v, g, m = _slabs(5, 30, 64, 9, True)
    before = block_agg.block_agg.launches
    got = ops.grouped_moments(*(t.to(cuda) for t in (v, g, m)), 9, 8.0)
    assert block_agg.block_agg.launches == before + 1
    _same(got, ops.grouped_moments(v, g, m, 9, 8.0))


def test_block_agg_rejects_bad_input(cuda):
    v, g, m = (t.to(cuda) for t in _slabs(0, 4, 8, 3, True))
    blk = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        block_agg.block_agg(v, g.to(torch.int64), m, blk, blk, 0.0, 3)
    with pytest.raises(ValueError):
        block_agg.block_agg(v.cpu(), g.cpu(), m.cpu(), blk.cpu(),
                            blk.cpu(), 0.0, 3)


def _skewed_slabs(seed, nb, br, G):
    """General data (NaN, inf and masked inf rows) whose groups follow a
    Zipf law: at G 2800 over 64 x 1024 rows a few groups hold hundreds
    of rows and most a handful, so both of the walk's modes run."""
    rng = np.random.default_rng(seed)
    v = rng.normal(40.0, 25.0, (nb, br)).astype(np.float32)
    g = ((rng.zipf(1.3, (nb, br)) - 1) % G).astype(np.int32)
    m = (rng.random((nb, br)) < 0.8).astype(np.float32)
    return [torch.from_numpy(x) for x in (v, g, m)]


def _poison_block0(v, m):
    """NaN, +-inf and huge rows at the head of block 0; a masked inf
    poisons its group's sums as in the plain version."""
    v[0, :7] = torch.tensor([np.nan, np.inf, -np.inf, np.nan, np.inf, 1e30,
                             -1e30])
    m[0, 1] = 0.0


@pytest.mark.parametrize("kernel", ["block_agg", "fused_fold"])
@pytest.mark.parametrize("G,skewed", [(1, False), (200, True),
                                      (2800, False), (2800, True)])
def test_fold_walk_modes_bitwise_equal_plain(cuda, kernel, G, skewed):
    """At the main path's 64 blocks of 1024 rows: warp mode (G 1, G 200)
    and lane mode (G 2800), with groups on both sides of the lane /
    warp threshold when skewed; bit for bit the CPU plain version, the
    same bits run to run, and fused_fold's moments block_agg's."""
    nb, br, budget, center = 96, 1024, 64, 40.0
    v, g, m = (_skewed_slabs(G, nb, br, G) if skewed
               else _slabs(G, nb, br, G, False))
    _poison_block0(v, m)
    blk, tvalid = _lanes(G + 2, nb, budget, 3)
    blk[0] = 0                          # the poisoned block is selected
    sizes = np.bincount(g[blk.long()].reshape(-1).numpy(), minlength=G)
    lane_mode = block_agg.plan(budget, br, G)[1]
    assert lane_mode == (G == 2800)
    if skewed and lane_mode:
        assert sizes.max() > 64 >= sizes.min()
    args = [t.to(cuda) for t in (v, g, m)]
    kw = dict(blk=blk.to(cuda), tvalid=tvalid.to(cuda))
    if kernel == "block_agg":
        want = ops.grouped_sums(v, g, m, G, center, blk=blk, tvalid=tvalid)
        run = lambda: ops.grouped_sums(*args, G, center, **kw)  # noqa: E731
    else:
        want = ops.grouped_fold_hist(v, g, m, G, center, -20.0, 100.0, 1024,
                                     blk=blk, tvalid=tvalid)
        run = lambda: ops.grouped_fold_hist(  # noqa: E731
            *args, G, center, -20.0, 100.0, 1024, **kw)
    got, again = run(), run()
    moments = ops.grouped_sums(*args, G, center, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isnan(want[0]).any())
    _same(got, want)
    for x, y in zip(got, again):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    for x, y in zip(got[:3], moments):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def _hist_rows(seed, n, G, a, b, nbins):
    """Flat rows for the histogram: uniform values 10 % beyond both ends
    of the grid, every float32 bin edge and its two neighbours, NaN and
    +-inf; a 0 / 1 mask (masked rows hold any of those values)."""
    rng = np.random.default_rng(seed)
    inv_width = np.float32(nbins / (b - a))
    edges = (np.arange(nbins + 1, dtype=np.float32) / inv_width
             + np.float32(a)).astype(np.float32)
    special = np.concatenate([
        edges, np.nextafter(edges, np.float32(np.inf)),
        np.nextafter(edges, np.float32(-np.inf)),
        np.array([np.nan, np.inf, -np.inf] * 8, np.float32)])
    pad = 0.1 * (b - a)
    v = rng.uniform(a - pad, b + pad, n).astype(np.float32)
    v[rng.choice(n, len(special), replace=False)] = special
    g = rng.integers(0, G, n).astype(np.int32)
    m = (rng.random(n) < 0.8).astype(np.float32)
    return [torch.from_numpy(x) for x in (v, g, m)]


@pytest.mark.parametrize("nbins", [100, 1024, 4096])
@pytest.mark.parametrize("G", [1, 7, 14, 56, 57, 130, 200, 300, 800, 2800,
                               10240])
def test_grouped_hist_bitwise_equals_plain(cuda, G, nbins):
    """Integer counts: the kernel equals the CPU plain version bit for bit
    (private copies of every cell up to 57,344 cells, buckets of cells
    above: each side of that threshold at every bin count, and buckets of
    partial, whole and many histogram rows), repeats its bits and counts
    each launch."""
    a, b = -60.0, 1800.0
    v, g, m = _hist_rows(G + nbins, 200_003, G, a, b, nbins)
    want = ops.grouped_hist(v, g, m, G, a, b, nbins=nbins).hist
    args = [t.to(cuda) for t in (v, g, m)]
    before = grouped_hist.grouped_hist.launches
    got = ops.grouped_hist(*args, G, a, b, nbins=nbins).hist
    again = ops.grouped_hist(*args, G, a, b, nbins=nbins).hist
    torch.cuda.synchronize()
    assert grouped_hist.grouped_hist.launches == before + 2
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)
    assert got.sum().item() == m.sum().item()
    assert grouped_hist.plan(len(v), G, nbins).regime == (
        "private" if G * nbins <= grouped_hist.MAX_CELLS else "bucketed")


def _grouped_hist_plan(n, G, nbins):
    """The kernel library's plan of a call on this card (with the private
    CTAs it holds at once), as :class:`grouped_hist.HistPlan`."""
    out = (ctypes.c_longlong * 8)()
    resident = _build.library().repro_grouped_hist_resident(0)
    _build.library().repro_grouped_hist_plan(n, G, nbins, resident, out)
    return grouped_hist.HistPlan(
        ("private", "bucketed")[out[0]], *out[1:]), resident


def _hist_check(v, g, m, G, nbins, a=-60.0, b=1800.0, cuda="cuda"):
    """The kernel on the card against the plain version on the CPU (bit
    for bit), twice (the same bits), counting every row with m != 0 and
    a group in [0, G) (the plain version is given those rows alone: its
    index_add_ refuses a group outside the histogram)."""
    inside = (g >= 0) & (g < G)
    want = ops.grouped_hist(v[inside], g[inside], m[inside], G, a, b,
                            nbins=nbins).hist
    args = [t.to(cuda) for t in (v, g, m)]
    got = ops.grouped_hist(*args, G, a, b, nbins=nbins).hist
    again = ops.grouped_hist(*args, G, a, b, nbins=nbins).hist
    torch.cuda.synchronize()
    assert got.shape == (G, nbins) and got.dtype == torch.float32
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert got.sum().item() == (inside & (m != 0)).sum().item()
    return got


@pytest.mark.parametrize("n,G,nbins", [
    (n, G, nbins) for n in (0, 1, 200_003, 1 << 20)
    for G in (1, 14, 56, 57, 200, 2800, 10240) for nbins in (100, 1024,
                                                            4096)])
def test_grouped_hist_plan_mirror(cuda, n, G, nbins):
    """The compiled plan is grouped_hist.plan, at the private CTAs this
    card holds at once: one an SM, 132 on an H100 (the grid barrier
    needs them all resident)."""
    got, resident = _grouped_hist_plan(n, G, nbins)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert 0 < resident <= sms
    if "H100" in torch.cuda.get_device_name(0):
        assert resident == grouped_hist.H100_SMS
    assert got == grouped_hist.plan(n, G, nbins, resident=resident)


@pytest.mark.parametrize("G", [14, 2800])
@pytest.mark.parametrize("n", [0, 1, 4097, 200_003, 1 << 20])
def test_grouped_hist_row_counts(cuda, n, G):
    """No rows (every cell written as 0), one row, a ragged stage, and
    the engine's largest call (1,048,576 rows), in both regimes."""
    rng = np.random.default_rng(n + G)
    v = rng.normal(40.0, 25.0, n).astype(np.float32)
    g = rng.integers(0, G, n).astype(np.int32)
    m = (rng.random(n) < 0.8).astype(np.float32)
    got = _hist_check(*(torch.from_numpy(x) for x in (v, g, m)), G, 1024)
    if n == 0:
        assert not got.any()


def _flights_rows(n, G):
    """dep_delay of synthetic FLIGHTS rows, grouped by airline (G 14, the
    exact sweep's F-q2) or by (origin, airline) (G 2800): most rows in a
    few dozen bins of [-60, 1800] and Zipf-skewed groups."""
    from repro_torch.data import flights as fl
    ds = fl.generate(n_rows=n, seed=3)
    c = ds.columns
    gid = c["airline"] if G == 14 else (c["origin"].astype(np.int64) * 14
                                        + c["airline"])
    return c["dep_delay"].astype(np.float32), gid.astype(np.int32)


@pytest.mark.parametrize("G", [14, 2800])
@pytest.mark.parametrize("scenario", ["all_masked", "one_cell", "flights",
                                      "groups_out_of_range"])
def test_grouped_hist_skewed_data(cuda, scenario, G):
    """Every row masked (an all-zero histogram); every row in one cell
    (one counter takes 200,003 adds); dep_delay-like skew; gids outside
    [0, G), which count nowhere: bit for bit the CPU plain version."""
    n = 200_003
    rng = np.random.default_rng(len(scenario) + G)
    v = rng.normal(40.0, 25.0, n).astype(np.float32)
    g = rng.integers(0, G, n).astype(np.int32)
    m = np.ones(n, np.float32)
    if scenario == "all_masked":
        m[:] = 0.0
    elif scenario == "one_cell":
        v[:], g[:] = 12.5, G // 2
    elif scenario == "flights":
        v, g = _flights_rows(n, G)
        m = (rng.random(n) < 0.9).astype(np.float32)
    else:  # outside [0, G): counted nowhere
        g[::7] = -1
        g[3::7] = G
    got = _hist_check(*(torch.from_numpy(x) for x in (v, g, m)), G, 1024)
    if scenario == "one_cell":
        assert got[G // 2].max().item() == n


def test_grouped_hist_misaligned_inputs(cuda):
    """Inputs that start 4 bytes past a 16-byte boundary take the scalar
    loads: the same bits as aligned copies of the same rows."""
    G, nbins, n = 14, 1024, 200_003
    v, g, m = _hist_rows(9, n + 1, G, -60.0, 1800.0, nbins)
    dv, dg, dm = (t.to(cuda) for t in (v, g, m))
    off = [t[1:] for t in (dv, dg, dm)]
    assert all(t.data_ptr() % 16 == 4 for t in off)
    got = ops.grouped_hist(*off, G, -60.0, 1800.0, nbins=nbins).hist
    want = ops.grouped_hist(*(t[1:].clone() for t in (v, g, m)), G, -60.0,
                            1800.0, nbins=nbins).hist
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("G,kernels", [
    (14, ["hist_private_kernel"]), (56, ["hist_private_kernel"]),
    (57, ["hist_sort_kernel", "hist_bucket_kernel"]),
    (2800, ["hist_sort_kernel", "hist_bucket_kernel"])])
def test_grouped_hist_launches(cuda, G, kernels):
    """One call is one launch (private) or two (bucketed): no memset
    before it, no float pass after it."""
    v, g, m = (t.to(cuda) for t in _hist_rows(G, 1 << 20, G, -60.0, 1800.0,
                                               1024))
    run = lambda: grouped_hist.grouped_hist(  # noqa: E731
        v, g, m, -60.0, 1800.0, G, 1024)
    run()
    names = _cuda_events(run)
    assert len(names) == len(kernels) <= 2, names
    for name, kernel in zip(names, kernels):
        assert kernel in name, names


@pytest.mark.parametrize("G", [14, 2800])
def test_grouped_hist_replays_in_a_cuda_graph(cuda, G):
    """Captured once in a CUDA graph and replayed with the rows changed in
    place: each replay is the plain version of its own rows (the private
    regime's counters and ticket return to zero on the card, the
    bucketed regime's scratch is rewritten every call)."""
    n, nbins = 200_003, 1024
    rows = [_hist_rows(G + i, n, G, -60.0, 1800.0, nbins) for i in range(3)]
    d = [t.to(cuda) for t in rows[0]]
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):  # the counters' buffer, before capture
        ops.grouped_hist(*d, G, -60.0, 1800.0, nbins=nbins)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = ops.grouped_hist(*d, G, -60.0, 1800.0, nbins=nbins).hist
    for r in rows + rows[::-1]:
        for x, y in zip(d, r):
            x.copy_(y)
        graph.replay()
        torch.cuda.synchronize()
        want = ops.grouped_hist(*r, G, -60.0, 1800.0, nbins=nbins).hist
        assert torch.equal(out.cpu(), want)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("G", [1, 7, 300, 2800, 10240])
def test_fused_fold_bitwise_equals_plain(cuda, G, exact):
    """The fused fold's moments are block_agg's bits; its histogram is the
    CPU plain version's bits, run after run."""
    nb, br, center, nbins = 120, 700, 8.0, 1024
    v, g, m = _slabs(G, nb, br, G, exact)
    blk, tvalid = _lanes(G + 1, nb, 40, 5)
    a, b = (0.0, 16.0) if exact else (-20.0, 100.0)
    want = ops.grouped_fold_hist(v, g, m, G, center, a, b, nbins, blk=blk,
                                 tvalid=tvalid)
    args = [t.to(cuda) for t in (v, g, m)]
    kw = dict(blk=blk.to(cuda), tvalid=tvalid.to(cuda))
    before = fused_fold.fused_fold.launches
    got = ops.grouped_fold_hist(*args, G, center, a, b, nbins, **kw)
    again = ops.grouped_fold_hist(*args, G, center, a, b, nbins, **kw)
    moments = ops.grouped_sums(*args, G, center, **kw)
    torch.cuda.synchronize()
    assert fused_fold.fused_fold.launches == before + 2
    _same(got, want)
    for x, y in zip(got, again):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    for x, y in zip(got[:3], moments):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_fused_fold_chunked_equals_plain(cuda, monkeypatch):
    """Folded in chunks of lanes (a small run table), the histogram still
    counts every row once."""
    monkeypatch.setattr(block_agg, "TABLE_CELLS", 91)
    nb, br, G, center, nbins = 60, 700, 13, 870.0, 100
    v, g, m = _slabs(3, nb, br, G, False)
    blk, tvalid = _lanes(4, nb, 24, 3)
    want = ops.grouped_fold_hist(v, g, m, G, center, -20.0, 100.0, nbins,
                                 blk=blk, tvalid=tvalid)
    got = ops.grouped_fold_hist(*(t.to(cuda) for t in (v, g, m)), G,
                                center, -20.0, 100.0, nbins,
                                blk=blk.to(cuda), tvalid=tvalid.to(cuda))
    _same(got, want)



def _cuda_events(fn):
    """Run ``fn`` under ``torch.profiler`` and return the names of the
    device activities it launched (kernels, memsets, copies)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _hist_plan(nbins, lane_mode):
    """The fused walk's histogram plan from the kernel library:
    ``(slice_bins, slices, stride, counter bytes a CTA, the walk's static
    shared bytes, the shared bytes a CTA may take)``."""
    out = (ctypes.c_int * 6)()
    _build.library().repro_fused_fold_plan(nbins, int(lane_mode), out)
    return tuple(out)


@pytest.mark.parametrize("lane_mode", [True, False], ids=["lane", "warp"])
@pytest.mark.parametrize("nbins", [64, 100, 1024, 4096, 16384])
def test_fused_fold_plan_fits_and_covers_every_bin(cuda, nbins, lane_mode):
    """No walk CTA asks for more than 227 KB of shared memory; the slices
    cover every bin once; strides are whole 16-byte words (the write-back
    reads them as uint4); sliced bins are whole float4s of the output."""
    slice_bins, slices, stride, smem, static, per_cta = _hist_plan(
        nbins, lane_mode)
    assert per_cta == 227 * 1024
    assert smem == (32 if lane_mode else 1) * stride * 4
    assert smem + static <= per_cta
    assert slices * slice_bins >= nbins > (slices - 1) * slice_bins
    assert stride >= slice_bins and stride % 4 == 0
    if slices > 1:
        assert slice_bins % 4 == 0
    else:
        assert slice_bins == nbins


def test_fused_fold_plan_main_path_and_slicing(cuda):
    """The engine's default 1024 bins: one slice in both modes, 128 KB of
    counters in lane mode (one CTA an SM), 4 KB in warp mode. At 4096
    bins a lane-mode bucket's 32 rows need three slices; a warp-mode
    group's one row fits whole up to 55,000 bins."""
    assert _hist_plan(1024, True)[1:4:2] == (1, 131_072)
    assert _hist_plan(1024, False)[1:4:2] == (1, 4_096)
    assert _hist_plan(4096, True)[1] == 3
    assert _hist_plan(4096, False)[1] == 1
    assert _hist_plan(55_000, False)[1] == 1
    assert _hist_plan(55_001, False)[1] == 2


@pytest.mark.parametrize("nbins", [64, 100, 1024, 4096])
@pytest.mark.parametrize("G", [1, 200, 2800, 10240])
def test_fused_fold_hist_written_once_bitwise(cuda, G, nbins):
    """The walk owns the histogram: at the main path's 64 blocks of 1024
    rows on skewed data (warp mode at G 1 and 200, lane mode above; at
    4096 bins a lane-mode bucket's rows are cut into bin slices), the
    histogram is the CPU plain version's bits, the same bits run to run,
    and the moments block_agg's."""
    nb, br, budget, center, a, b = 96, 1024, 64, 40.0, -20.0, 100.0
    v, g, m = _skewed_slabs(G + nbins, nb, br, G)
    _poison_block0(v, m)
    blk, tvalid = _lanes(G + 3, nb, budget, 3)
    blk[0] = 0
    lane_mode = bool(block_agg.plan(budget, br, G)[1])
    assert lane_mode == (G >= 2800)
    assert (_hist_plan(nbins, lane_mode)[1] > 1) == (
        lane_mode and nbins == 4096)
    want = ops.grouped_fold_hist(v, g, m, G, center, a, b, nbins, blk=blk,
                                 tvalid=tvalid)
    args = [t.to(cuda) for t in (v, g, m)]
    kw = dict(blk=blk.to(cuda), tvalid=tvalid.to(cuda))
    got = ops.grouped_fold_hist(*args, G, center, a, b, nbins, **kw)
    again = ops.grouped_fold_hist(*args, G, center, a, b, nbins, **kw)
    moments = ops.grouped_sums(*args, G, center, **kw)
    torch.cuda.synchronize()
    _same(got, want)
    assert got[3].sum().item() == want[3].sum().item()
    for x, y in zip(got, again):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    for x, y in zip(got[:3], moments):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("cells,G,nbins", [(91, 13, 4096), (130, 2000, 100),
                                           (130, 2000, 4096)])
def test_fused_fold_chunked_sliced_equals_plain(cuda, monkeypatch, cells, G,
                                                nbins):
    """Lanes folded in chunks (a small run table) in both walk modes, with
    the bins of a lane-mode bucket cut into slices at 4096 bins: each
    later chunk adds its counts to the cells the first wrote."""
    monkeypatch.setattr(block_agg, "TABLE_CELLS", cells)
    nb, br, center = 60, 700, 870.0
    assert block_agg.plan(24, br, G)[0] < 24
    v, g, m = _slabs(cells + nbins, nb, br, G, False)
    blk, tvalid = _lanes(cells + 2, nb, 24, 3)
    want = ops.grouped_fold_hist(v, g, m, G, center, -20.0, 100.0, nbins,
                                 blk=blk, tvalid=tvalid)
    got = ops.grouped_fold_hist(*(t.to(cuda) for t in (v, g, m)), G,
                                center, -20.0, 100.0, nbins,
                                blk=blk.to(cuda), tvalid=tvalid.to(cuda))
    _same(got, want)


@pytest.mark.parametrize("G", [1, 2800])
def test_fused_fold_is_two_launches(cuda, G):
    """One call is the sort and the walk: no memset before it, no float
    pass after it."""
    v, g, m = (t.to(cuda) for t in _slabs(G, 96, 1024, G, False))
    blk, tvalid = (t.to(cuda) for t in _lanes(G + 1, 96, 64, 3))
    run = lambda: fused_fold.fused_fold(  # noqa: E731
        v, g, m, blk, tvalid, 40.0, -20.0, 100.0, G, 1024)
    run()
    names = _cuda_events(run)
    assert len(names) == 2, names
    assert "tile_sort_kernel" in names[0] and "group_walk_kernel" in names[1]


def test_histogram_kernels_reject_bad_input(cuda):
    v, g, m = (t.to(cuda) for t in _slabs(0, 4, 8, 3, True))
    blk = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        fused_fold.fused_fold(v, g, m, blk, blk, 0.0, 0.0, 1.0, 3, 0)
    with pytest.raises(ValueError):
        grouped_hist.grouped_hist(v, g.to(torch.int64), m, 0.0, 1.0, 3, 8)
    with pytest.raises(ValueError):
        grouped_hist.grouped_hist(v[:, :4], g, m, 0.0, 1.0, 3, 8)


@pytest.mark.parametrize("W", [1, 7, 31, 32, 50, 88, 320])
def test_bitmap_active_equals_plain(cuda, W):
    rng = np.random.default_rng(W)
    nb = 5000
    one_bit = (np.uint64(1) << rng.integers(0, 32, (nb, W)).astype(
        np.uint64)).astype(np.uint32)
    words = torch.from_numpy(np.where(rng.random((nb, W)) < 0.02, one_bit,
                                      np.uint32(0)).view(np.int32))
    win = torch.from_numpy(rng.integers(0, nb, 4096).astype(np.int32))
    for active in (rng.integers(-2**31, 2**31, W).astype(np.int32),
                   np.full(W, -1, np.int32), np.zeros(W, np.int32)):
        act = torch.from_numpy(active)
        for w in (win, None):
            want = ops.active_blocks(words, act, win=w)
            got = ops.active_blocks(words.to(cuda), act.to(cuda),
                                    win=None if w is None else w.to(cuda))
            assert torch.equal(got.cpu(), want)



def _head_inputs(seed, nb, W, window, scenario):
    """Scan order (padded), static prefilter and bitmap words for the
    round head: ``(order_pad, static_ok, words, active, pos, probe)``."""
    rng = np.random.default_rng(seed)
    opad = np.zeros(nb + window, np.int32)
    opad[:nb] = rng.permutation(nb)
    static_ok = rng.random(nb) < 0.85
    one_bit = (np.uint64(1) << rng.integers(0, 32, (nb, W)).astype(
        np.uint64)).astype(np.uint32)
    words = np.where(rng.random((nb, W)) < 0.02, one_bit,
                     np.uint32(0)).view(np.int32)
    active = {"random": rng.integers(-2**31, 2**31, W),
              "ones": np.full(W, -1), "zeros": np.zeros(W)}[
        "random" if scenario in ("random", "near_end", "no_probe")
        else scenario].astype(np.int32)
    pos = nb - window // 3 if scenario == "near_end" else int(
        rng.integers(0, nb - window))
    return opad, static_ok, words, active, pos, scenario != "no_probe"


_HEAD_CASES = ([(W, 4096, 64, "random") for W in (1, 7, 31, 32, 50, 88, 320)]
               + [(88, 4096, 64, s) for s in ("near_end", "no_probe",
                                              "ones", "zeros")]
               + [(7, 4096, 1, "random"), (50, 100, 64, "random"),
                  (32, 5000, 2000, "ones"), (320, 9000, 64, "near_end")])


@pytest.mark.parametrize("W,window,budget,scenario", _HEAD_CASES)
def test_round_select_equals_plain(cuda, W, window, budget, scenario):
    """The round head's one launch equals the plain sequence on the CPU
    bit for bit (ok, flags, new_pos, the lanes' blocks and validity),
    and repeats its bits: windows that are not a multiple of 16 or that
    take two passes of the last CTA's scan, a budget of one and a budget
    the window cannot fill, the end of the scan, no probe, and all-ones /
    all-zeros masks."""
    nb = 20_000
    host = _head_inputs(W * 7 + budget, nb, W, window, scenario)
    opad, static_ok, words, active, pos, probe = host
    kw = dict(nb=nb, window=window, budget=budget, probe=probe)
    t = [torch.from_numpy(x) for x in (opad, static_ok, words, active)]
    want = ops.round_select(*t, *_cursor(pos), **kw)
    before = bitmap_active.round_select.launches
    got = ops.round_select(*(x.to(cuda) for x in t), *_cursor(pos, cuda),
                           **kw)
    again = ops.round_select(*(x.to(cuda) for x in t), *_cursor(pos, cuda),
                             **kw)
    torch.cuda.synchronize()
    assert bitmap_active.round_select.launches == before + 2
    for x, y, z in zip(got, want, again):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y) and torch.equal(x, z)


def test_round_select_replays_in_a_cuda_graph(cuda):
    """Captured once in a CUDA graph and replayed with the active mask
    changed in place: the look-back's epoch lives on the card, so every
    replay's lanes and cut are those of its own mask (a tag baked into
    the capture would let a replay read the previous replay's counts)."""
    nb, W, window, budget = 20_000, 88, 4096, 64
    opad, static_ok, words, _, pos, _ = _head_inputs(5, nb, W, window,
                                                     "random")
    rng = np.random.default_rng(6)
    masks = [rng.integers(-2**31, 2**31, W).astype(np.int32),
             np.full(W, -1, np.int32),
             np.where(rng.random(W) < 0.1, -1, 0).astype(np.int32)]
    t = [torch.from_numpy(x) for x in (opad, static_ok, words)]
    d = [x.to(cuda) for x in t]
    act = torch.from_numpy(masks[0]).to(cuda)
    kw = dict(nb=nb, window=window, budget=budget, probe=True)
    cur = _cursor(pos, cuda)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):  # the look-back buffer, before capture
        ops.round_select(*d, act, *cur, **kw)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = ops.round_select(*d, act, *cur, **kw)
    for m in masks + masks[::-1]:
        act.copy_(torch.from_numpy(m))
        graph.replay()
        torch.cuda.synchronize()
        want = ops.round_select(*t, torch.from_numpy(m), *_cursor(pos),
                                **kw)
        for x, y in zip(out, want):
            assert torch.equal(x.cpu(), y)


def test_round_select_on_a_scramble_is_one_launch(cuda):
    """On a FLIGHTS scramble's bitmap, at the start, the middle and the
    end of the scan: the head equals the plain sequence, makes one device
    launch, and none of the plain sequence's cumsum / argmax / scatter
    kernels."""
    ds = flights.generate(n_rows=300_000, n_airports=200, n_airlines=14,
                          seed=9)
    sc = build_scramble(ds.columns, catalog=ds.catalog, seed=3)
    from repro_torch.aqp.bitmap import build_bitmap, pack_mask
    nb, window, budget = sc.n_blocks, 192, 16
    opad = np.zeros(nb + window, np.int32)
    opad[:nb] = np.random.default_rng(1).permutation(nb)
    words = build_bitmap(sc, "origin").words.view(np.int32)
    rng = np.random.default_rng(2)
    host = [opad, rng.random(nb) < 0.9, words,
            pack_mask(rng.random(200) < 0.05).view(np.int32)]
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in host]
    d = [x.to(cuda) for x in t]
    for pos in (0, nb // 2, nb - 40, nb):
        kw = dict(nb=nb, window=window, budget=budget, probe=True)
        want = ops.round_select(*t, *_cursor(pos), **kw)
        got = ops.round_select(*d, *_cursor(pos, cuda), **kw)
        for x, y in zip(got, want):
            assert torch.equal(x.cpu(), y)
    cur = _cursor(5, cuda)
    names = _cuda_events(lambda: ops.round_select(*d, *cur, **kw))
    assert len(names) == 1 and "round_head_kernel" in names[0], names
    names = _cuda_events(lambda: fused_scan.fused_round(
        torch.zeros((nb, 8), device=cuda),
        torch.zeros((nb, 8), dtype=torch.int32, device=cuda),
        torch.ones((nb, 8), device=cuda), d[2], d[0], d[1], cur[0], d[3],
        go=cur[1], nb=nb, window=window, budget=budget, center=0.0, a=0.0,
        b=1.0, num_groups=200, nbins=64, use_hist=False, probe=True))
    low = " ".join(names).lower()
    assert not any(k in low for k in ("cumsum", "scan", "argmax",
                                      "scatter")), names


def test_fused_round_cuda_equals_cpu(cuda):
    ds = flights.generate(n_rows=150_000, n_airports=60, n_airlines=8,
                          seed=2)
    sc = build_scramble(ds.columns, catalog=ds.catalog, block_rows=256,
                        seed=3)
    nb, window, budget = sc.n_blocks, 128, 16
    order = (17 + np.arange(nb)) % nb
    opad = np.zeros(nb + window, np.int32)
    opad[:nb] = order
    from repro_torch.aqp.bitmap import build_bitmap, pack_mask
    words = build_bitmap(sc, "origin").words.view(np.int32)
    rng = np.random.default_rng(0)
    active = pack_mask(rng.random(60) < 0.1).view(np.int32)
    host = dict(values=sc.columns["dep_delay"].astype(np.float32),
                gids=sc.columns["origin"].astype(np.int32),
                mask=sc.valid.astype(np.float32), words=words,
                order_pad=opad, static_ok=rng.random(nb) < 0.9)
    outs = []
    for dev in ("cpu", cuda):
        t = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for k, a in host.items()}
        outs.append([fused_scan.fused_round(
            t["values"], t["gids"], t["mask"], t["words"], t["order_pad"],
            t["static_ok"], _cursor(pos, dev)[0],
            torch.from_numpy(active).to(dev), go=_cursor(pos, dev)[1],
            nb=nb, window=window, budget=budget, center=870.0, a=-60.0,
            b=1800.0, num_groups=60, nbins=1024, use_hist=use_hist,
            probe=True)
            for pos in (0, 300, nb - 50) for use_hist in (False, True)])
    for (s0, h0, ok0, f0, p0), (s1, h1, ok1, f1, p1) in zip(*outs):
        assert int(p0) == int(p1)
        assert torch.equal(ok0, ok1.cpu()) and torch.equal(f0, f1.cpu())
        _same(s1, s0)
        assert (h0 is None) == (h1 is None)
        if h0 is not None:
            assert torch.equal(h1.cpu(), h0)


_ENGINE_CASES = [("F-q1", "active_peek", True), ("F-q3", "active_peek", True),
                 ("F-q5", "active_peek", True), ("F-q6", "active_peek", True),
                 ("F-q5", "active_sync", True), ("F-q6", "scan", True),
                 ("F-q2", "exact", True), ("F-q8", "active_peek", False),
                 ("F-q2-adkw", "active_peek", True),
                 ("F-q5-adkw", "active_peek", True),
                 ("F-q2-adkw", "exact", True),
                 ("F-q5-adkw", "active_peek", False)]


@pytest.mark.parametrize("name,sampling,fused", _ENGINE_CASES)
def test_engine_cuda_equals_cpu(cuda, name, sampling, fused):
    """Every sampling mode and the per-block path (host-materialized
    folds on the card) give the CPU run's bits, with the Bernstein and
    the Anderson/DKW (``-adkw``: histogram folds) bounders, through the
    per-round host loop (its bound math is numpy on the host on both
    sides; ``test_device_loop_on_the_card_*`` hold the device loop)."""
    ds = flights.generate(n_rows=300_000, seed=4)
    sc = build_scramble(ds.columns, catalog=ds.catalog, seed=5)
    cfg = dict(round_blocks=16, lookahead_blocks=64,
               sync_lookahead_blocks=16, fused=fused, device_loop=False)
    base, adkw = name.split("-adkw")[0], name.endswith("-adkw")
    q = fq.ALL[base](**(dict(bounder="anderson_dkw", rangetrim=False)
                        if adkw else {}))
    kw = dict(sampling=sampling, seed=1)
    r_cpu = FastFrame(sc, EngineConfig(**cfg), device="cpu").run(q, **kw)
    r_gpu = FastFrame(sc, EngineConfig(**cfg)).run(q, **kw)
    for f in ("estimate", "lo", "hi", "count_seen", "exact", "tainted",
              "rows_covered", "blocks_fetched", "blocks_skipped_active",
              "blocks_skipped_static", "bitmap_probes", "rounds",
              "stopped_early"):
        np.testing.assert_array_equal(getattr(r_gpu, f), getattr(r_cpu, f),
                                      err_msg=f)


def test_engine_cuda_launches_both_kernels(cuda):
    ds = flights.generate(n_rows=100_000, seed=6)
    sc = build_scramble(ds.columns, catalog=ds.catalog, seed=7)
    q = AggQuery(agg="avg", column="dep_delay", group_by="airline",
                 filters=(Filter("origin", "eq", 1),),
                 stop=ThresholdSide(threshold=10.0), delta=1e-6)
    block_agg.block_agg.launches = 0
    bitmap_active.active_blocks.launches = 0
    bitmap_active.round_select.launches = 0
    FastFrame(sc, EngineConfig(round_blocks=8, lookahead_blocks=32)).run(q)
    assert block_agg.block_agg.launches > 0
    assert bitmap_active.active_blocks.launches > 0
    assert bitmap_active.round_select.launches > 0


def test_engine_cuda_anderson_launches_histogram_kernels(cuda):
    """An Anderson/DKW query folds through fused_fold on its rounds and
    grouped_hist in its exact sweep; a Bernstein query through neither."""
    ds = flights.generate(n_rows=100_000, seed=6)
    sc = build_scramble(ds.columns, catalog=ds.catalog, seed=7)
    frame = FastFrame(sc, EngineConfig(round_blocks=8, lookahead_blocks=32))
    counters = (block_agg.block_agg, fused_fold.fused_fold,
                grouped_hist.grouped_hist)
    for c in counters:
        c.launches = 0
    frame.run(fq.ALL["F-q2"]())
    assert [c.launches > 0 for c in counters] == [True, False, False]
    for c in counters:
        c.launches = 0
    q = fq.ALL["F-q2"](bounder="anderson_dkw", rangetrim=False)
    frame.run(q)
    frame.run(q, sampling="exact")
    assert [c.launches > 0 for c in counters] == [True, True, True]


def _scan_inputs(seed, B, L, din, n):
    """The smoke script's scan inputs: x ~ N(0, 1), dt = softplus(N(-4.6,
    0.5)), B, C ~ N(0, 1), A = -(1..n), D ~ N(1, 0.1), h0 ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, L, din))
    dt = np.log1p(np.exp(rng.normal(-4.6, 0.5, (B, L, din))))
    b = rng.normal(0, 1, (B, L, n))
    c = rng.normal(0, 1, (B, L, n))
    a = -np.tile(np.arange(1, n + 1, dtype=np.float64), (din, 1))
    d = rng.normal(1, 0.1, din)
    h0 = rng.normal(0, 0.1, (B, din, n))
    return [torch.from_numpy(np.asarray(t, np.float32))
            for t in (x, dt, b, c, a, d, h0)]


# (B, L, din, n, tc): the falcon-mamba layer at full width (serving),
# then small uneven ones (one batch row, chunks of 512 and three of them,
# a single 128-channel tile, n = 8, a ragged last CTA of 200 channels,
# chunks of 25 steps: shorter than the kernel's 32-step stage), the
# training shape, a din that is not a multiple of 4 (the 4-byte copy
# path) nor of the CTA's 64 channels, n = 8 (two lanes a channel, 128
# channels a CTA) with a ragged CTA, and chunks of 48 steps (a full stage
# and a 16-step tail)
SCAN_SHAPES = [(8, 2048, 8192, 16, 512), (1, 512, 128, 8, 512),
               (1, 1536, 128, 8, 512), (2, 96, 200, 16, 32),
               (3, 100, 128, 16, 25), (2, 4096, 8192, 16, 512),
               (1, 64, 130, 16, 32), (2, 96, 200, 8, 32),
               (2, 240, 192, 16, 48)]


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("B,L,din,n,tc", SCAN_SHAPES)
def test_selective_scan_equals_plain(cuda, B, L, din, n, tc):
    """hout and hseg bit for bit the plain version's on the card (every
    product and sum of the state update rounds alike, the exponential is
    the accurate expf on both sides); y within 1e-5 of its largest
    magnitude (only the order of the sum over the n states differs); the
    same bits on a second run, one launch counted per call."""
    args = [t.to(cuda) for t in _scan_inputs(L + din, B, L, din, n)]
    before = selective_scan.selective_scan.launches
    got = selective_scan.selective_scan(*args, time_chunk=tc)
    again = selective_scan.selective_scan(*args, time_chunk=tc)
    want = ref.selective_scan_ref(*args, time_chunk=tc)
    torch.cuda.synchronize()
    assert selective_scan.selective_scan.launches == before + 2
    assert got[2].shape == (B, L // tc, din, n)
    for name, g, a, w in zip(("y", "hout", "hseg"), got, again, want):
        assert torch.equal(_bits(g), _bits(a)), name
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (name, err)
    for name, g, w in zip(("hout", "hseg"), got[1:], want[1:]):
        assert torch.equal(_bits(g), _bits(w)), name


def test_selective_scan_misaligned_inputs_same_bits(cuda):
    """x at an address that is not 16-byte aligned takes the kernel's
    4-byte copy path: the same bits as the aligned call."""
    args = [t.to(cuda) for t in _scan_inputs(3, 2, 96, 256, 16)]
    store = torch.empty(args[0].numel() + 1, device=cuda)
    shifted = store[1:].view(args[0].shape)
    shifted.copy_(args[0])
    want = selective_scan.selective_scan(*args, time_chunk=32)
    got = selective_scan.selective_scan(shifted, *args[1:], time_chunk=32)
    torch.cuda.synchronize()
    for name, g, w in zip(("y", "hout", "hseg"), got, want):
        assert torch.equal(_bits(g), _bits(w)), name


def test_selective_scan_ops_dispatch_and_cpu_agreement(cuda):
    args = _scan_inputs(1, 2, 256, 128, 16)
    want = ops.selective_scan(*args, time_chunk=64)
    got = ops.selective_scan(*(t.to(cuda) for t in args), time_chunk=64)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        err = float((g.cpu() - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max())


def test_selective_scan_rejects_bad_input(cuda):
    args = [t.to(cuda) for t in _scan_inputs(0, 1, 32, 128, 8)]
    with pytest.raises(ValueError, match="needs CUDA"):
        selective_scan.selective_scan(*(t.cpu() for t in args))
    with pytest.raises(ValueError, match="float32"):
        selective_scan.selective_scan(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="state size"):
        four = _scan_inputs(0, 1, 32, 128, 4)
        selective_scan.selective_scan(*(t.to(cuda) for t in four))
    with pytest.raises(ValueError, match="contiguous"):
        x = args[0].transpose(1, 2).contiguous().transpose(1, 2)
        selective_scan.selective_scan(x, *args[1:])
    with pytest.raises(ValueError, match="time chunk"):
        selective_scan.selective_scan(*args, time_chunk=24)


def test_mamba1_lm_cuda_equals_cpu(cuda):
    """The reduced falcon-mamba in float32 with the same weights on the
    card and on the CPU: forward, prefill and decode logits within 1e-4
    of their largest magnitude; every prefill layer launches the scan."""
    import dataclasses
    cfg = dataclasses.replace(get_config("falcon_mamba_7b", reduced=True),
                              param_dtype="float32", compute_dtype="float32",
                              ssm_impl="pallas")
    model = build_model(cfg)
    lm_cpu = model.init(0, device="cpu")
    lm_gpu = model.init(0, device=cuda)
    lm_gpu.load_state_dict(lm_cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)))
    outs = []
    for lm, dev in ((lm_cpu, "cpu"), (lm_gpu, cuda)):
        t = toks.to(dev)
        with torch.inference_mode():
            full, _ = model.forward(lm, {"tokens": t})
        selective_scan.selective_scan.launches = 0
        pre, cache = model.prefill(lm, {"tokens": t[:, :63]})
        launches = selective_scan.selective_scan.launches
        dec, _ = model.decode(lm, cache, {"token": t[:, 63:], "pos": 63})
        outs.append(([full, pre, dec], launches))
    (want, n_cpu), (got, n_gpu) = outs
    assert n_cpu == 0 and n_gpu == cfg.n_layers
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(
            w.abs().max())


# -- the scan's backward ------------------------------------------------------

# (B, L, din, n, tc): one channel cluster at n 8 over two chunks; a
# ragged last cluster of 200 channels at n 16; chunks of 25 steps (shorter
# than the kernel's 32-step sub-chunk) at B 4; one long chunk; three
# clusters, B 3; chunks of 100 steps (three sub-chunks and a tail of 4)
# at n 8 and of 48 at n 16, ragged din
BWD_SHAPES = [(1, 128, 128, 8, 64), (2, 96, 200, 16, 32),
              (4, 100, 128, 16, 25), (1, 512, 256, 8, 512),
              (3, 192, 384, 16, 64), (2, 200, 300, 8, 100),
              (1, 96, 136, 16, 48)]
BWD_RTOL = 1e-5


def _bwd_args(seed, B, L, din, n, tc, cuda):
    """The forward's inputs, its hseg at ``tc`` (plain version) and
    N(0, 1) cotangents, on the card."""
    args = [t.to(cuda) for t in _scan_inputs(seed, B, L, din, n)]
    _, _, hseg = ref.selective_scan_ref(*args, time_chunk=tc)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    ybar = torch.randn((B, L, din), generator=gen, device=cuda)
    houtbar = torch.randn((B, din, n), generator=gen, device=cuda)
    return args[:6] + [hseg, ybar, houtbar]


@pytest.mark.parametrize("B,L,din,n,tc", BWD_SHAPES)
def test_selective_scan_bwd_equals_plain(cuda, B, L, din, n, tc):
    """Every gradient within 1e-5 of its largest plain magnitude (the
    recompute is the forward's own bits; only the sums over n, channels,
    batch rows and chunks run in other orders), dh0 bit for bit the plain
    version's (its adjoint recurrence has no sum), the same bits on a
    second run, one launch counted per call."""
    args = _bwd_args(B + L + din, B, L, din, n, tc, cuda)
    before = selective_scan.selective_scan_bwd.launches
    got = selective_scan.selective_scan_bwd(*args, time_chunk=tc)
    again = selective_scan.selective_scan_bwd(*args, time_chunk=tc)
    want = ref.selective_scan_bwd_ref(*args, time_chunk=tc)
    torch.cuda.synchronize()
    assert selective_scan.selective_scan_bwd.launches == before + 2
    for name, g, a, w in zip(("dx", "ddt", "db", "dc", "da", "dd", "dh0"),
                             got, again, want):
        assert g.shape == w.shape, name
        assert torch.equal(g.view(torch.int32), a.view(torch.int32)), name
        err = float((g - w).abs().max())
        assert err <= BWD_RTOL * float(w.abs().max()), (name, err)
    assert torch.equal(got[6].view(torch.int32), want[6].view(torch.int32))


@pytest.mark.parametrize("B,L,din,n,tc", [(2, 1024, 1024, 16, 512),
                                           (2, 96, 200, 16, 32),
                                           (3, 100, 128, 8, 25)])
def test_selective_scan_bwd_from_kernel_hseg(cuda, B, L, din, n, tc):
    """The training path's pairing: the forward kernel's own hseg fed to
    the backward kernel gives bit for bit the gradients of the plain
    forward's hseg."""
    args = [t.to(cuda) for t in _scan_inputs(B + L + din, B, L, din, n)]
    _, _, hseg_kernel = selective_scan.selective_scan(*args, time_chunk=tc)
    _, _, hseg_plain = ref.selective_scan_ref(*args, time_chunk=tc)
    gen = torch.Generator(device=cuda).manual_seed(B + L)
    ybar = torch.randn((B, L, din), generator=gen, device=cuda)
    houtbar = torch.randn((B, din, n), generator=gen, device=cuda)
    got = selective_scan.selective_scan_bwd(*args[:6], hseg_kernel, ybar,
                                            houtbar, time_chunk=tc)
    want = selective_scan.selective_scan_bwd(*args[:6], hseg_plain, ybar,
                                             houtbar, time_chunk=tc)
    torch.cuda.synchronize()
    for name, g, w in zip(("dx", "ddt", "db", "dc", "da", "dd", "dh0"),
                          got, want):
        assert torch.equal(_bits(g), _bits(w)), name


def test_trainable_scan_on_the_card_equals_cpu(cuda):
    """Autograd through make_trainable_scan: the CUDA forward and backward
    against the plain versions on the CPU, one launch of each."""
    B, L, din, n = 2, 256, 256, 16
    cpu_args = _scan_inputs(5, B, L, din, n)
    grads = []
    for dev in ("cpu", cuda):
        ts = [t.detach().clone().to(dev).requires_grad_()
              for t in cpu_args]
        f0 = selective_scan.selective_scan.launches
        b0 = selective_scan.selective_scan_bwd.launches
        y, h = selective_scan.make_trainable_scan(time_chunk=64)(*ts)
        ((y ** 2).sum() * 0.5 + (h * h).sum()).backward()
        n_launch = (selective_scan.selective_scan.launches - f0,
                    selective_scan.selective_scan_bwd.launches - b0)
        assert n_launch == ((0, 0) if dev == "cpu" else (1, 1))
        grads.append([t.grad.cpu() for t in ts])
    for w, g in zip(*grads):
        assert float((g - w).abs().max()) <= BWD_RTOL * float(w.abs().max())


def test_selective_scan_bwd_rejects_bad_input(cuda):
    args = _bwd_args(0, 1, 32, 128, 8, 16, cuda)
    with pytest.raises(ValueError, match="needs CUDA"):
        selective_scan.selective_scan_bwd(*(t.cpu() for t in args),
                                          time_chunk=16)
    with pytest.raises(ValueError, match="float32"):
        selective_scan.selective_scan_bwd(args[0].double(), *args[1:],
                                          time_chunk=16)
    with pytest.raises(ValueError, match="state size"):
        four = _bwd_args(0, 1, 32, 128, 4, 16, cuda)
        selective_scan.selective_scan_bwd(*four, time_chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        x = args[0].transpose(1, 2).contiguous().transpose(1, 2)
        selective_scan.selective_scan_bwd(x, *args[1:], time_chunk=16)
    with pytest.raises(ValueError, match="time chunk"):
        selective_scan.selective_scan_bwd(*args, time_chunk=24)
    with pytest.raises(ValueError, match="hseg must be"):
        selective_scan.selective_scan_bwd(*args, time_chunk=8)
    with pytest.raises(ValueError, match="exceeds the backward"):
        long = _bwd_args(0, 1, 4096, 128, 8, 4096, cuda)
        selective_scan.selective_scan_bwd(*long, time_chunk=4096)


def test_mamba1_train_step_cuda_equals_cpu(cuda):
    """One train step of the reduced falcon-mamba in float32 on the card
    and on the CPU from the same weights: loss, grad norm and both AdamW
    moments, which at step 0 are the clipped gradient and its square
    scaled (lr is 0 there: Adam's first real update is ~lr · sign(g), which
    flips on gradients that are ~0 on either device, so the moments, not
    the moved parameters, are the comparison); each layer's scan runs
    forward twice (remat) and backward once on the card."""
    import dataclasses
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import train_batch
    from repro_torch.train import OptConfig, build_train_step, init_state
    cfg = dataclasses.replace(get_config("falcon_mamba_7b", reduced=True),
                              param_dtype="float32", compute_dtype="float32",
                              ssm_impl="pallas")
    model = build_model(cfg)
    ocfg = OptConfig.for_arch(cfg, lr=5e-3, warmup_steps=1)
    batch = train_batch(cfg, ShapeConfig("t", 128, 2, "train"), 0)
    out = []
    for dev in ("cpu", cuda):
        st = init_state(model, 0, ocfg, device="cpu")
        st["params"].to(dev)
        st = {"params": st["params"],
              "opt": {k: {n: t.to(dev) for n, t in v.items()}
                      for k, v in st["opt"].items()},
              "step": st["step"].to(dev)}
        f0 = selective_scan.selective_scan.launches
        b0 = selective_scan.selective_scan_bwd.launches
        st, met = build_train_step(model, ocfg)(
            st, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        launches = (selective_scan.selective_scan.launches - f0,
                    selective_scan.selective_scan_bwd.launches - b0)
        out.append((st, met, launches))
    (s_cpu, m_cpu, n_cpu), (s_gpu, m_gpu, n_gpu) = out
    assert n_cpu == (0, 0) and n_gpu == (2 * cfg.n_layers, cfg.n_layers)
    for k in ("loss", "grad_norm"):
        assert abs(float(m_gpu[k]) - float(m_cpu[k])) <= 1e-5 * abs(
            float(m_cpu[k])), k
    for part in ("m", "v"):
        for name, w in s_cpu["opt"][part].items():
            err = float((s_gpu["opt"][part][name].cpu() - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()), (part, name, err)


# -- CUDA graphs and the device-resident round loop --------------------------

_TWO_STREAMS = r"""
import sys
import numpy as np
import torch
from repro_torch.kernels import ops
n, G, nbins, reps = 1 << 20, 14, 1024, int(sys.argv[1])
rng = np.random.default_rng(0)
rows = [[torch.from_numpy(x) for x in (
    rng.normal(40.0, 25.0, n).astype(np.float32),
    rng.integers(0, G, n).astype(np.int32),
    (rng.random(n) < 0.8).astype(np.float32))] for _ in range(2)]
want = [ops.grouped_hist(*r, G, -60.0, 1800.0, nbins=nbins).hist
        for r in rows]
dev = [[t.cuda() for t in r] for r in rows]
streams = [torch.cuda.Stream(), torch.cuda.Stream()]
torch.cuda.synchronize()
outs = [[], []]
for _ in range(reps):
    for k in (0, 1):
        with torch.cuda.stream(streams[k]):
            outs[k].append(ops.grouped_hist(*dev[k], G, -60.0, 1800.0,
                                            nbins=nbins).hist)
torch.cuda.synchronize()
for k in (0, 1):
    for o in outs[k]:
        assert torch.equal(o.cpu(), want[k])
print("TWO-STREAMS-OK", reps)
"""


def test_grouped_hist_two_streams_at_once_do_not_hang(cuda):
    """Two G 14 private-regime calls (1M rows, 1,024 bins) at once on two
    streams, many times over: the private kernel's grid barrier needs all
    its CTAs resident, which its cooperative launch guarantees whatever
    else holds the card. Run in a subprocess with a timeout, so that a
    hang fails this test instead of stalling the run; every output is
    bit for bit the plain version's."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    try:
        out = subprocess.run([sys.executable, "-c", _TWO_STREAMS, "50"],
                             env=env, capture_output=True, text=True,
                             timeout=300)
    except subprocess.TimeoutExpired:
        pytest.fail("two grouped_hist calls on two streams hung")
    assert out.returncode == 0, out.stderr[-4000:]
    assert "TWO-STREAMS-OK 50" in out.stdout


@pytest.mark.parametrize("kernel", ["block_agg", "fused_fold"])
def test_fold_replays_in_a_cuda_graph(cuda, kernel):
    """A fold captured once in a CUDA graph and replayed with its slabs
    and lanes changed in place (all lanes valid, a few padding lanes,
    every lane padding): each replay is bit for bit the plain version of
    its own inputs on the CPU."""
    nb, br, G, budget, nbins = 96, 1024, 200, 64, 1024
    sets = [(list(_slabs(s, nb, br, G, False)),
             list(_lanes(s + 1, nb, budget, pad)))
            for s, pad in ((1, 0), (2, 5), (3, budget))]
    d = [t.to(cuda) for t in sets[0][0] + sets[0][1]]

    def fold(v, g, m, blk, tvalid):
        if kernel == "block_agg":
            return ops.grouped_sums(v, g, m, G, 870.0, blk=blk,
                                    tvalid=tvalid)
        return ops.grouped_fold_hist(v, g, m, G, 870.0, -60.0, 1800.0,
                                     nbins, blk=blk, tvalid=tvalid)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fold(*d)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fold(*d)
    for slabs, lanes in sets + sets[::-1]:
        for x, y in zip(d, slabs + lanes):
            x.copy_(y)
        graph.replay()
        torch.cuda.synchronize()
        _same(out, fold(*slabs, *lanes))


def test_round_select_device_cursor_replays_in_a_cuda_graph(cuda):
    """Six rounds of the head chained through the device cursor (each
    round's ``new_pos`` the next one's ``pos``), captured once and
    replayed from other starts and with ``go`` false: every round's
    outputs equal the plain version's chain on the CPU, including the
    rounds at the end of the scan and the rounds that do not run."""
    nb, W, window, budget = 20_000, 88, 4096, 64
    opad, static_ok, words, act, _, _ = _head_inputs(11, nb, W, window,
                                                     "random")
    t = [torch.from_numpy(x) for x in (opad, static_ok, words, act)]
    d = [x.to(cuda) for x in t]
    kw = dict(nb=nb, window=window, budget=budget, probe=True)
    pos, go = _cursor(0, cuda)

    def chain(p, g, tensors):
        outs = []
        for _ in range(6):
            o = ops.round_select(*tensors, p, g, **kw)
            outs.append(o)
            p = o[2]
        return outs

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        chain(pos, go, d)
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = chain(pos, go, d)
    for start, run in ((0, True), (nb // 2, True), (nb - 100, True),
                       (3000, False), (0, True)):
        pos.fill_(start)
        go.fill_(run)
        graph.replay()
        torch.cuda.synchronize()
        want = chain(*_cursor(start, "cpu", run), t)
        for got_round, want_round in zip(out, want):
            for x, y in zip(got_round, want_round):
                assert torch.equal(x.cpu(), y)


def _loop_scramble():
    ds = flights.generate(n_rows=300_000, n_airports=60, n_airlines=14,
                          seed=12)
    return build_scramble(ds.columns, catalog=ds.catalog, block_rows=256,
                          seed=13)


_LOOP_CFG = dict(round_blocks=16, lookahead_blocks=64,
                 sync_lookahead_blocks=16, hist_bins=256)
_LOOP_CASES = [("F-q5", "active_peek"), ("F-q2", "active_sync"),
               ("F-q8", "scan"), ("F-q5-adkw", "active_peek"),
               ("groupby-adkw", "active_peek")]


def _loop_query(name):
    adkw = dict(bounder="anderson_dkw", rangetrim=False)
    if name == "groupby-adkw":
        return AggQuery(agg="avg", column="dep_delay",
                        group_by=("origin", "airline"),
                        stop=ThresholdSide(threshold=10.0), **adkw)
    base = name.split("-adkw")[0]
    return fq.ALL[base](**(adkw if name.endswith("-adkw") else {}))


def _assert_loops_agree(r_dev, r_host):
    """The device loop against the host loop: scan decisions exact, CIs
    within atol 1e-9 and rtol 1e-12 (the reference's contract)."""
    for f in ("count_seen", "nonempty", "exact", "tainted", "rows_covered",
              "blocks_fetched", "blocks_skipped_active",
              "blocks_skipped_static", "bitmap_probes", "rounds",
              "stopped_early"):
        np.testing.assert_array_equal(getattr(r_dev, f), getattr(r_host, f),
                                      err_msg=f)
    for f in ("estimate", "lo", "hi"):
        a, b = getattr(r_dev, f), getattr(r_host, f)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-12, atol=1e-9,
                                   err_msg=f)


@pytest.mark.parametrize("name,sampling", _LOOP_CASES)
def test_device_loop_on_the_card_matches_host_loop(cuda, name, sampling):
    """``device_loop=True`` on the card (one CUDA graph replay a chunk)
    against the per-round host loop on the card, and the default
    ``device_loop=None`` runs the same graph path; every chunk of the run
    is a replay, and the kernels' counts include the replays'
    launches."""
    sc = _loop_scramble()
    q = _loop_query(name)
    kw = dict(sampling=sampling, seed=1)
    frame = FastFrame(sc, EngineConfig(device_loop=True, **_LOOP_CFG))
    bitmap_active.round_select.launches = 0
    r_dev = frame.run(q, **kw)
    (dloop,) = [frame.device_loops[k] for k in frame.device_loops.keys()]
    assert dloop.graph is not None and dloop.replays >= 1
    assert dloop.chunks == dloop.replays
    assert dloop.replays * dloop.chunk >= r_dev.rounds
    # the warm-up chunk ran for real on a copy; the replays launched the rest
    assert (bitmap_active.round_select.launches
            == (dloop.replays + 1) * dloop.chunk)
    r_host = FastFrame(sc, EngineConfig(device_loop=False, **_LOOP_CFG)).run(
        q, **kw)
    _assert_loops_agree(r_dev, r_host)
    r_default = FastFrame(sc, EngineConfig(**_LOOP_CFG)).run(q, **kw)
    _assert_loops_agree(r_default, r_dev)


def test_device_loop_graph_replay_equals_eager_chunk(cuda):
    """The captured chunk against the same chunk function run eagerly on
    the card from the same carry, chunk after chunk: every carry tensor
    equal bit for bit. The eager enqueue runs under
    ``torch.cuda.set_sync_debug_mode("error")``: no round syncs with the
    host."""
    from repro_torch.aqp import engine
    sc = _loop_scramble()
    q = _loop_query("groupby-adkw")
    frame = FastFrame(sc, EngineConfig(device_loop=True, chunk_rounds=3,
                                       **_LOOP_CFG))
    nb = sc.n_blocks
    order = (17 + np.arange(nb)) % nb
    cum_rows = np.cumsum(frame._valid_counts[order])
    slot = engine._ScanViews(frame, q)
    qci = engine._QueryIntervals(frame, q, slot)
    dl = engine._DeviceLoop(frame, q, slot, qci, probe=True, lookahead=64,
                            max_rounds=100_000)
    dl.set_order(order, cum_rows)
    eager = dl.init_carry(slot, qci)
    dl._capture(dl.init_carry(slot, qci))
    mode = torch.cuda.get_sync_debug_mode()
    for _ in range(4):
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = dl._chunk_fn(dl.bufs, eager)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        dl.graph.replay()
        torch.cuda.synchronize()
        for x, y in zip(fused_scan.carry_leaves(dl._static),
                        fused_scan.carry_leaves(eager)):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    assert int(eager.rounds) == 12


# -- shared-scan serving: the multi-query probe, the slot's head, passes ----


@pytest.mark.parametrize("W,Q", [(1, 1), (7, 2), (31, 8), (32, 3), (88, 8),
                                 (320, 5), (600, 2)])
def test_bitmap_active_multi_equals_plain(cuda, W, Q):
    """One launch for a (Q, W) stack equals the plain version on the CPU
    bit for bit, row q equals the single-mask probe against stack[q],
    over all rows and through a window (W 600: a lane's words in two
    passes)."""
    rng = np.random.default_rng(W * 31 + Q)
    nb = 5000
    one_bit = (np.uint64(1) << rng.integers(0, 32, (nb, W)).astype(
        np.uint64)).astype(np.uint32)
    words = torch.from_numpy(np.where(rng.random((nb, W)) < 0.02, one_bit,
                                      np.uint32(0)).view(np.int32))
    stack = rng.integers(-2**31, 2**31, (Q, W)).astype(np.int32)
    stack[::3] = -1
    stack[1::4] = 0
    stack = torch.from_numpy(stack)
    win = torch.from_numpy(rng.integers(0, nb, 4096).astype(np.int32))
    for w in (win, None):
        want = ops.active_blocks_multi(words, stack, win=w)
        before = bitmap_active.active_blocks_multi.launches
        wc = None if w is None else w.to(cuda)
        got = ops.active_blocks_multi(words.to(cuda), stack.to(cuda), win=wc)
        again = ops.active_blocks_multi(words.to(cuda), stack.to(cuda),
                                        win=wc)
        torch.cuda.synchronize()
        assert bitmap_active.active_blocks_multi.launches == before + 2
        assert got.shape == (Q, nb if w is None else len(w))
        assert torch.equal(got.cpu(), want) and torch.equal(got, again)
        for q in range(Q):
            single = ops.active_blocks(words.to(cuda), stack[q].to(cuda),
                                       win=wc)
            assert torch.equal(got[q], single)


@pytest.mark.parametrize("W,Q,anchor", [(1, 1, 0), (7, 3, 9_000),
                                        (88, 8, 6_000), (88, 1, 19_000),
                                        (320, 4, 14_000)])
def test_round_select_stack_and_lap_equal_plain(cuda, W, Q, anchor):
    """A slot's head (a stack of masks, the slot's lap end, a wrapped
    window) equals its plain version bit for bit at cursors inside the
    lap, past nb, near the lap's end, at its end and outside it, and
    with go false; a stack of one row with lap end nb and no wrap equals
    the solo head."""
    nb, window, budget = 20_000, 4096, 64
    rng = np.random.default_rng(W + Q + anchor)
    order = rng.permutation(nb).astype(np.int32)
    opad = np.concatenate([order, order[np.arange(window) % nb]])
    static_ok = rng.random(nb) < 0.85
    one_bit = (np.uint64(1) << rng.integers(0, 32, (nb, W)).astype(
        np.uint64)).astype(np.uint32)
    words = np.where(rng.random((nb, W)) < 0.02, one_bit,
                     np.uint32(0)).view(np.int32)
    stack = rng.integers(-2**31, 2**31, (Q, W)).astype(np.int32)
    t = [torch.from_numpy(x) for x in (opad, static_ok, words, stack)]
    tc = [x.to(cuda) for x in t]
    le = anchor + nb
    kw = dict(nb=nb, window=window, budget=budget, probe=True, lap_end=le,
              wrap=True)
    cases = [(anchor, True), (anchor + 777, True), (nb + 5, True),
             (le - window // 3, True), (le, True), (le + 1, True),
             (anchor - 1, True), (anchor + 50, False)]
    for pos, go in cases:
        want = ops.round_select(*t, *_cursor(pos, go=go), **kw)
        got = ops.round_select(*tc, *_cursor(pos, cuda, go), **kw)
        again = ops.round_select(*tc, *_cursor(pos, cuda, go), **kw)
        for x, y, z in zip(got, want, again):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x.cpu(), y) and torch.equal(x, z), (pos, go)
    # one row, the solo lap: the solo head's bits
    solo = dict(nb=nb, window=window, budget=budget, probe=True)
    for pos in (0, 4321, nb - 100):
        a = ops.round_select(*tc[:3], tc[3][0], *_cursor(pos, cuda), **solo)
        b = ops.round_select(*tc[:3], tc[3][:1], *_cursor(pos, cuda),
                             lap_end=nb, wrap=False, **solo)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _serve_frame(sc, **over):
    return FastFrame(sc, EngineConfig(**dict(_LOOP_CFG, **over)),
                     device="cuda")


def _serve_queries():
    """Three slots over one non-categorical filter (no static-prefilter
    probes, so every slot's metrics match a solo run on any frame): two
    probe slots and one non-probe slot."""
    filt = (Filter("dep_time", "gt", 400.0),)
    return [AggQuery(agg="avg", column="dep_delay", group_by="origin",
                     filters=filt, stop=ThresholdSide(threshold=10.0)),
            AggQuery(agg="avg", column="dep_time", group_by="airline",
                     filters=filt, stop=ThresholdSide(threshold=800.0)),
            AggQuery(agg="sum", column="dep_delay", filters=filt,
                     stop=fq.ALL["F-q1"]().stop)]


def test_pass_loop_graph_replay_equals_eager_chunk(cuda):
    """A pass of S = 3 slots: its captured chunk against the same chunk
    run eagerly on the card from the same carry, chunk after chunk,
    every carry tensor equal bit for bit (the round head runs three
    times a round on one stream inside the graph, so its look-back
    epoch must survive S calls a round and the replays). The eager
    enqueue runs under ``set_sync_debug_mode("error")``."""
    from repro_torch.serve import FrameServer
    from repro_torch.serve.frame_server import _PassLoop
    sc = _loop_scramble()
    frame = _serve_frame(sc, device_loop=True)
    p = FrameServer(frame).open_pass(_serve_queries()[0].filters,
                                     start_block=17, chunk_rounds=3)
    p.admit(_serve_queries())
    assert len(p.slots) == 3
    loop = _PassLoop(p)
    loop.set_order(p.start, p.order_pad, p.cum_rows)
    eager = fused_scan.carry_to_device(p._host_carry(), cuda)
    static = loop.graph.load(fused_scan.carry_to_device(p._host_carry(),
                                                        cuda))
    before = bitmap_active.round_select.launches
    mode = torch.cuda.get_sync_debug_mode()
    for _ in range(4):
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = loop.chunk_fn(loop.bufs, eager)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        loop.graph.replay()
        torch.cuda.synchronize()
        for x, y in zip(fused_scan.carry_leaves(static),
                        fused_scan.carry_leaves(eager)):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    assert int(eager.rounds) == 12
    # eager chunks and replays: 3 heads a round each
    assert bitmap_active.round_select.launches - before == 2 * 4 * 3 * 3


def test_served_batch_bitwise_equals_solo_device_loop(cuda):
    """A three-slot batch served through the device pass loop on the
    card: each result bit for bit its query's solo device-loop run, and
    every pass chunk a graph replay."""
    from repro_torch.serve import FrameServer
    sc = _loop_scramble()
    qs = _serve_queries()
    frame = _serve_frame(sc)
    res = FrameServer(frame).run_batch(qs, seed=2, start_block=5)
    loops = [frame.device_loops[k] for k in frame.device_loops.keys()]
    assert len(loops) == 1 and loops[0].graph.replays == loops[0].chunks
    solo = _serve_frame(sc)
    for q, r in zip(qs, res):
        want = solo.run(q, seed=2, start_block=5)
        for f in ("group_codes", "estimate", "lo", "hi", "count_seen",
                  "nonempty", "exact", "tainted", "rows_covered",
                  "blocks_fetched", "blocks_skipped_active",
                  "blocks_skipped_static", "bitmap_probes", "rounds",
                  "stopped_early"):
            np.testing.assert_array_equal(getattr(r, f), getattr(want, f),
                                          err_msg=f)
