"""Card-only checks of the port's CUDA kernels against their plain
PyTorch versions, and of the engine on the card against the engine on the
CPU. Marked ``cuda``; each test skips when no CUDA device is present.
This file imports nothing of JAX, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
        -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)
"""

import numpy as np
import pytest
import torch

from repro_torch.aqp import (AggQuery, EngineConfig, FastFrame, Filter,
                             build_scramble)
from repro_torch.aqp import flights_queries as fq
from repro_torch.core.optstop import ThresholdSide
from repro_torch.data import flights
from repro_torch.kernels import bitmap_active, block_agg, fused_scan, ops

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


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("G", [1, 7, 130, 300, 10240])
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


@pytest.mark.parametrize("cells", [1, 91])
def test_block_agg_chunked_equals_plain(cuda, monkeypatch, cells):
    """A small run table forces the fold into chunks of lanes (one lane
    a chunk at ``cells=1``, ten at 91); each walk continues the last
    one's sums, so the bits are those of one row-order pass."""
    monkeypatch.setattr(block_agg, "TABLE_CELLS", cells)
    nb, br, G, center = 60, 700, 13, 870.0
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
            t["static_ok"], pos, torch.from_numpy(active).to(dev), nb=nb,
            window=window, budget=budget, center=870.0, num_groups=60,
            probe=True)
            for pos in (0, 300, nb - 50)])
    for (s0, ok0, f0, p0), (s1, ok1, f1, p1) in zip(*outs):
        assert int(p0) == int(p1)
        assert torch.equal(ok0, ok1.cpu()) and torch.equal(f0, f1.cpu())
        _same(s1, s0)


_ENGINE_CASES = [("F-q1", "active_peek", True), ("F-q3", "active_peek", True),
                 ("F-q5", "active_peek", True), ("F-q6", "active_peek", True),
                 ("F-q5", "active_sync", True), ("F-q6", "scan", True),
                 ("F-q2", "exact", True), ("F-q8", "active_peek", False)]


@pytest.mark.parametrize("name,sampling,fused", _ENGINE_CASES)
def test_engine_cuda_equals_cpu(cuda, name, sampling, fused):
    """Every sampling mode and the per-block path (host-materialized
    folds on the card) give the CPU run's bits."""
    ds = flights.generate(n_rows=300_000, seed=4)
    sc = build_scramble(ds.columns, catalog=ds.catalog, seed=5)
    cfg = dict(round_blocks=16, lookahead_blocks=64,
               sync_lookahead_blocks=16, fused=fused)
    q = fq.ALL[name]()
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
    FastFrame(sc, EngineConfig(round_blocks=8, lookahead_blocks=32)).run(q)
    assert block_agg.block_agg.launches > 0
    assert bitmap_active.active_blocks.launches > 0
