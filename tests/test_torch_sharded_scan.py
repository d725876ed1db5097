"""The sharded scan's single-process pieces in the port: the mirror of the
single-device cases of ``tests/test_sharded_scan.py`` (the config
guards, ``merge_every`` through the layout, the block-shard layout and
its uneven tail, the full-dataset round trip), plus the port's own
rank-slicing (``BlockShards.local_rows`` / ``put_blocks``) held against
the reference's layout. The scenarios across ranks run in
``tests/test_torch_distributed.py``, on gloo processes.

This process has no ``torch.distributed`` group, as the reference's
single-device cases have one device: the guards must fire here."""

import numpy as np
import pytest
import torch

import repro.aqp.distributed as Rdist
from repro_torch.aqp import EngineConfig, FastFrame, build_scramble
from repro_torch.aqp.distributed import (AqpMesh, build_block_shards,
                                         make_aqp_mesh, world)
from repro_torch.data import flights


def _mesh(n: int, rank: int = 0) -> AqpMesh:
    """A layout of ``n`` ranks seen from ``rank``, without a group (the
    layout arithmetic needs none)."""
    return AqpMesh(group=None, shape=(n,), n_shards=n, rank=rank,
                   backend="gloo")


class _FakeMesh:
    """The reference's test stand-in for a mesh of ``n`` devices."""

    def __init__(self, n):
        self.devices = np.empty(n, dtype=object)
        self.axis_names = ("shards",)


# -- config guards (single-process) -------------------------------------------


def test_no_group_here():
    assert world() == (1, 0)
    assert make_aqp_mesh() is None


def test_shard_rows_requires_multiple_devices():
    with pytest.raises(ValueError, match="2 ranks"):
        EngineConfig(shard_rows=True, device_loop=True).resolve_shard_rows()


def test_shard_rows_auto_off_on_one_device():
    cfg = EngineConfig(shard_rows=None, mesh_shape=(1,))
    assert cfg.resolve_shard_rows() is False
    assert EngineConfig().resolve_shard_rows() is False


def test_shard_rows_requires_device_loop():
    with pytest.raises(ValueError, match="device-resident round loop"):
        EngineConfig(shard_rows=True, device_loop=False,
                     mesh_shape=(2,)).resolve_shard_rows()


@pytest.mark.parametrize("shape", [(2,), (1, 2), (3,)])
def test_mesh_shape_larger_than_platform_raises(shape):
    """A mesh_shape asking for another number of ranks than the group
    has raises (the reference's 'needs n devices'); one of the group's
    size (1 here) is the single-device case."""
    with pytest.raises(ValueError, match="devices"):
        make_aqp_mesh(shape)
    assert make_aqp_mesh((1,)) is None


def test_explicit_sharding_never_runs_unsharded():
    """``shard_rows=True`` without ranks fails the run and the serving
    pass loudly, as the reference's guard does, instead of running on
    one device."""
    from repro_torch.aqp import AggQuery
    from repro_torch.core.optstop import AbsoluteWidth
    from repro_torch.serve import FrameServer
    rng = np.random.default_rng(0)
    sc = build_scramble({"v": rng.random(600).astype(np.float32)},
                        block_rows=64, seed=0)
    frame = FastFrame(sc, EngineConfig(shard_rows=True), device="cpu")
    q = AggQuery(agg="avg", column="v", stop=AbsoluteWidth(eps=0.1))
    with pytest.raises(ValueError, match="2 ranks"):
        frame.run(q)
    with pytest.raises(ValueError, match="2 ranks"):
        FrameServer(frame).run_batch([q])


@pytest.mark.parametrize("bad", [0, -1])
def test_merge_every_must_be_positive(bad):
    with pytest.raises(ValueError, match="merge_every"):
        EngineConfig(merge_every=bad)
    with pytest.raises(ValueError, match="merge_every"):
        build_block_shards(64, _mesh(4), 256, merge_every=bad)


def test_merge_every_threads_through_layout():
    shards = build_block_shards(64, _mesh(4), 256, merge_every=4)
    assert shards.merge_every == 4
    assert shards.info.merge_every == 4
    assert shards.info.n_shards == 4 and shards.info.shard_rows == 64
    # default stays the per-round-merge oracle
    assert build_block_shards(64, _mesh(4), 256).info.merge_every == 1
    assert build_block_shards(64, None, 256) is None


# -- block-shard layout -------------------------------------------------------


@pytest.mark.parametrize("block_rows,n_shards", [(157, 8), (61, 4), (8, 8),
                                                 (5, 8), (64, 8), (128, 3)])
def test_block_shards_layout(block_rows, n_shards):
    """Row-slice layout: equal-length contiguous row slices covering
    [0, block_rows) exactly once; padding only past block_rows; the
    block axis whole on every shard; each rank's ``local_rows`` (and
    ``put_blocks``) its slice of the padded slab; the same layout as the
    reference's ``build_block_shards``."""
    nb = 16
    shards = build_block_shards(nb, _mesh(n_shards), block_rows)
    ref = Rdist.build_block_shards(nb, _FakeMesh(n_shards), block_rows)
    assert (shards.shard_rows, shards.padded_block_rows) == (
        ref.shard_rows, ref.padded_block_rows)
    assert shards.nb == nb            # block axis is never split
    R = shards.shard_rows
    assert R == -(-block_rows // n_shards)
    assert shards.padded_block_rows >= block_rows
    # padding is strictly less than one row slice per shard
    assert shards.padded_block_rows - block_rows < n_shards
    owner = np.full(block_rows, -1)
    for d in range(n_shards):
        lo, hi = d * R, min((d + 1) * R, block_rows)
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = d
    assert (owner >= 0).all()
    arr = np.arange(nb * block_rows, dtype=np.float32).reshape(
        nb, block_rows) + 1.0
    padded = shards.pad_rows(arr)
    assert padded.shape == (nb, shards.padded_block_rows)
    np.testing.assert_array_equal(padded[:, :block_rows], arr)
    assert (padded[:, block_rows:] == 0).all()
    np.testing.assert_array_equal(padded, ref.pad_rows(arr))
    parts = []
    for d in range(n_shards):
        mine = build_block_shards(nb, _mesh(n_shards, d), block_rows)
        local = mine.local_rows(arr)
        assert local.shape == (nb, R)
        t = mine.put_blocks(arr)
        assert t.device.type == "cpu" and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), local)
        parts.append(local)
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), padded)


def test_put_replicated_is_whole():
    shards = build_block_shards(4, _mesh(2, 1), 10)
    a = np.arange(12, dtype=np.int32).reshape(4, 3)
    t = shards.put_replicated(a)
    np.testing.assert_array_equal(t.numpy(), a)
    assert t.dtype == torch.int32


# -- Scramble.device_shard uneven-tail regression -------------------------------


@pytest.mark.parametrize("nb,n_shards", [(157, 8), (61, 4), (13, 5),
                                         (7, 8), (64, 8)])
def test_device_shard_uneven_tail(nb, n_shards):
    """n_blocks not divisible by n_shards: no block dropped, none
    duplicated, shard sizes differ by <= 1, rows conserved."""
    rng = np.random.default_rng(0)
    n_rows = nb * 32 - 7           # ragged final block too
    cols = {"v": rng.normal(size=n_rows).astype(np.float32),
            "g": rng.integers(0, 4, n_rows).astype(np.int32)}
    sc = build_scramble(cols, block_rows=32, seed=1)
    assert sc.n_blocks == nb
    shards = [sc.device_shard(i, n_shards) for i in range(n_shards)]
    sizes = [s.n_blocks for s in shards]
    assert sum(sizes) == sc.n_blocks
    assert max(sizes) - min(sizes) <= 1
    assert sum(s.n_rows for s in shards) == sc.n_rows
    got = np.concatenate([s.columns["v"] for s in shards])
    np.testing.assert_array_equal(got, sc.columns["v"])
    got_valid = np.concatenate([s.valid for s in shards])
    np.testing.assert_array_equal(got_valid, sc.valid)


def test_device_shard_full_dataset_roundtrip():
    """Values survive sharding exactly (sorted multiset equality over
    valid rows), uneven shard count included; and the rank slices of
    the divided scan hold every valid row once."""
    ds = flights.generate(n_rows=10_000, n_airports=12, seed=0)
    sc = build_scramble(ds.columns, block_rows=256, seed=1)
    assert sc.n_blocks % 3 != 0
    shards = [sc.device_shard(i, 3) for i in range(3)]
    got = np.concatenate([s.columns["dep_delay"][s.valid] for s in shards])
    np.testing.assert_allclose(np.sort(got),
                               np.sort(ds.columns["dep_delay"]))
    rows = []
    for d in range(3):
        lay = build_block_shards(sc.n_blocks, _mesh(3, d), sc.block_rows)
        v = lay.local_rows(sc.columns["dep_delay"])
        m = lay.local_rows(sc.valid)
        rows.append(v[m])
    np.testing.assert_allclose(np.sort(np.concatenate(rows)),
                               np.sort(ds.columns["dep_delay"]))
