"""The port's sharded train step and elastic checkpoint on gloo worlds of
4 CPU ranks (``tests/helpers/torch_dist_world.py``; the commands are
``tests/helpers/torch_sharded_train_ops.py``), the mirror of the
reference's ``tests/helpers/dist_train_worker.py`` (run by
``tests/test_distributed.py``).

For reduced qwen3 (AdamW), dbrx (Adafactor over its experts, sharded on
"model", in 2 microbatches) and zamba2 (the SSM channels on "model"),
float32 without remat, 8 x 64 tokens, on a (2, 2) ("data", "model")
mesh:

  * three steps of ``build_sharded_train_step`` from the same state and
    batch as three of the single-process ``build_train_step``: each loss
    within 1e-4, the gradient norm and lr within 1e-4 relative, the
    moments within 2e-4 of their leaf's largest, the parameters within
    rtol 2e-4, atol 2e-5 (the reference worker's tolerances; AdamW's
    parameters after a moving step widened by what its unit-size update
    carries from each element's moments, ``torch_train_parity``);
  * the state saved with its specs, restored onto a (4, 1) mesh (bit for
    bit the saved one) and one more step on each layout: the losses
    within 1e-4;
  * every leaf's replicas the same bits on every rank that holds them,
    on both layouts.

And on the same world: the multi-axis order of a dim cut over two mesh
axes (DTensor's mesh-dim-major order, the one ``distribute_tensor``
gives), ``constrain`` on DTensors, and meshes of the wrong size refused.
"""

import collections

import pytest

from tests.helpers.torch_dist_world import DistWorld

ARCHS = ["qwen3_0_6b", "dbrx_132b", "zamba2_7b"]
CASE_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = DistWorld(4, tmp_path_factory.mktemp("gloo4"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """Each config's sharded run, once a module (its checks run on the
    ranks; a failing one fails every case of the config)."""
    done = {}

    def get(arch):
        if arch not in done:
            ck = tmp_path_factory.mktemp(f"ckpt_{arch}")
            done[arch] = world.run("sharded_train", CASE_TIMEOUT_S,
                                   arch=arch, ckpt_dir=str(ck))
        return done[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_single_process(runs, arch):
    out = runs(arch)
    for rec in out:
        assert len(rec["losses"]) == 3
        assert max(rec["loss_diff"]) < 1e-4
    # every rank reports the same metrics
    assert len({tuple(r["losses"]) for r in out}) == 1
    # the steps moved the loss (lr 0 at step 0, then warm-up)
    assert out[0]["losses"][2] < out[0]["losses"][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_elastic_restore_continues(runs, arch):
    out = runs(arch)
    for rec in out:
        a, b = rec["elastic"]
        assert abs(a - b) < 1e-4
    assert len({tuple(r["elastic"]) for r in out}) == 1


@pytest.mark.parametrize("layout", ["replicas", "replicas_41"])
@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_leaves_same_bits_on_every_rank(runs, arch, layout):
    """Ranks that hold the same slice of a leaf hold the same bits."""
    out = runs(arch)
    by_slice = collections.defaultdict(set)
    holders = collections.Counter()
    for rec in out:
        for leaf, (bounds, crc) in rec[layout].items():
            key = (leaf, str(bounds))
            by_slice[key].add(crc)
            holders[key] += 1
    assert all(len(c) == 1 for c in by_slice.values()), \
        [k for k, c in by_slice.items() if len(c) > 1][:5]
    # on (2, 2) some leaves are replicated over an axis, and some cut
    assert max(holders.values()) > 1
    assert min(holders.values()) < 4 or layout == "replicas_41"


def test_multi_axis_order_is_mesh_dim_major(world):
    """``P(None, ("model", "data"))`` on a (2, 2) ("data", "model") mesh:
    rank (d, m) holds column chunk ``2 d + m``, what DTensor's own
    ``distribute_tensor`` gives for the same placements (the reference's
    JAX mesh gives ``2 m + d``); gathered whole it is the tensor."""
    out = world.run("multi_axis_order", 60)
    full = [[float(8 * r + c) for c in range(8)] for r in range(4)]
    for rec in out:
        d, m = rec["coord"]
        k = 2 * d + m
        assert rec["local"] == [row[2 * k:2 * k + 2] for row in full]
        assert rec["local"] == rec["dtensor"]
        assert rec["full"] == full


def test_constrain_redistributes_dtensors(world):
    out = world.run("constrain", 60)
    for rec in out:
        assert rec["outside_same"] and rec["plain_same"]
        assert rec["placements"] == ["Shard(dim=0)", "Shard(dim=2)"]
        assert rec["values_equal"]
        # a batch of 3 does not divide over "data": that axis is dropped
        assert rec["odd_placements"] == ["Replicate()", "Shard(dim=2)"]


def test_mesh_of_the_wrong_size_raises(world):
    out = world.run("mesh_checks", 60)
    for rec in out:
        assert rec == {"wrong_size": "ValueError", "production": "ValueError",
                       "host_2x2": [2, 2]}
