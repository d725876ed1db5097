"""The port's meta-device dry runs (``repro_torch.launch.dryrun`` and
``dryrun_aqp``) on the CPU.

  * ``python -m repro_torch.launch.dryrun`` in a subprocess (it joins a
    ``fake``-backend group of 256, then 512 ranks): qwen3-0.6b's
    ``train_4k`` and ``decode_32k`` at full size on both production
    meshes come back ``ok``, with the per-device bytes of parameters,
    optimizer state, batch and cache equal to the arithmetic on the
    REFERENCE's specs and shapes (each leaf's size over the product of
    its spec's axis sizes);
  * a reduced cell's FLOPs on meta (``step_cost``, the dry run's count)
    equal the count of the same step on real CPU tensors, exactly
    (train, prefill and decode of reduced qwen3, train of reduced zamba2
    and seamless);
  * ``dryrun_aqp`` on the CPU under the fake group: the round's input
    bytes (64K rows x 12 B), its two all-reduces' bytes (``(3 + 2) x
    1024`` float32: the sums, then the minima and negated maxima) and
    the three terms, on both meshes;
  * each record's ``step_cost``, per device: a train cell's the sharded
    step's (its all-reduce and all-gather bytes by the arithmetic of
    the step), a serving cell's a steady call of the tensor-parallel
    sharded decode's, with the per-device memory fields filled and the
    one-time load of the rank's "model" cut beside it (all-gathers over
    dp, an all-to-all over "model" a leaf cut over both, by the
    arithmetic of the port's specs); qwen3-0.6b's ``decode_32k`` on 16
    x 16 takes the sequence rule (8 kv heads do not divide 16), and its
    steady decode call's collectives (q and the softmax partials
    all-gathered a layer, the partial sums of ``wo`` and ``w_down``
    all-reduced, the embedding's rows added, the logits' vocab
    gathered) stay under 5 % of the device's cache shard.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import get as jget
from repro.distributed import sharding as jsh
from repro.models import build as jbuild
from repro.models import input_specs as jinput_specs
from repro.train import OptConfig as JOptConfig
from repro.train import abstract_state as jabstract_state
from repro.train import optimizer as jopt
from repro_torch.configs import ShapeConfig, get
from repro_torch.launch import dryrun, step_cost
from repro_torch.models import build
from tests.helpers.sharded_load import load_arithmetic
from tests.helpers.torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _run(args, tmp_path, timeout=600):
    out = tmp_path / "out.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-m", *args, "--out", str(out)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


def _ref_bytes(mesh, spec_tree, shape_tree) -> int:
    """Per-device bytes of a reference tree laid out by its specs."""
    specs = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    leaves = jax.tree.leaves(shape_tree)
    assert len(specs) == len(leaves)
    total = 0
    for spec, leaf in zip(specs, leaves):
        n = math.prod(leaf.shape)
        for want in spec:
            if want is not None:
                axes = (want,) if isinstance(want, str) else want
                n //= math.prod(mesh.shape[a] for a in axes)
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.fixture(scope="module")
def qwen_records(tmp_path_factory):
    recs = []
    for shape in ("train_4k", "decode_32k"):
        recs += _run(["repro_torch.launch.dryrun", "--arch", "qwen3_0_6b",
                      "--shape", shape, "--both-meshes"],
                     tmp_path_factory.mktemp(shape))
    return {(r["shape"], r["mesh"]): r for r in recs}


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_qwen3_cells_ok_with_reference_bytes(qwen_records, shape, mesh):
    rec = qwen_records[(shape, mesh)]
    assert rec["ok"], rec.get("error")
    assert rec["n_devices"] == (512 if mesh == "2x16x16" else 256)
    fm = MESHES[mesh]
    cfg = jget("qwen3_0_6b")
    model = jbuild(cfg)
    jshape = JSHAPES[shape]
    mem = rec["memory"]
    specs = jinput_specs(cfg, jshape)
    assert mem["batch_bytes"] == _ref_bytes(
        fm, jsh.batch_specs(cfg, fm, jshape, specs), specs)
    if shape == "train_4k":
        ocfg = JOptConfig.for_arch(cfg)
        state = jabstract_state(model, ocfg)
        pspecs = jsh.param_specs(cfg, fm, state["params"])
        assert mem["param_bytes"] == _ref_bytes(fm, pspecs, state["params"])
        assert mem["opt_bytes"] == _ref_bytes(
            fm, jopt.state_specs(pspecs, state["params"], ocfg),
            state["opt"])
        assert mem["cache_bytes"] == 0
        assert rec["flops"] > 6 * 0.6e9 * 4096 * 256   # the 6 N T floor
    else:
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        assert mem["param_bytes"] == _ref_bytes(
            fm, jsh.param_specs(cfg, fm, params), params)
        cache = jax.eval_shape(lambda: model.init_cache(
            jshape.global_batch, jshape.seq_len))
        assert mem["cache_bytes"] == _ref_bytes(
            fm, jsh.cache_specs(cfg, fm, jshape, cache), cache)
        assert mem["opt_bytes"] == 0
    assert mem["state_bytes_per_device"] == sum(
        mem[k] for k in ("batch_bytes", "param_bytes", "opt_bytes",
                         "cache_bytes"))
    cost = rec["step_cost"]
    # per device for every kind of cell: the sharded step's cost
    assert cost["scope"] == "per_device" and rec["null_reason"] is None
    assert mem["temp_bytes"] == cost["temp_bytes"] > 0
    assert mem["peak_bytes_per_device"] == cost["peak_bytes"] > \
        mem["state_bytes_per_device"]
    assert rec["collective_bytes"] == cost["collective_bytes"] > 0
    if shape == "decode_32k":
        # a rank decodes its dp slice (8 of 128 rows on the dp axes):
        # fewer FLOPs than the global step's share of the model axis
        assert 0 < cost["flops"] < rec["flops"]
        colls = cost["param_gather"]["collectives"]
        want = load_arithmetic(fm, get("qwen3_0_6b"))
        for kind in ("all-gather", "all-to-all"):
            assert [colls[kind]["count"], colls[kind]["bytes"]] == \
                want[kind], (kind, colls, want)
        assert colls["all-reduce"]["count"] == 0


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_qwen3_train_step_cost_per_device(qwen_records, mesh):
    """The sharded step's collectives: one all-reduce of every gradient
    in float32 with the five loss metrics; all-gathers of this rank's
    parameter shards, of the five fields of the loss CI state and of
    the gradient norm's partial sum (float32)."""
    rec = qwen_records[("train_4k", mesh)]
    colls = rec["step_cost"]["collectives"]
    n_params = sum(p.numel() for p in build(get("qwen3_0_6b")).init(
        0, device="meta").parameters())
    assert colls["all-reduce"] == {"count": 1,
                                   "bytes": (n_params + 5) * 4}
    assert colls["all-gather"]["bytes"] == \
        rec["memory"]["param_bytes"] + 5 * 4 + 4
    assert all(colls[k]["count"] == 0 for k in (
        "reduce-scatter", "all-to-all", "collective-permute"))
    # data parallel over "data" (and "pod"): a rank runs its dp slice
    n_dp = rec["n_devices"] // 16
    assert rec["step_cost"]["flops"] * n_dp == rec["flops"]


def test_qwen3_decode_collectives_are_a_small_share_of_the_cache(
        qwen_records):
    """qwen3-0.6b's ``decode_32k`` on 16 x 16 (a meta run in the fake
    group): its 8 kv heads do not divide the 16 "model" ranks, so the
    cache is cut by sequence, and a steady decode call all-gathers each
    layer's q (each rank computes one of the 16 heads) and softmax
    partials, never a cache leaf, and all-reduces the float32 partial
    sums of ``wo`` and ``w_down`` a layer and of the embedding's rows;
    the logits' vocab blocks are gathered once. Its collective bytes,
    the one-time load apart, are under 5 % of the device's cache shard
    (gathering a leaf would move 16 times its shard)."""
    rec = qwen_records[("decode_32k", "16x16")]
    cost = rec["step_cost"]
    cache = rec["memory"]["cache_bytes"]
    colls = cost["collectives"]
    cfg = get("qwen3_0_6b")
    B_r, L, H, hd = 8, cfg.n_layers, cfg.n_heads, cfg.head_dim
    assert colls["all-gather"]["count"] == 2 * L + 1
    assert colls["all-reduce"]["count"] == 2 * L + 1
    assert all(colls[k]["count"] == 0 for k in colls
               if k not in ("all-gather", "all-reduce"))
    assert 0 < rec["collective_bytes"] < 0.05 * cache
    # a layer's q (bf16, one head a rank) and partials (m, l, o) of B_r
    # rows x 16 heads; the rank's vocab block of the logits (float32)
    assert colls["all-gather"]["bytes"] == L * (
        B_r * hd * 2 + B_r * H * (hd + 2) * 4) + \
        B_r * cfg.vocab_padded // 16 * 4
    # float32 partial sums of (B_r, 1, d)
    assert colls["all-reduce"]["bytes"] == (2 * L + 1) * B_r * cfg.d_model * 4


@pytest.mark.parametrize("arch,kind", [
    ("qwen3_0_6b", "train"), ("qwen3_0_6b", "prefill"),
    ("qwen3_0_6b", "decode"), ("zamba2_7b", "train"),
    ("seamless_m4t_large_v2", "train")])
def test_meta_flops_equal_real_cpu_flops(one_torch_thread, arch, kind):
    """The dry run's count on meta is the count of the same step on real
    tensors (reduced config, 2 x 64 tokens; decode at a 64-slot
    cache)."""
    model = build(get(arch, reduced=True))
    shape = ShapeConfig("t", 64, 2, kind)
    meta = step_cost.analyze(dryrun.step_trees(model, shape, "meta")[1])
    real = step_cost.analyze(dryrun.step_trees(model, shape, "cpu")[1])
    assert meta["flops"] == real["flops"] > 0


def test_dryrun_aqp_records_bytes_and_terms(tmp_path):
    recs = _run(["repro_torch.launch.dryrun_aqp", "--both", "--device",
                 "cpu"], tmp_path)
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    for r in recs:
        assert r["ok"] and r["device"] == "cpu"
        assert r["rows_per_device"] == 65536 and r["groups"] == 1024
        assert r["input_bytes_per_device"] == 65536 * 12
        assert r["collective_calls"] == 2
        assert r["collective_bytes"] == (3 + 2) * 1024 * 4
        assert r["out_shape"] == [1024]
        terms = r["terms_s"]
        assert terms["memory"]["s"] == 65536 * 12 / 3.35e12
        assert terms["collective"]["s"] == (3 + 2) * 1024 * 4 / 450e9
        assert terms["compute"]["ops"] == 6 * 65536
        assert "move nothing" in r["note"]
        cost = r["step_cost"]
        assert cost["collectives"]["all-reduce"] == {
            "count": 2, "bytes": (3 + 2) * 1024 * 4}
        assert cost["kernels"] == {} and r["card"] is None
        assert cost["input_bytes"] == 65536 * 12
    assert recs[0]["total_rows"] == 16 * 65536
    assert recs[1]["total_rows"] == 32 * 65536


def test_dryrun_cli_records_a_failing_cell(tmp_path):
    """A cell that cannot run is recorded with its error and the run goes
    on (the exit code says that not every cell passed)."""
    out = tmp_path / "out.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3_0_6b", "--shape", "long_500k", "--out", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-2000:]
    (rec,) = json.loads(out.read_text())
    assert not rec["ok"] and "skips long_500k" in rec["error"]
