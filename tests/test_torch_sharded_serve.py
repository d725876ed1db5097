"""The port's sharded serving steps (``build_sharded_serve``: the
prefill and decode steps on one held module) on a gloo world of 4 CPU ranks
(``tests/helpers/torch_dist_world.py``; the commands are
``tests/helpers/torch_sharded_serve_ops.py``), against the
single-process port and the reference.

One reduced float32 config a family, each with 2 kv heads of 4 where it
has attention: qwen3-0.6b (dense), pixtral-12b (vlm), dbrx-132b (MoE),
zamba2-7b (hybrid: Mamba2 and the shared attention), falcon-mamba-7b
(ssm: Mamba1) and seamless-m4t-large-v2 (enc-dec). On the ("data",
"model") mesh (2, 2) the 2 kv heads divide the 2 "model" ranks: the
heads rule; on (1, 4) they do not divide 4: the sequence rule
(``sharding.cache_specs``). Each case prefills 8 x 32 positions (the
enc-dec 16 frames and 16 tokens) with room for 8 teacher-forced decode
steps, and holds:

  * every rank's logits (its dp rows, prefill and each step) to the
    single-process port's and to the reference's ``prefill`` /
    ``decode`` on the same weights at 1e-5 of the largest;
  * every rank's cache shards, after the prefill and after the last
    step, to ``sharding.local_shape`` of their spec and to the slices
    of the single-process cache at 1e-5 of the leaf's largest;
  * the ranks of one dp coordinate to the same logits and shards, bit
    for bit;
  * rank 0's collectives of a steady prefill and decode call, by kind
    (``collectives.tally``), to the meta prediction of
    ``dryrun.sharded_serve_cost`` in a fake group of 4
    (``tests/helpers/torch_serve_cost_fake.py``);
  * no collective of a decode step has the shape of a cache leaf (the
    caches are never gathered).

And: zamba2's ring cache (``max_len`` 100,000, a sliding window of 16
slots) past its wrap, on both meshes, held to the port's and the
reference's full cache with the same window (the reference's own ring
is wrong past its wrap); and one decode step at position 0 into an empty
cache on (1, 4), where three of the four sequence shards are fully
masked, at an int and a tensor position.

In bfloat16, as the configs serve: qwen3-0.6b on both meshes,
falcon-mamba-7b on (2, 2) and zamba2-7b on (1, 4). The heads rule and
the Mamba1 / Mamba2 paths give the single-process port's logits and
cache bit for bit. The sequence rule's merge rounds each rank's softmax
weights (not the normalized probabilities) before multiplying by v, so
it differs from the single card by rounding: its logits are held to lie
no further from the reference, and from the float32 run of the same
weights, than 1.5x the single-process port's distance
(``BF16_SPREAD``), and its cache shards within ``TOL_BF16_CACHE``.
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import build as jax_build
from repro.models import make_batch as jax_make_batch
from repro.configs import ShapeConfig as JShapeConfig
from repro_torch.configs import ArchConfig
from repro_torch.models import build, convert
from tests.helpers import torch_sharded_serve_ops as ops
from tests.helpers.torch_dist_world import DistWorld

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3_0_6b", "pixtral_12b", "dbrx_132b", "zamba2_7b",
         "falcon_mamba_7b", "seamless_m4t_large_v2"]
MESHES = [(2, 2), (1, 4)]
F32, BF16 = "float32", "bfloat16"
CASES = [(a, m, False, F32) for a in ARCHS for m in MESHES] + [
    ("zamba2_7b", m, True, F32) for m in MESHES] + [
    ("qwen3_0_6b", (2, 2), False, BF16), ("qwen3_0_6b", (1, 4), False, BF16),
    ("falcon_mamba_7b", (2, 2), False, BF16),
    ("zamba2_7b", (1, 4), False, BF16)]
CASE_TIMEOUT_S = 120
TOL = 1e-5
#: bfloat16 under the sequence rule (whose merge rounds each rank's own
#: weights; every other path gives the single card's bits): the logits
#: no further from the reference, and from the float32 run of the same
#: weights, than 1.5x the single-process port's distance (the bf16
#: hybrid's precedent in test_torch_hybrid_encdec.py; measured 1.02x and
#: 1.22x to the reference, 0.87x and 0.78x to float32, for qwen3 and
#: zamba2); the cache shards within 6e-2 of a leaf's largest value
#: (1.5x the largest reading: 1.4e-2 qwen3, 4.1e-2 zamba2)
BF16_SPREAD = 1.5
TOL_BF16_CACHE = 6e-2


def _seq_rule(case) -> bool:
    """Whether the case's attention cache is cut over the sequence (the
    kv heads, 2, do not divide the mesh's "model" ranks)."""
    arch, mesh, _, _ = case
    return arch != "falcon_mamba_7b" and 2 % mesh[1] != 0


def _case_id(case) -> str:
    arch, mesh, ring, dtype = case
    return (f"{arch}:{mesh[0]}x{mesh[1]}" + (":ring" if ring else "")
            + (":bf16" if dtype == BF16 else ""))


IDS = [_case_id(c) for c in CASES]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = DistWorld(4, tmp_path_factory.mktemp("gloo4"))
    yield w
    w.close()


def _jcfg(arch: str, ring: bool, dtype: str):
    return dataclasses.replace(jax_get(arch, reduced=True),
                               **ops.case_fields(arch, ring, dtype))


def _reference(arch: str, ring: bool, dtype: str,
               weights: Path) -> np.ndarray:
    """The reference's prefill logits and each decode step's, (B, 1 +
    STEPS, V), from its weights (saved for the port at ``weights``). The
    ring case runs on a full cache of T + STEPS slots with the window."""
    jcfg = _jcfg(arch, ring, dtype)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    torch.save(convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg),
               weights)
    pre = jax_make_batch(jcfg, JShapeConfig("p", ops.T, ops.B, "prefill"),
                         seed=1)
    pre = {k: jnp.asarray(v) for k, v in pre.items() if k != "targets"}
    window = ops.window_of(ring)
    logits, cache = jm.prefill(jp, pre, window)
    out = [np.asarray(logits)]
    extra, start = {}, ops.T
    if cfg.family == "encdec":
        extra, start = {"memory": cache["memory"]}, 0
        cache = jm.init_cache(ops.B, ops.STEPS)
    elif "k" in cache.get("attn", cache.get("layers", {})):
        key = "attn" if "attn" in cache else "layers"
        room = jm.init_cache(ops.B, ops.T + ops.STEPS)[key]
        cache = {**cache, key: {k: room[k].at[..., :ops.T, :, :].set(
            cache[key][k]) for k in ("k", "v")}}
    toks = ops.step_tokens(cfg)
    for i in range(ops.STEPS):
        logits, cache = jm.decode(jp, cache, {
            "token": jnp.asarray(toks[:, i:i + 1]),
            "pos": jnp.asarray(start + i, jnp.int32), **extra}, window)
        out.append(np.asarray(logits))
    return np.concatenate(out, axis=1)


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """Each case's ranks' records and the reference's logits, once a
    module (the ranks' checks run there; a failing case fails each of
    its tests)."""
    done, refs = {}, {}
    tmp = tmp_path_factory.mktemp("serve")

    def get(case):
        arch, mesh, ring, dtype = case
        if (arch, ring, dtype) not in refs:
            path = tmp / f"{arch}{'_ring' if ring else ''}_{dtype}.pt"
            refs[(arch, ring, dtype)] = (_reference(arch, ring, dtype, path),
                                         path)
        if case not in done:
            ref, path = refs[(arch, ring, dtype)]
            done[case] = (world.run("sharded_serve", CASE_TIMEOUT_S,
                                    arch=arch, mesh_shape=list(mesh),
                                    weights=str(path), ring=ring,
                                    dtype=dtype), ref)
        return done[case]
    return get


@pytest.fixture(scope="module")
def predicted():
    """The meta prediction of every case (one process)."""
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "tests.helpers.torch_serve_cost_fake", *IDS],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_logits_match_single_process_and_reference(runs, case):
    out, ref = runs(case)
    scale = float(np.abs(ref).max())
    for rec in out:
        lo, hi = rec["rows"]
        got = np.asarray(rec["logits"], np.float32)
        assert got.shape == (hi - lo, 1 + ops.STEPS, ref.shape[-1])
        assert np.isfinite(got).all()
        assert rec["one_module"]        # the prefill's and decode's weights
        assert rec["prefill_err"] <= TOL * scale
        err = float(np.abs(got - ref[lo:hi]).max())
        if case[3] == F32:
            assert rec["single_err"] <= TOL * rec["single_max"], \
                rec["single_err"]
            assert err <= TOL * scale, (rec["rank"], err, scale)
        elif not _seq_rule(case):
            assert rec["single_err"] == 0.0, rec["single_err"]
        else:
            single = np.asarray(rec["single_logits"], np.float32)
            assert err <= BF16_SPREAD * float(np.abs(single - ref[lo:hi])
                                              .max()), (rec["rank"], err)
            assert rec["f32_err"] <= BF16_SPREAD * rec["single_f32_err"], \
                (rec["f32_err"], rec["single_f32_err"])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cache_shards_are_slices_of_the_single_process_cache(runs, case):
    out, _ = runs(case)
    tol = (TOL_BF16_CACHE if case[3] == BF16 and _seq_rule(case)
           else TOL if case[3] == F32 else 0.0)
    for rec in out:
        for when in ("prefill_shards", "decode_shards"):
            for leaf, (shape_ok, err, top) in rec[when].items():
                assert shape_ok, (rec["rank"], when, leaf)
                assert err <= tol * max(top, 1e-30), (rec["rank"], when,
                                                      leaf, err, top)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_replicas_hold_the_same_bits(runs, case):
    out, _ = runs(case)
    by_rows = collections.defaultdict(set)
    by_slice = collections.defaultdict(set)
    for rec in out:
        by_rows[tuple(rec["rows"])].add(rec["logits_crc"])
        for leaf, (bounds, crc) in rec["shard_crcs"].items():
            by_slice[(leaf, str(bounds))].add(crc)
    assert all(len(c) == 1 for c in by_rows.values()), by_rows
    assert all(len(c) == 1 for c in by_slice.values())
    # (2, 2): two dp slices of two replicas; (1, 4): one slice of four
    assert len(by_rows) == case[1][0]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_collectives_equal_the_meta_prediction(runs, predicted, case):
    out, _ = runs(case)
    rank0 = next(r for r in out if r["rank"] == 0)
    want = predicted[_case_id(case)]
    for kind in ("prefill", "decode"):
        got = rank0[f"{kind}_collectives"]
        colls = want[kind]["collectives"]
        assert got == {k: colls[k] for k in got}, (kind, got, colls)
        assert all(colls[k]["count"] == 0 for k in colls if k not in got)
    # a decode step gathers over "model" (and the MoE over dp) only
    assert rank0["decode_collectives"]["all-gather"]["count"] > 0
    assert rank0["decode_collectives"]["all-reduce"]["count"] == 0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_decode_gathers_no_cache_leaf(runs, case):
    out, _ = runs(case)
    for rec in out:
        assert rec["n_operands"] > 0
        assert rec["cache_leaf_operands"] == [], rec["cache_leaf_operands"]


def test_fully_masked_sequence_shards_at_position_zero(world, tmp_path):
    """(1, 4) cuts qwen3's 40 slots in four: at position 0 the shards of
    ranks 1-3 are all masked and add zero weight (no NaN)."""
    cfg = ops.case_config("qwen3_0_6b")
    path = tmp_path / "w.pt"
    torch.save(build(cfg).init(0, device="cpu").state_dict(), path)
    out = world.run("sharded_serve", CASE_TIMEOUT_S, arch="qwen3_0_6b",
                    mesh_shape=[1, 4], weights=str(path), masked=True)
    for rec in out:
        assert rec["cut"] == -3                  # the sequence rule
        assert rec["finite"] == [True, True]
        assert max(rec["errs"]) <= TOL * rec["scale"], rec["errs"]
        for leaf, (shape_ok, err, top) in rec["shards"].items():
            assert shape_ok and err <= TOL * max(top, 1e-30), leaf
