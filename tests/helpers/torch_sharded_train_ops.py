"""Commands of a gloo rank for the port's multi-card layout
(``tests/test_torch_sharded_train.py``), run by
``tests/helpers/torch_dist_worker.py`` on each rank of a
:class:`tests.helpers.torch_dist_world.DistWorld` (4 CPU ranks).

``op_sharded_train`` is the mirror of the reference's
``tests/helpers/dist_train_worker.py`` for one reduced config: the
sharded train step on a (2, 2) ("data", "model") mesh against the
single-process step of the same state and batch (loss 1e-4; parameters
rtol 2e-4, atol 2e-5 and the moments within 2e-4 of their leaf's
largest after the first step; the losses of the later steps 1e-4, and
the parameters after them at the same tolerances, AdamW's widened by
what its unit-size update carries from each element's moments,
``tests/helpers/torch_train_parity.py``), then the elastic checkpoint:
saved from (2, 2), restored on (4, 1), one more step on each layout
(losses within 1e-4). It returns each leaf's shard checksums for the
test to hold replicas equal across ranks.

Imports no JAX.
"""

import dataclasses
import zlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ShapeConfig, get
from repro_torch.distributed import axisctx, checkpoint as ckpt
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build
from repro_torch.models.zoo import make_batch
from repro_torch.train import OptConfig, init_state
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import (build_sharded_train_step,
                                       build_train_step)
from tests.helpers.torch_train_parity import close_adamw_params

SHAPE = ShapeConfig("t", 64, 8, "train")
# the reference worker's tolerances (dist_train_worker.py)
LOSS_TOL, RTOL, ATOL = 1e-4, 2e-4, 2e-5


def config(arch: str):
    """A reduced float32 config without remat, as the reference worker
    runs it; dbrx in 2 microbatches (its experts sharded over "model")."""
    cfg = dataclasses.replace(get(arch, reduced=True), param_dtype="float32",
                              compute_dtype="float32", remat=False)
    if arch == "qwen3_0_6b":     # the reference worker's own widths
        cfg = dataclasses.replace(cfg, n_layers=2, n_heads=4, n_kv_heads=2,
                                  head_dim=32, d_ff=256, vocab=512)
    if arch == "dbrx_132b":
        cfg = dataclasses.replace(cfg, microbatches=2)
    return cfg


def _spec_tree(cfg, mesh, params, ocfg):
    pspecs = sh.param_specs(cfg, mesh, params)
    return {"params": pspecs,
            "opt": opt.state_specs(pspecs, params, ocfg), "step": sh.P()}


def _whole(tree) -> dict:
    """``{name: numpy}`` of a state's leaves: DTensors gathered whole."""
    flat = {}

    def walk(t, prefix):
        if isinstance(t, torch.nn.Module):
            t = dict(t.named_parameters())
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}/")
        else:
            flat[prefix[:-1]] = t
    walk(tree, "")
    names = list(flat)
    dts = [n for n in names if hasattr(flat[n], "to_local")]
    full = dict(zip(dts, sh.full_tensors([flat[n] for n in dts])))
    return {n: (full[n] if n in full else flat[n]).detach().to(
        torch.float32).numpy().copy() for n in names}


def _shard_sums(tree, mesh) -> dict:
    """``{leaf: [slice bounds, crc32]}`` of this rank's shards."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}/")
            return
        loc = t.to_local() if hasattr(t, "to_local") else t
        spec = (sh.spec_of(mesh, t.placements, t.dim())
                if hasattr(t, "to_local") else sh.P())
        idx = sh.shard_slices(mesh, spec.padded(t.dim()), t.shape,
                              mesh.get_coordinate())
        bounds = [[s.start, s.stop] for s in idx]
        out[prefix[:-1]] = [bounds, zlib.crc32(
            loc.detach().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())]
    walk(tree, "")
    return out


def _max_rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def op_sharded_train(arch: str, ckpt_dir: str, steps: int = 3):
    cfg = config(arch)
    model = build(cfg)
    ocfg = OptConfig.for_arch(cfg, lr=1e-2, warmup_steps=2, total_steps=20)
    batch = make_batch(cfg, SHAPE, seed=0, device="cpu")
    ref = init_state(model, 0, ocfg, device="cpu")
    mesh = make_host_mesh((2, 2), ("data", "model"), device_type="cpu")
    spec = _spec_tree(cfg, mesh, ref["params"], ocfg)
    state = sh.distribute(mesh, spec, init_state(model, 0, ocfg,
                                                 device="cpu"))
    bspec = sh.batch_specs(cfg, mesh, SHAPE, batch)
    ref_step = build_train_step(model, ocfg)
    step = build_sharded_train_step(model, ocfg, mesh, spec, bspec)
    rec = {"losses": [], "loss_diff": []}
    hist = {}                    # AdamW: (lr, m_got, m_ref, v_got, v_ref)
    for i in range(steps):
        ref, rm = ref_step(ref, batch)
        with axisctx.logical_axis_rules(mesh, axisctx.default_rules(mesh)):
            state, sm = step(state, batch)
        d = abs(float(sm["loss"]) - float(rm["loss"]))
        rec["losses"].append(float(sm["loss"]))
        rec["loss_diff"].append(d)
        assert d < LOSS_TOL, (i, float(sm["loss"]), float(rm["loss"]))
        got, want = _whole(state), _whole(ref)
        if ocfg.name == "adamw":
            for n in ref["opt"]["m"]:
                hist.setdefault(n, []).append(
                    (float(rm["lr"]), got[f"opt/m/{n}"], want[f"opt/m/{n}"],
                     got[f"opt/v/{n}"], want[f"opt/v/{n}"]))
        for n, w in want.items():
            if n.startswith("opt/"):
                assert _max_rel(got[n], w) <= RTOL, (i, n, _max_rel(got[n], w))
            elif n.startswith("params/"):
                if i == 0 or ocfg.name != "adamw":
                    np.testing.assert_allclose(got[n], w, rtol=RTOL,
                                               atol=ATOL, err_msg=f"{i} {n}")
                else:
                    pn = n[len("params/"):]
                    close_adamw_params(torch.from_numpy(got[n]), w,
                                       hist[pn], RTOL, f"{i} {n}")
        for k in ("grad_norm", "lr"):
            assert abs(float(sm[k]) - float(rm[k])) <= 1e-4 * max(
                abs(float(rm[k])), 1e-6), (i, k, float(sm[k]), float(rm[k]))
        assert int(sm["loss_ci_state"].count) == int(
            rm["loss_ci_state"].count)
    rec["replicas"] = _shard_sums(state, mesh)
    # the elastic checkpoint: (2, 2) -> (4, 1), one more step on each
    ckpt.save_checkpoint(ckpt_dir, steps, state, spec_tree=spec)
    mesh2 = make_host_mesh((4, 1), ("data", "model"), device_type="cpu")
    spec2 = _spec_tree(cfg, mesh2, ref["params"], ocfg)
    restored, _ = ckpt.restore_checkpoint(ckpt_dir, steps, state,
                                          mesh=mesh2, spec_tree=spec2)
    bspec2 = sh.batch_specs(cfg, mesh2, SHAPE, batch)
    step2 = build_sharded_train_step(model, ocfg, mesh2, spec2, bspec2)
    back = _whole(restored)
    for n, w in _whole(state).items():
        assert np.array_equal(back[n], w), n
    restored, m2 = step2(restored, batch)
    state, m1 = step(state, batch)
    rec["elastic"] = [float(m1["loss"]), float(m2["loss"])]
    assert abs(rec["elastic"][0] - rec["elastic"][1]) < LOSS_TOL, \
        rec["elastic"]
    rec["replicas_41"] = _shard_sums(restored, mesh2)
    rec["rank"] = dist.get_rank()
    return rec


def op_multi_axis_order():
    """A (4, 8) arange laid out by ``P(None, ("model", "data"))`` on a
    (2, 2) mesh: this rank's shard and coordinate, and the shard DTensor's
    own ``distribute_tensor`` gives for the same placements."""
    from torch.distributed.tensor import distribute_tensor
    mesh = make_host_mesh((2, 2), ("data", "model"), device_type="cpu")
    x = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    spec = sh.P(None, ("model", "data"))
    mine = sh.distribute_leaf(mesh, spec, x)
    theirs = distribute_tensor(x, mesh, sh.placements(mesh, spec))
    return {"coord": list(mesh.get_coordinate()),
            "local": mine.to_local().tolist(),
            "dtensor": theirs.to_local().tolist(),
            "full": sh.full_tensors([mine])[0].tolist()}


def op_constrain():
    """``constrain`` on a (2, 2) mesh: a plain tensor comes back as it is
    inside the rules; a replicated DTensor of shape (4, 6, 8) constrained
    ``("batch", "seq", "heads")`` gets the rule's placements, and one
    whose dim does not divide drops that axis; outside the rules the
    DTensor itself comes back."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh = make_host_mesh((2, 2), ("data", "model"), device_type="cpu")
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    dt = distribute_tensor(x, mesh, (Replicate(), Replicate()))
    out = {"outside_same": axisctx.constrain(dt, "batch") is dt}
    with axisctx.logical_axis_rules(mesh, axisctx.default_rules(mesh)):
        out["plain_same"] = axisctx.constrain(x, "batch", "seq") is x
        c = axisctx.constrain(dt, "batch", "seq", "heads")
        out["placements"] = [repr(p) for p in c.placements]
        out["values_equal"] = bool(torch.equal(c.full_tensor(), x))
        odd = distribute_tensor(torch.zeros(3, 6, 8), mesh,
                                (Replicate(), Replicate()))
        out["odd_placements"] = [repr(p) for p in axisctx.constrain(
            odd, "batch", "seq", "heads").placements]
    return out


def op_mesh_checks():
    """Meshes over this 4-rank group: a (3, 1) and the production mesh
    refused, a (2, 2) built."""
    from repro_torch.launch.mesh import make_production_mesh
    out = {}
    for key, fn in (("wrong_size", lambda: make_host_mesh(
            (3, 1), ("data", "model"), device_type="cpu")),
            ("production", lambda: make_production_mesh(device_type="cpu"))):
        try:
            fn()
            out[key] = None
        except ValueError as e:
            out[key] = type(e).__name__
    out["host_2x2"] = list(make_host_mesh((2, 2), ("data", "model"),
                                          device_type="cpu").shape)
    return out


def sharded_step(arch: str, device: str):
    """``(run, inputs)`` of one sharded step of ``arch``'s config on a
    (2, 2) mesh over the default group (4 ranks), on ``device``: the
    state from seed 0 (``meta``: its shapes), the batch of ``SHAPE``."""
    cfg = config(arch)
    model = build(cfg)
    ocfg = OptConfig.for_arch(cfg, lr=1e-2, warmup_steps=2, total_steps=20)
    batch = make_batch(cfg, SHAPE, seed=0, device=device)
    mesh = make_host_mesh((2, 2), ("data", "model"), device_type="cpu")
    whole = init_state(model, 0, ocfg, device=device)
    spec = _spec_tree(cfg, mesh, whole["params"], ocfg)
    state = sh.distribute(mesh, spec, whole)
    del whole
    step = build_sharded_train_step(model, ocfg, mesh, spec,
                                    sh.batch_specs(cfg, mesh, SHAPE, batch))
    return (lambda: step(state, batch)), (state, batch)


def op_step_cost(arch: str):
    """``step_cost`` of one sharded step on this rank's CPU tensors, and
    what ``collectives.COLLECTIVES`` tallied in it."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch import step_cost
    run, inputs = sharded_step(arch, "cpu")
    c0 = coll.tally()
    cost = step_cost.analyze(run, inputs=inputs)
    got = coll.tally(since=c0)
    return {"cost": cost, "rank": dist.get_rank(),
            "tally": {k: got[k] for k in ("calls", "bytes")}}


OPS = {"sharded_train": op_sharded_train, "mesh_checks": op_mesh_checks,
       "multi_axis_order": op_multi_axis_order,
       "constrain": op_constrain, "step_cost": op_step_cost}
