"""Production-mesh dry run: every (arch x shape x mesh) cell at full
size on the ``meta`` device.

The port of :mod:`repro.launch.dryrun`. For each cell the step
(``train_step``, ``prefill`` or ``decode``) runs once on meta tensors
(shapes and dtypes only, no storage) under
:func:`repro_torch.launch.step_cost.analyze` and the activation rules
(:mod:`repro_torch.distributed.axisctx`): the state from
:func:`repro_torch.train.abstract_state` or ``model.init(device=
"meta")``, the batch from :func:`repro_torch.models.make_batch` and the
decode cache from ``model.init_cache`` on meta. Then the specs of the
parameters, optimizer state, batch and cache
(:mod:`repro_torch.distributed.sharding`) lay those trees out as meta
DTensors on the production mesh (:func:`repro_torch.launch.mesh.
make_production_mesh`), in a ``fake``-backend group of 256 or 512 ranks
joined by this process, and each record has:

  * ``params``, ``active_params``;
  * per-device bytes of the parameters, optimizer state, batch and cache
    (from the local shapes) and their sum;
  * ``flops``: the global matmul FLOPs of one step, the step run whole
    on one device (``FlopCounterMode``'s formulas, as the reference's
    ``hlo_cost`` counts dots; eager meta runs every layer, so no loop
    trip count is needed); ``step_cost.flops`` is its own scope's;
  * ``step_cost``: :func:`repro_torch.launch.step_cost.analyze` of one
    step (FLOPs, bytes, collectives by kind, peak and temp bytes), the
    counterpart of the reference's ``hlo_cost`` and memory analysis,
    with its ``scope``:

      - a train cell: ``"per_device"``, the program of one device, as
        the reference's post-SPMD module is: rank 0's
        :func:`repro_torch.train.trainer.build_sharded_train_step` on
        meta DTensors laid out by the cell's specs, in the fake group.
        It fills ``memory.temp_bytes``, ``memory.peak_bytes_per_device``
        and ``collective_bytes``;
      - a prefill or decode cell: ``"per_device"`` too, a steady call
        of rank 0's :func:`repro_torch.models.zoo.build_sharded_prefill`
        / ``build_sharded_decode`` on meta DTensors laid out by the
        cell's parameter, batch and cache specs (the second call, once
        the step holds its ``"model"`` cut of the parameters): tensor
        parallel over ``"model"`` on the rank's dp slice of the batch
        and its cache shard, with the all-reduces of partial sums and
        the all-gathers of small activations. It fills the same three
        fields; the one-time load of the rank's cut is beside it, as
        ``step_cost.param_gather`` (its all-gathers over dp, its
        all-to-alls over ``"model"`` where a dim is cut over both, and
        their bytes);
  * ``seconds`` of the step and of the layout, and ``ok``; a failing
    cell records its error and the sweep goes on.

Every cell runs its global step once and its sharded step on each
mesh.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_0_6b \\
      --shape train_4k [--multi-pod | --both-meshes] [--out PATH]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --shape decode_32k \\
      --both-meshes                     # every arch with the shape
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

``--out`` (default ``build/dryrun/dryrun.json``) receives every record of
the run as a JSON list.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.axisctx import default_rules, logical_axis_rules
from repro_torch.launch import step_cost
from repro_torch.launch.mesh import SINGLE_POD, make_production_mesh
from repro_torch.models import build, make_batch
from repro_torch.models.zoo import (build_sharded_decode,
                                    build_sharded_prefill, window_for)
from repro_torch.train import (OptConfig, abstract_state, build_train_step,
                               init_state)
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import build_sharded_train_step


class MeshShape:
    """A size-only mesh (axis names and sizes), enough for the rules."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def join_fake_group(world: int) -> None:
    """Join a ``fake``-backend default group of ``world`` ranks as rank 0
    (its collectives move nothing), leaving any other group first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def tree_bytes(tree) -> int:
    """Bytes of the local shards of a tree of (DTensor) leaves."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    loc = tree.to_local() if hasattr(tree, "to_local") else tree
    return loc.numel() * loc.element_size()


def device_bytes(mesh, spec_tree, tree) -> int:
    """Per-device bytes of ``tree`` (a state, batch or cache; meta or
    not) laid out on ``mesh`` by ``spec_tree``: the sum of its local
    shards' sizes. A module stands for its named parameters."""
    return tree_bytes(sh.distribute(mesh, spec_tree, _on_meta(tree)))


def _on_meta(tree):
    """The tree's leaves as meta tensors (the layout only reads shapes)."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return {k: _on_meta(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), dtype=tree.dtype, device="meta")


def state_spec(cfg, mesh, state, ocfg) -> Dict:
    """The train state's spec tree: parameters, optimizer, step."""
    pspecs = sh.param_specs(cfg, mesh, state["params"])
    return {"params": pspecs,
            "opt": opt_mod.state_specs(pspecs, state["params"], ocfg),
            "step": sh.P()}


@dataclasses.dataclass
class Cell:
    """One (arch, shape) step run on meta, with its trees."""
    arch: str
    shape: str
    cfg: object
    kind: str
    trees: Dict            # "state" / "params", "batch", "cache"
    ocfg: Optional[OptConfig]
    cost: Dict             # step_cost of the global step
    step_s: float

    @property
    def flops(self) -> int:
        return self.cost["flops"]


def step_trees(model, shape, device: str = "meta", seed: int = 0):
    """``(trees, run)``: the trees of a cell's step on ``device`` (the
    train state, or the parameters and, to decode, the cache; the batch)
    and ``run()``, which takes the step once. On ``"meta"`` nothing is
    drawn; elsewhere the state comes from ``seed``."""
    cfg = model.cfg
    window = window_for(cfg, shape.seq_len)
    batch = make_batch(cfg, shape, seed=seed, device=device)
    if shape.kind == "train":
        ocfg = OptConfig.for_arch(cfg)
        state = (abstract_state(model, ocfg) if device == "meta"
                 else init_state(model, seed, ocfg, device=device))
        step = build_train_step(model, ocfg, window=window)
        return {"state": state, "batch": batch}, lambda: step(state, batch)
    params = model.init(seed, device=device)
    if shape.kind == "prefill":
        return ({"params": params, "batch": batch},
                lambda: model.prefill(params, batch, window))
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             device=device)
    return ({"params": params, "batch": batch, "cache": cache},
            lambda: model.decode(params, cache, batch, window))


def run_step(arch_id: str, shape_name: str, overrides=None) -> Cell:
    """Build the cell's meta trees and run its step once under
    :func:`step_cost.analyze` and the single pod's activation rules."""
    cfg = get(arch_id)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    if shape_name not in cfg.shapes():
        raise ValueError(f"{arch_id} skips {shape_name} "
                         "(full-attention long-context rule)")
    rules_mesh = MeshShape(*SINGLE_POD)
    t0 = time.perf_counter()
    trees, run = step_trees(build(cfg), shape)
    with logical_axis_rules(rules_mesh, default_rules(
            rules_mesh, shard_activations=cfg.shard_activations)):
        cost = step_cost.analyze(run, inputs=trees)
    ocfg = OptConfig.for_arch(cfg) if shape.kind == "train" else None
    return Cell(arch_id, shape_name, cfg, shape.kind, trees, ocfg, cost,
                time.perf_counter() - t0)


def sharded_step_cost(cell: Cell, mesh, sspec: Dict, bspec: Dict) -> Dict:
    """step_cost of this rank's sharded train step on ``mesh`` (a mesh
    over the fake group): the cell's meta state laid out by ``sspec`` as
    meta DTensors, the whole meta batch."""
    shape = SHAPES[cell.shape]
    model = build(cell.cfg)
    state = sh.distribute(mesh, sspec, cell.trees["state"])
    batch = cell.trees["batch"]
    step = build_sharded_train_step(
        model, cell.ocfg, mesh, sspec, bspec,
        window=window_for(cell.cfg, shape.seq_len))
    return step_cost.analyze(lambda: step(state, batch),
                             inputs=(state, batch))


def sharded_serve_cost(cell: Cell, mesh, shape=None,
                       max_len: Optional[int] = None) -> Dict:
    """step_cost of a steady call of this rank's sharded prefill or
    decode on ``mesh`` (a mesh over the fake group): the cell's meta
    parameters (and decode cache) laid out by their specs as meta
    DTensors, the whole meta batch. The step first holds its
    ``"model"`` cut of the parameters (``step.load``, whose collectives
    and bytes come back under ``param_gather``); the call measured is
    the next one.
    ``shape``: the cell's ``ShapeConfig`` where it is not one of
    ``SHAPES``; ``max_len``: the prefill's room (its cache's slots)."""
    cfg, shape = cell.cfg, shape or SHAPES[cell.shape]
    model = build(cfg)
    t = cell.trees
    window = window_for(cfg, shape.seq_len)
    pspec = sh.param_specs(cfg, mesh, t["params"])
    params = sh.distribute(mesh, pspec, t["params"])
    batch = t["batch"]
    bspec = sh.batch_specs(cfg, mesh, shape, batch)
    if cell.kind == "prefill":
        step = build_sharded_prefill(model, mesh, pspec, bspec,
                                     window=window, max_len=max_len)
        args = (params, batch)
    else:
        cspec = sh.cache_specs(cfg, mesh, shape, t["cache"])
        step = build_sharded_decode(model, mesh, pspec, bspec, cspec,
                                    window=window)
        args = (params, sh.distribute(mesh, cspec, t["cache"]), batch)
    gather = step_cost.analyze(lambda: step.load(params), inputs=params)
    cost = step_cost.analyze(lambda: step(*args),
                             inputs=(args, step.module))
    cost["param_gather"] = {k: gather[k] for k in (
        "collectives", "collective_bytes", "peak_bytes", "temp_bytes")}
    return cost


def layout(cell: Cell, mesh, multi_pod: bool) -> Dict:
    """The cell's record on ``mesh``: per-device bytes of each tree."""
    t0 = time.perf_counter()
    cfg, shape = cell.cfg, SHAPES[cell.shape]
    t = cell.trees
    bspec = sh.batch_specs(cfg, mesh, shape, t["batch"])
    mem = {"batch_bytes": device_bytes(mesh, bspec, t["batch"])}
    if cell.kind == "train":
        sspec = state_spec(cfg, mesh, t["state"], cell.ocfg)
        mem["param_bytes"] = device_bytes(mesh, sspec["params"],
                                          t["state"]["params"])
        mem["opt_bytes"] = device_bytes(mesh, sspec["opt"],
                                        t["state"]["opt"])
        cost = dict(sharded_step_cost(cell, mesh, sspec, bspec),
                    scope="per_device")
    else:
        mem["param_bytes"] = device_bytes(
            mesh, sh.param_specs(cfg, mesh, t["params"]), t["params"])
        mem["opt_bytes"] = 0
        cost = dict(sharded_serve_cost(cell, mesh), scope="per_device")
    mem["cache_bytes"] = (device_bytes(mesh, sh.cache_specs(
        cfg, mesh, shape, t["cache"]), t["cache"]) if "cache" in t else 0)
    mem["state_bytes_per_device"] = sum(mem.values())
    mem["temp_bytes"] = cost["temp_bytes"]
    mem["peak_bytes_per_device"] = cost["peak_bytes"]
    return {
        "arch": cell.arch, "shape": cell.shape, "mesh": mesh_name(multi_pod),
        "n_devices": int(mesh.size()), "kind": cell.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "memory": mem, "flops": cell.flops, "flops_scope": "global",
        "step_cost": cost, "collective_bytes": cost["collective_bytes"],
        "null_reason": None,
        "step_s": cell.step_s, "layout_s": time.perf_counter() - t0,
        "ok": True}


def _failure(e: Exception) -> Dict:
    return {"ok": False, "error": f"{type(e).__name__}: {e}",
            "trace": traceback.format_exc()[-2000:]}


def run_cells(cells, multi_pods, overrides=None, log=print) -> List[Dict]:
    """Every (arch, shape) of ``cells`` on every mesh of ``multi_pods``:
    each step once, then its layout on each mesh. A cell that fails is
    recorded with its error and the sweep goes on. Joins (and leaves
    joined) a fake group of the last mesh's size."""
    steps, records = {}, []
    for arch_id, shape_name in cells:
        log(f"=== {arch_id} x {shape_name} (meta step) ===")
        try:
            steps[(arch_id, shape_name)] = run_step(arch_id, shape_name,
                                                    overrides)
        except Exception as e:  # recorded; the sweep goes on
            steps[(arch_id, shape_name)] = _failure(e)
            log(f"FAILED: {type(e).__name__}: {e}")
    for multi_pod in multi_pods:
        join_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        for (arch_id, shape_name), cell in steps.items():
            rec = {"arch": arch_id, "shape": shape_name,
                   "mesh": mesh_name(multi_pod)}
            if isinstance(cell, dict):
                rec.update(cell)
            else:
                try:
                    rec = layout(cell, mesh, multi_pod)
                except Exception as e:  # recorded; the sweep goes on
                    rec.update(_failure(e))
            if overrides:
                rec["overrides"] = {k: repr(v) for k, v in overrides.items()}
            log(json.dumps({k: v for k, v in rec.items()
                            if k not in ("trace", "null_reason")}))
            records.append(rec)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun/dryrun.json")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value (python literal)")
    args = ap.parse_args(argv)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in get(a).shapes()]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.shape:
        cells = [(a, args.shape) for a in ARCH_IDS
                 if args.shape in get(a).shapes()]
    else:
        ap.error("give --shape (with --arch for one cell), or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records = run_cells(cells, meshes, overrides,
                        log=lambda s: print(s, flush=True))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    n_ok = sum(1 for r in records if r.get("ok"))
    print(f"\n{n_ok}/{len(records)} cells OK -> {out}")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0 if n_ok == len(records) else 1


if __name__ == "__main__":
    raise SystemExit(main())
