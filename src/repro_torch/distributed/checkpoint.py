"""Checkpointing of a trainer state: atomic step directories, one file a
leaf, crc32 per leaf, an asynchronous writer.

The port of :mod:`repro.distributed.checkpoint`, in its format:

    <dir>/step_00000123/
        manifest.json      # step, meta, leaves [{name, file, shape, dtype, crc32}]
        leaf_00000.npy     # one file per leaf, in manifest order
        _COMMITTED         # written last; readers ignore dirs without it

Writes go to ``step_xxx.tmp``, which is renamed after the commit marker
is written, so a preempted writer never corrupts the latest checkpoint.
The state is copied to host memory on the caller's thread (the trainer
updates its parameters in place, so the copy is what makes the snapshot
consistent); with ``async_write`` the files are written on a thread.

A state is the trainer's (:func:`repro_torch.train.init_state`): nested
dicts whose leaves are tensors, and modules, whose leaves are their
``state_dict`` entries. Leaf names join the keys with ``/``:
``params/<parameter name>``, ``opt/m/<parameter name>``,
``opt/vr/<leaf>``, ``step``.

bfloat16 leaves, which numpy cannot hold, are written as their uint16
bit patterns with ``"dtype": "bfloat16"`` in the manifest and come back
bit for bit. The reference writes them as ``ml_dtypes`` bfloat16, which
``np.load`` returns as raw ``|V2`` bytes that JAX cannot take back.

Placement on a mesh, an elastic reshard: ``save_checkpoint(...,
spec_tree=)`` writes each leaf's spec into the manifest (``"spec"``, the
reference's ``spec_to_json`` form), and ``restore_checkpoint(...,
mesh=, spec_tree=)`` lays each leaf out on ``mesh`` by its spec
(replicated when it has none) as a DTensor
(:func:`repro_torch.distributed.sharding.distribute_leaf`). A sharded
state (DTensor leaves, one rank a device) is saved whole: every leaf's
full tensor is gathered (:func:`~repro_torch.distributed.sharding.
full_tensors`), rank 0 writes it, and every rank waits on the commit,
so any layout restores onto any other. Without ``mesh``,
:func:`restore_checkpoint` puts each leaf on the device of the matching
leaf of ``like_state``.
"""

from __future__ import annotations

import json
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.distributed.sharding import (P, distribute_leaf,
                                              full_tensors)

_COMMIT = "_COMMITTED"


def _leaves(state, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` of every leaf of ``state`` in a fixed order."""
    if isinstance(state, nn.Module):
        return [(prefix + k, v) for k, v in
                state.state_dict(keep_vars=True).items()]
    if isinstance(state, dict):
        out = []
        for k, v in state.items():
            out += _leaves(v, f"{prefix}{k}/")
        return out
    if isinstance(state, torch.Tensor):
        return [(prefix[:-1], state)]
    raise TypeError(f"{prefix[:-1] or 'state'}: a checkpoint holds tensors, "
                    f"dicts and modules, not {type(state).__name__}")


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` as numpy and the manifest's dtype name."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def spec_to_json(spec) -> list:
    return [list(s) if isinstance(s, tuple) else s for s in spec]


def _specs(spec_tree) -> Dict[str, Any]:
    """``{leaf name: spec}`` of a spec tree shaped like the state."""
    out = {}

    def walk(tree, prefix: str):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}/")
        else:
            out[prefix[:-1]] = tree
    walk(spec_tree, "")
    return out


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def save_checkpoint(directory, step: int, state, spec_tree=None,
                    meta: Optional[Dict[str, Any]] = None,
                    async_write: bool = False) -> Callable[[], None]:
    """Serialize ``state``; returns a ``join()`` that waits for the
    write (at once when ``async_write`` is false). ``spec_tree`` (shaped
    like the state) adds each leaf's spec to the manifest. A state with
    DTensor leaves is gathered whole on every rank and written by rank 0;
    the other ranks write nothing, and every rank's ``join()`` (or the
    call itself, when not ``async_write``) waits until the step is
    committed."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    leaves = _leaves(state)
    specs = _specs(spec_tree) if spec_tree is not None else None
    sharded = any(_is_dtensor(t) for _, t in leaves)
    if sharded:
        import torch.distributed as dist
        rank0 = dist.get_rank() == 0
        host = []
        for name, t in leaves:
            # one leaf gathered at a time: its whole tensor is one leaf's
            whole = full_tensors([t])[0] if _is_dtensor(t) else t
            if rank0:
                host.append((name, *_to_host(whole)))
            del whole
        if not rank0:
            if async_write:
                return dist.barrier
            dist.barrier()
            return lambda: None
    else:
        # snapshot to host memory on the caller's thread (consistent)
        host = [(name, *_to_host(t)) for name, t in leaves]
    directory.mkdir(parents=True, exist_ok=True)

    def write():
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "meta": meta or {}, "leaves": []}
        for i, (name, arr, dtype) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, arr, allow_pickle=False)
            entry = {"name": name, "file": fname, "shape": list(arr.shape),
                     "dtype": dtype, "crc32": zlib.crc32(arr.tobytes())}
            if specs is not None:
                entry["spec"] = spec_to_json(specs[name])
            manifest["leaves"].append(entry)
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        (tmp / _COMMIT).write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        if not sharded:
            return t.join
        import torch.distributed as dist

        def join():
            t.join()
            dist.barrier()
        return join
    write()
    if sharded:
        import torch.distributed as dist
        dist.barrier()
    return lambda: None


def latest_step(directory) -> Optional[int]:
    """The newest committed step under ``directory``, or ``None``."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if p.is_dir() and (p / _COMMIT).exists()]
    return max(steps) if steps else None


def _load(path: Path, entry: Dict, verify: bool) -> torch.Tensor:
    arr = np.load(path / entry["file"], allow_pickle=False)
    if verify and zlib.crc32(arr.tobytes()) != entry["crc32"]:
        raise IOError(f"checksum mismatch for {entry['name']}")
    if entry["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(directory, step: int, like_state, mesh=None,
                       spec_tree=None, verify: bool = True
                       ) -> Tuple[Any, Dict]:
    """Restore step ``step`` into the structure of ``like_state`` (every
    leaf by name, shapes equal): returns ``(state, meta)``. Tensor leaves
    come back as new tensors on the devices of ``like_state``'s; a
    module is filled in place (its parameters keep their identity) and
    returned. With ``mesh`` (a ``DeviceMesh``; one rank a device) every
    leaf comes back as a DTensor laid out by its spec in ``spec_tree``
    (replicated without one), a module as a ``{name: DTensor}`` dict:
    the elastic reshard; a meta ``like_state`` (``abstract_state``) puts
    the shards on the mesh's device. Raises ``FileNotFoundError`` for an uncommitted
    step, ``IOError`` on a checksum mismatch, ``ValueError`` on a shape
    or dtype mismatch."""
    path = Path(directory) / f"step_{step:08d}"
    if not (path / _COMMIT).exists():
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    manifest = json.loads((path / "manifest.json").read_text())
    by_name = {e["name"]: e for e in manifest["leaves"]}

    specs = _specs(spec_tree) if spec_tree is not None else {}

    def leaf(name: str, like: torch.Tensor) -> torch.Tensor:
        t = _load(path, by_name[name], verify)
        if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} in the "
                             f"checkpoint, {tuple(like.shape)} "
                             f"{like.dtype} in the state")
        if mesh is None:
            return t.to(like.device)
        dev = like.to_local().device if _is_dtensor(like) else like.device
        if dev.type == "meta":       # a shape-only like: the mesh's device
            dev = torch.device(mesh.device_type, torch.cuda.current_device()
                               if mesh.device_type == "cuda" else None)
        return distribute_leaf(mesh, specs.get(name, P()), t.to(dev))

    def rebuild(like, prefix: str):
        if isinstance(like, nn.Module) and mesh is not None:
            return {k: leaf(prefix + k, v) for k, v in
                    like.state_dict(keep_vars=True).items()}
        if isinstance(like, nn.Module):
            with torch.no_grad():
                for k, v in like.state_dict(keep_vars=True).items():
                    v.copy_(leaf(prefix + k, v))
            return like
        if isinstance(like, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in like.items()}
        return leaf(prefix[:-1], like)

    return rebuild(like_state, ""), manifest["meta"]
