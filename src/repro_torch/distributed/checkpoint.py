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

Placement on a mesh (the reference's ``mesh=`` / ``spec_tree=``, an
elastic reshard on restore) waits for the port of
``distributed/sharding.py``: :func:`restore_checkpoint` puts each leaf
on the device of the matching leaf of ``like_state``.
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


def save_checkpoint(directory, step: int, state,
                    meta: Optional[Dict[str, Any]] = None,
                    async_write: bool = False) -> Callable[[], None]:
    """Serialize ``state``; returns a ``join()`` that waits for the
    write (at once when ``async_write`` is false)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    # snapshot to host memory on the caller's thread (consistent)
    host = [(name, *_to_host(t)) for name, t in _leaves(state)]

    def write():
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "meta": meta or {}, "leaves": []}
        for i, (name, arr, dtype) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, arr, allow_pickle=False)
            manifest["leaves"].append({
                "name": name, "file": fname, "shape": list(arr.shape),
                "dtype": dtype, "crc32": zlib.crc32(arr.tobytes())})
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        (tmp / _COMMIT).write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t.join
    write()
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


def restore_checkpoint(directory, step: int, like_state,
                       verify: bool = True) -> Tuple[Any, Dict]:
    """Restore step ``step`` into the structure of ``like_state`` (every
    leaf by name, shapes equal): returns ``(state, meta)``. Tensor leaves
    come back as new tensors on the devices of ``like_state``'s; a
    module is filled in place (its parameters keep their identity) and
    returned. Raises ``FileNotFoundError`` for an uncommitted step,
    ``IOError`` on a checksum mismatch, ``ValueError`` on a shape or
    dtype mismatch."""
    path = Path(directory) / f"step_{step:08d}"
    if not (path / _COMMIT).exists():
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    manifest = json.loads((path / "manifest.json").read_text())
    by_name = {e["name"]: e for e in manifest["leaves"]}

    def leaf(name: str, like: torch.Tensor) -> torch.Tensor:
        t = _load(path, by_name[name], verify)
        if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} in the "
                             f"checkpoint, {tuple(like.shape)} "
                             f"{like.dtype} in the state")
        return t.to(like.device)

    def rebuild(like, prefix: str):
        if isinstance(like, nn.Module):
            with torch.no_grad():
                for k, v in like.state_dict(keep_vars=True).items():
                    v.copy_(leaf(prefix + k, v))
            return like
        if isinstance(like, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in like.items()}
        return leaf(prefix[:-1], like)

    return rebuild(like_state, ""), manifest["meta"]
