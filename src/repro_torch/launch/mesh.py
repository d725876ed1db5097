"""Mesh definitions: the production meshes and a small host mesh.

The port of :mod:`repro.launch.mesh`. A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the ranks of the
initialized default group, one rank a device: the caller starts the
processes and initializes the group (``torchrun``, or
``init_process_group`` with its own store); the dry runs join a
``fake``-backend group of 256 or 512 ranks in one process. Like the
reference's, these are functions, never module constants, so importing
this module touches no device and no group.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: the production meshes' (shape, axis names)
SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def _make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
               device_type: str) -> DeviceMesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a {shape} mesh needs an initialized default group of "
            f"{math.prod(shape)} ranks (start one process a device, e.g. "
            "with torchrun, and call init_process_group first)")
    n = dist.get_world_size()
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                         f"ranks, but the process group has {n}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 ("data", "model") for one pod (256 devices) or 2x16x16
    ("pod", "data", "model") for two (512). Raises unless the default
    group has exactly that many ranks."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return _make_mesh(shape, axes, device_type)


def make_host_mesh(shape: Sequence[int], axes: Sequence[str],
                   device_type: str = "cuda") -> DeviceMesh:
    """A small mesh over the default group's ranks (tests, the smoke
    run); ``prod(shape)`` must be the group's size."""
    return _make_mesh(tuple(int(s) for s in shape), tuple(axes),
                      device_type)
