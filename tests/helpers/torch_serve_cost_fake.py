"""The sharded serving steps' meta prediction under a ``fake``-backend
group of 4 ranks, in a process of its own (a default group in a pytest
worker would leak into other tests): for each case of
``tests/test_torch_sharded_serve.py`` (its reduced config on its mesh,
as rank 0), ``repro_torch.launch.dryrun.sharded_serve_cost`` of the
prefill and of a decode step, the shapes that the gloo ranks run
(``tests/helpers/torch_sharded_serve_ops.py``). Prints one JSON object,
``{"<arch>:<rows>x<cols>[:ring][:bf16]": {"prefill": cost, "decode":
cost}}``.

  python -m tests.helpers.torch_serve_cost_fake ARCH:ROWSxCOLS[:ring][:bf16] ...

Imports no JAX.
"""

import json
import sys

import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build
from tests.helpers import torch_sharded_serve_ops as ops


def predict(arch: str, mesh_shape, ring: bool, dtype: str) -> dict:
    cfg = ops.case_config(arch, ring, dtype)
    model = build(cfg)
    mesh = make_host_mesh(mesh_shape, ("data", "model"), device_type="cpu")
    out = {}
    for kind, shape in (("prefill", ops.PREFILL),
                        ("decode", ops.decode_shape(cfg, ring))):
        trees, _ = dryrun.step_trees(model, shape, "meta")
        cell = dryrun.Cell(arch, shape.name, cfg, kind, trees, None, {},
                           0.0)
        out[kind] = dryrun.sharded_serve_cost(cell, mesh, shape)
    return out


def main(cases) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    out = {}
    for case in cases:
        arch, mesh, *flags = case.split(":")
        shape = tuple(int(x) for x in mesh.split("x"))
        out[case] = predict(arch, shape, "ring" in flags,
                            "bfloat16" if "bf16" in flags else "float32")
    dist.destroy_process_group()
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
