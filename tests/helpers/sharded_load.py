"""What a rank of the sharded serving steps holds and what loading it
moves, by the port's specs alone (``sharding.param_specs``): the test
copy of ``zoo._ServeOnMesh.load``'s arithmetic, shared by the sharded
serving tests and the dry-run tests."""

import math

from repro_torch.distributed import sharding as sh
from repro_torch.models import build


def load_arithmetic(mesh, cfg) -> dict:
    """``{"held": bytes, kind: [count, bytes]}`` for a rank of ``mesh``
    (axis names and sizes in ``mesh.shape``) serving ``cfg``: it holds
    each leaf's "model" cut; each dp axis of more than one rank cutting
    a leaf, the innermost first, all-gathers what the rank holds so far;
    a leaf with a dim cut over "model" and dp ranks together then passes
    its cut through one all-to-all over "model"."""
    names = tuple(mesh.shape)
    size = mesh.shape
    out = {"held": 0, "all-gather": [0, 0], "all-to-all": [0, 0]}
    module = build(cfg).init(0, device="meta")
    for name, spec in sh.param_specs(cfg, mesh, module).items():
        p = module.get_parameter(name)
        axes = [sh._axes(e) for e in spec]
        whole = p.numel() * p.element_size()
        out["held"] += whole // math.prod(size["model"] for x in axes
                                          if "model" in x)
        cur = whole // math.prod(size[a] for a in sum(axes, ()))
        for a in reversed(names):
            if a != "model" and size[a] > 1 and any(a in x for x in axes):
                out["all-gather"][0] += 1
                out["all-gather"][1] += cur
                cur *= size[a]
        if size.get("model", 1) > 1 and any(
                "model" in x and math.prod(size[a] for a in x
                                           if a != "model") > 1
                for x in axes):
            out["all-to-all"][0] += 1
            out["all-to-all"][1] += cur
    return out
