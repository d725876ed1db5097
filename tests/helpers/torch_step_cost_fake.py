"""``step_cost`` under a ``fake``-backend group (its collectives move
nothing), in a process of its own: a default group in a pytest worker
would leak into other tests. Joins a group of 4 ranks as rank 0 and
prints one JSON object:

  * ``"kinds"``: the cost of one call of each collective that the
    port's code could dispatch (``torch.distributed``'s calls and the
    functional collectives), on the CPU and on meta, with their operand
    sizes, for the test to hold each kind's count and bytes;
  * ``"sharded"``: ``{arch: cost}`` of rank 0's sharded train step on
    meta tensors (``torch_sharded_train_ops.sharded_step``), the
    prediction that the test holds against the gloo ranks' real step.

  python -m tests.helpers.torch_step_cost_fake ARCH [ARCH ...]

Imports no JAX.
"""

import json
import sys

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.launch import step_cost
from tests.helpers.torch_sharded_train_ops import sharded_step

WORLD = 4


def every_kind(dev: str) -> None:
    """Each collective once or more, on ``dev``: float32 operands of 8
    (all-gathers, all-reduces), 16 (reduce-scatters: 4 a rank, one given
    as a list of 4), 16 (all-to-all) and 3 (send) elements; a recv and a
    barrier, which carry no payload of this rank's."""
    t = torch.ones(8, device=dev)
    big = torch.ones(16, device=dev)
    dist.all_gather([torch.empty_like(t) for _ in range(WORLD)], t)
    dist.all_gather_into_tensor(torch.empty(8 * WORLD, device=dev), t)
    funcol.all_gather_tensor(t, 0, dist.group.WORLD).sum()
    dist.all_reduce(t)
    funcol.all_reduce(t, "sum", dist.group.WORLD).sum()
    out = torch.empty(4, device=dev)
    dist.reduce_scatter_tensor(out, big)
    dist.reduce_scatter(out, [torch.ones(4, device=dev)
                              for _ in range(WORLD)])
    dist.all_to_all_single(torch.empty(16, device=dev), big)
    dist.send(torch.ones(3, device=dev), dst=1)
    dist.recv(torch.ones(3, device=dev), src=1)
    dist.barrier()


def main(archs) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    out = {"kinds": {dev: step_cost.analyze(lambda: every_kind(dev))
                     for dev in ("cpu", "meta")},
           "sharded": {}}
    for arch in archs:
        run, inputs = sharded_step(arch, "meta")
        out["sharded"][arch] = step_cost.analyze(run, inputs=inputs)
    dist.destroy_process_group()
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
