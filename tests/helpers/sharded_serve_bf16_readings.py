"""The readings behind the bfloat16 bounds of
``tests/test_torch_sharded_serve.py``: for each of its bfloat16 cases,
on a gloo world of 4 CPU ranks, the largest distance over the ranks of
the sharded logits from the single-process port's, from the reference's
and from the float32 run of the same weights, the single-process port's
own distances, and the cache shards' distance from the single-process
slices, each relative to the largest logit or leaf value. Prints one
JSON line a case.

  PYTHONPATH=src:. python -m tests.helpers.sharded_serve_bf16_readings
"""

import json
import sys
import tempfile
from pathlib import Path

import numpy as np

from tests import test_torch_sharded_serve as serve
from tests.helpers.torch_dist_world import DistWorld


def readings(world: DistWorld, case, tmp: Path) -> dict:
    arch, mesh, ring, dtype = case
    path = tmp / f"{arch}_{dtype}.pt"
    ref = serve._reference(arch, ring, dtype, path)
    out = world.run("sharded_serve", serve.CASE_TIMEOUT_S, arch=arch,
                    mesh_shape=list(mesh), weights=str(path), ring=ring,
                    dtype=dtype)
    scale = float(np.abs(ref).max())

    def worst(fn):
        return max(fn(rec) for rec in out)

    def to_ref(rec, key):
        lo, hi = rec["rows"]
        return float(np.abs(np.asarray(rec[key], np.float32)
                            - ref[lo:hi]).max()) / scale
    return {
        "case": serve._case_id(case),
        "sharded_vs_single": worst(lambda r: r["single_err"]
                                   / r["single_max"]),
        "sharded_vs_ref": worst(lambda r: to_ref(r, "logits")),
        "single_vs_ref": worst(lambda r: to_ref(r, "single_logits")),
        "sharded_vs_f32": worst(lambda r: r["f32_err"] / scale),
        "single_vs_f32": worst(lambda r: r["single_f32_err"] / scale),
        "cache_shards": worst(lambda r: max(
            err / max(top, 1e-30) for when in ("prefill_shards",
                                               "decode_shards")
            for _, err, top in r[when].values())),
    }


def main() -> None:
    cases = [c for c in serve.CASES if c[3] == serve.BF16]
    with tempfile.TemporaryDirectory() as tmp:
        world = DistWorld(4, tmp)
        try:
            for case in cases:
                print(json.dumps(readings(world, case, Path(tmp))),
                      flush=True)
        finally:
            world.close()


if __name__ == "__main__":
    sys.exit(main())
