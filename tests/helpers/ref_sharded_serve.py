"""Subprocess: the REFERENCE's partitioned serving program on 4 fake CPU
devices, for ``tests/test_torch_sharded_serve.py``.

For each case ``ARCH:ROWSxCOLS`` (a reduced float32 config with the
test's fields, ``tests/helpers/torch_sharded_serve_ops.case_fields``),
the reference's ``prefill`` and ``decode`` jitted with ``in_shardings``
from its ``param_specs``, ``batch_specs`` and ``cache_specs`` on a
``("data", "model")`` mesh of that shape, under
``logical_axis_rules(default_rules(mesh))``: XLA's partitioner computes
each layer on a device's ``"model"`` cut and adds the partial sums.
The weights are ``init(PRNGKey(0))`` (the test saves the same ones for
the port), the prompt and the teacher-forced decode tokens the ones the
port's ranks run. Writes the logits (B, 1 + STEPS, V) of each case to
``OUT/<case>.npy``.

  python -m tests.helpers.ref_sharded_serve OUT ARCH:ROWSxCOLS ...
"""

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import dataclasses  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ShapeConfig, get  # noqa: E402
from repro.distributed import sharding as shard  # noqa: E402
from repro.distributed.axisctx import (default_rules,  # noqa: E402
                                       logical_axis_rules)
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import build, make_batch  # noqa: E402
from tests.helpers import torch_sharded_serve_ops as ops  # noqa: E402


def run(arch: str, mesh_shape) -> np.ndarray:
    cfg = dataclasses.replace(get(arch, reduced=True),
                              **ops.case_fields(arch))
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    mesh = make_host_mesh(mesh_shape, ("data", "model"))
    pshape = ShapeConfig("p", ops.T, ops.B, "prefill")
    pre = {k: jnp.asarray(v) for k, v in
           make_batch(cfg, pshape, seed=1).items() if k != "targets"}
    pspecs = shard.param_specs(cfg, mesh, params)
    enc = cfg.family == "encdec"
    dshape = ShapeConfig("d", ops.decode_len(cfg), ops.B, "decode")
    toks = ops.step_tokens(cfg)
    with mesh, logical_axis_rules(mesh, default_rules(mesh)):
        prefill = jax.jit(lambda p, b: model.prefill(p, b, None),
                          in_shardings=(shard.named(mesh, pspecs),
                                        shard.named(mesh, shard.batch_specs(
                                            cfg, mesh, pshape, pre))))
        logits, cache = prefill(params, pre)
        out = [np.asarray(logits)]
        extra, start = {}, ops.T
        if enc:
            extra, start = {"memory": cache["memory"]}, 0
            cache = model.init_cache(ops.B, ops.STEPS)
        else:
            key = "attn" if "attn" in cache else "layers"
            if "k" in cache[key]:
                room = model.init_cache(ops.B, ops.T + ops.STEPS)[key]
                cache = {**cache, key: {k: room[k].at[..., :ops.T, :, :].set(
                    cache[key][k]) for k in ("k", "v")}}
        batch = {"token": jnp.asarray(toks[:, :1]),
                 "pos": jnp.asarray(start, jnp.int32), **extra}
        cspecs = shard.cache_specs(cfg, mesh, dshape, cache)
        decode = jax.jit(
            lambda p, c, b: model.decode(p, c, b, None),
            in_shardings=(shard.named(mesh, pspecs),
                          shard.named(mesh, cspecs),
                          shard.named(mesh, shard.batch_specs(
                              cfg, mesh, dshape, batch))))
        for i in range(ops.STEPS):
            batch = {"token": jnp.asarray(toks[:, i:i + 1]),
                     "pos": jnp.asarray(start + i, jnp.int32), **extra}
            cache = jax.device_put(cache, shard.named(mesh, cspecs))
            logits, cache = decode(params, cache, batch)
            out.append(np.asarray(logits))
    return np.concatenate(out, axis=1)


def main(out: str, cases) -> None:
    assert jax.device_count() == 4, jax.devices()
    for case in cases:
        arch, mesh = case.split(":")
        np.save(Path(out) / f"{case.replace(':', '_')}.npy",
                run(arch, tuple(int(x) for x in mesh.split("x"))))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
