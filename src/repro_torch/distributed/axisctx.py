"""Logical-axis sharding constraints for activations.

The port of :mod:`repro.distributed.axisctx`. Model code calls
``constrain(x, "batch", "seq", "heads", None)`` with *logical* axis
names; the launcher installs a rules context mapping logical names to
mesh axes (:func:`logical_axis_rules`, :func:`default_rules`). Outside
any context, and for a plain tensor, the call returns ``x`` itself, so
the model code runs unchanged on one device. A DTensor is redistributed
to the rule's placements (an axis that does not divide its dim is
dropped, as in the reference), the counterpart of
``with_sharding_constraint``.

The port's sharded train step (:func:`repro_torch.train.trainer.
build_sharded_train_step`) computes on plain tensors (data parallel over
the dp axes, each rank's parameters gathered whole), and its sharded
serving steps (:mod:`repro_torch.models.zoo`) are tensor parallel on
plain tensors too, each layer computing on the cut its parameters hold
and adding its partial sums itself, so on both paths every call is the
identity.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Sequence, Union

from repro_torch.distributed.sharding import (P, _axis_size, mesh_dp_axes,
                                              placements)

_tls = threading.local()

Axes = Union[str, Sequence[str], None]


def default_rules(mesh, *, shard_activations: bool = False
                  ) -> Dict[str, Axes]:
    return {
        "batch": mesh_dp_axes(mesh),
        "seq": None,
        "embed": "model" if shard_activations else None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "inner": "model",       # ssm d_inner
        "ssm_heads": "model",
        "kv_seq": "model",      # decode KV cache sequence axis
    }


@contextlib.contextmanager
def logical_axis_rules(mesh, rules: Dict[str, Axes]):
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (mesh, rules)
    try:
        yield
    finally:
        _tls.ctx = prev


def logical_spec(mesh, rules: Dict[str, Axes], shape, logical_axes) -> P:
    """The spec the rules give a tensor of ``shape`` (axes that do not
    divide dropped; unlisted trailing dims replicated)."""
    parts = []
    for dim, name in zip(shape, logical_axes):
        want = rules.get(name) if name else None
        if want is not None and mesh is not None \
                and dim % max(_axis_size(mesh, want), 1) != 0:
            want = None
        parts.append(want)
    parts += [None] * (len(shape) - len(parts))
    return P(*parts)


def constrain(x, *logical_axes):
    """``x`` laid out per the active rules: a DTensor is redistributed to
    the rule's placements; a plain tensor, or any call outside a
    context, returns ``x`` itself."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    mesh = x.device_mesh if mesh is None else mesh
    spec = logical_spec(mesh, rules, tuple(x.shape), logical_axes)
    want = placements(mesh, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
