"""Parameters of the reference into the port.

:func:`params_from_jax` turns a parameter tree of :mod:`repro.models`
(nested dicts whose leaves are numpy arrays, e.g. ``jax.tree.map(
np.asarray, params)``) into a state dict of the port's modules, so that
the tests can run both packages on the same weights. Imports nothing of
JAX: the caller hands over numpy arrays.

Layouts need no change: the port keeps the reference's ``(in, out)``
weights (:mod:`repro_torch.models.layers`). Stacked layers, which carry a
leading ``n_layers`` axis under ``"layers"``, split into the
``ModuleList``'s entries (``layers.<i>.…``). Each leaf keeps its dtype:
a bfloat16 array (numpy's ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects) travels as its 16-bit pattern.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _to_torch(arr) -> torch.Tensor:
    """One numpy leaf as a CPU tensor of the same dtype and bits."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _flatten(v, name + ".")
        else:
            yield name, v


def params_from_jax(params: Mapping, cfg: ArchConfig
                    ) -> Dict[str, torch.Tensor]:
    """State dict for :class:`repro_torch.models.lm.LM` (from the
    reference's ``lm_init`` tree) or for
    :class:`repro_torch.models.ssm.Mamba1Block` (from ``mamba1_init``'s
    dict): load it with ``module.load_state_dict(...)``."""
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in _flatten(params):
        t = _to_torch(leaf)
        if name.startswith("layers."):
            if t.shape[0] != cfg.n_layers:
                raise ValueError(f"{name}: leading axis {t.shape[0]} is not "
                                 f"n_layers={cfg.n_layers}")
            rest = name[len("layers."):]
            for i in range(cfg.n_layers):
                out[f"layers.{i}.{rest}"] = t[i].clone()
        else:
            out[name] = t
    return out
