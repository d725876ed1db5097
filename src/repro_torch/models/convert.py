"""Parameters and trainer states of the reference into the port.

:func:`params_from_jax` turns a parameter tree of :mod:`repro.models`
(nested dicts whose leaves are numpy arrays, e.g. ``jax.tree.map(
np.asarray, params)``) into a state dict of the port's modules, so that
the tests can run both packages on the same weights. Imports nothing of
JAX: the caller hands over numpy arrays.

Layouts need no change: the port keeps the reference's ``(in, out)``
weights (:mod:`repro_torch.models.layers`). Stacked layers, which carry
leading layer axes, split into the ``ModuleList``'s entries:
``layers.<i>.…`` (``(n_layers,)``), the hybrid's ``layers.<g>.<i>.…``
(``(n_groups, period)``) and ``tail_layers.<i>.…``, the enc-dec's
``enc_layers.<i>.…`` and ``dec_layers.<i>.…``. Each leaf keeps its dtype:
a bfloat16 array (numpy's ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects) travels as its 16-bit pattern.

:func:`train_state_from_jax` does the same for a whole trainer state of
:mod:`repro.train` (parameters, optimizer moments, step), so that one
step from the same state can run in both packages.
"""

from __future__ import annotations

import itertools
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import stacked_axes
from repro_torch.train.optimizer import leaf_shape, leaves, moment_shape


def _to_torch(arr) -> torch.Tensor:
    """One numpy leaf as a CPU tensor of the same dtype, shape (0-d
    included) and bits."""
    a = np.array(arr, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


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
    reference's ``lm_init`` tree), :class:`repro_torch.models.encdec.
    EncDec` (``encdec_init``) or a single block (e.g.
    :class:`repro_torch.models.ssm.Mamba1Block` from ``mamba1_init``'s
    dict): load it with ``module.load_state_dict(...)``. A stacked leaf
    whose leading axes are not the config's raises ``ValueError``."""
    stacks = stacked_axes(cfg)
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in _flatten(params):
        t = _to_torch(leaf)
        top, _, rest = name.partition(".")
        lead = stacks.get(top) if rest else None
        if lead is None:
            out[name] = t
            continue
        if tuple(t.shape[:len(lead)]) != lead:
            raise ValueError(f"{name}: leading axes {tuple(t.shape)} are not "
                             f"the config's {top} {lead}")
        for idx in itertools.product(*map(range, lead)):
            out[".".join([top, *map(str, idx), rest])] = t[idx].clone()
    return out


def train_state_from_jax(state: Mapping, cfg: ArchConfig,
                         lm: nn.Module) -> Dict:
    """A reference trainer state (``repro.train.init_state``'s tree after
    ``jax.tree.map(np.asarray, ...)``: ``params``, ``opt`` with AdamW's
    ``m`` / ``v`` or Adafactor's ``vr`` / ``vc``, ``step``) as the port's
    (:func:`repro_torch.train.init_state`'s layout): the parameters are
    loaded into ``lm``, the moments land beside them on its device under
    its parameter names (AdamW), or under the reference's own leaf names
    in its stacked shapes (Adafactor: ``layers.<rest>`` of shape
    ``moment_shape(key, (n_layers, ...))``, as
    :func:`repro_torch.train.optimizer.init` keeps them), each in its own
    dtype. A moment whose name or shape is not the port's raises
    ``ValueError``."""
    lm.load_state_dict(params_from_jax(state["params"], cfg))
    params = dict(lm.named_parameters())
    dev = next(iter(params.values())).device
    opt = {}
    for key, tree in state["opt"].items():
        if key in ("vr", "vc"):
            got = {name: _to_torch(leaf) for name, leaf in _flatten(tree)}
            want = {leaf: moment_shape(key, leaf_shape(ms, params))
                    for leaf, ms in leaves(params).items()}
        else:
            got = params_from_jax(tree, cfg)
            want = {name: moment_shape(key, p.shape)
                    for name, p in params.items()}
        if got.keys() != want.keys():
            raise ValueError(f"opt.{key}: leaves {sorted(got)} are not the "
                             f"port's {sorted(want)}")
        for name, shape in want.items():
            if tuple(got[name].shape) != shape:
                raise ValueError(f"opt.{key}.{name}: shape "
                                 f"{tuple(got[name].shape)} is not the "
                                 f"port's {shape}")
        opt[key] = {name: got[name].to(dev) for name in want}
    step = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                        device=dev)
    return {"params": lm, "opt": opt, "step": step}
