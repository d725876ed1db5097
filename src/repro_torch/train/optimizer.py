"""Optimizers: AdamW (configurable moment dtype) and Adafactor (factored
second moments).

The port of :mod:`repro.train.optimizer`. Where the reference maps pure
functions over a parameter pytree, the port works on a flat ``{name:
tensor}`` dict (``dict(module.named_parameters())``): :func:`init`
builds the state dicts, :func:`apply` computes every update in float32,
writes the new parameters and moments **in place** (no second copy of
a 7B model's state) and returns ``(params, state, metrics)``. Each
update is the reference's per-leaf formula, operation for operation.

The optimizer-state sharding of the reference (``state_specs``) is not
ported (ROADMAP queue 1 item 14).

Adafactor sees the leaves the reference sees. The reference stacks a
layer parameter of every layer into one ``(n_layers, ...)`` leaf; the
port's layers are separate tensors (``layers.<i>.<rest>``), so
:func:`leaves` groups them back under the stacked name
``layers.<rest>``. :func:`init` keeps Adafactor's moments in the stacked
shapes under those names, and :func:`apply` computes each leaf's update
on the stack (a layer's vector is factored across the layer axis, and
the update clip spans all layers), then writes each layer's slice back.
The stack and the update's float32 temporaries are one leaf's size at
a time, never the whole model's. Parameters outside the layers stay single
leaves. AdamW is elementwise and works per tensor.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Mapping, Tuple

import torch

from repro_torch.configs.base import ArchConfig

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # bfloat16 for the giants

    @staticmethod
    def for_arch(cfg: ArchConfig, **overrides) -> "OptConfig":
        base = dict(name=cfg.optimizer, moment_dtype=cfg.moment_dtype)
        base.update(overrides)
        return OptConfig(**base)


def _mdt(ocfg: OptConfig) -> torch.dtype:
    return torch.bfloat16 if ocfg.moment_dtype == "bfloat16" else _F32


def lr_at(ocfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay, in float32 on ``step``'s device. At
    step 0 it is 0 whatever the warmup."""
    step = step.to(_F32)
    warm = torch.clamp(step / max(ocfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - ocfg.warmup_steps)
                    / max(ocfg.total_steps - ocfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return ocfg.lr * warm * (0.1 + 0.9 * cos)


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def moment_shape(key: str, shape) -> Tuple[int, ...]:
    """Shape of optimizer leaf ``key`` (``m``, ``v``, ``vr`` or ``vc``)
    for a leaf of ``shape``: AdamW's moments are the parameter's shape;
    Adafactor (given the stacked shape of :func:`leaf_shape`) factors a matrix into a row moment (``vr``, the last
    axis dropped) and a column moment (``vc``, the second last dropped)
    and keeps a vector's whole second moment in ``vr`` beside a 0-d
    ``vc``. So a layer vector, stacked to ``(n_layers, d)``, gets an
    ``(n_layers,)`` row and a ``(d,)`` column moment."""
    shape = tuple(shape)
    if key in ("m", "v"):
        return shape
    if key == "vr":
        return shape[:-1] if _factored(shape) else shape
    if key == "vc":
        return shape[:-2] + shape[-1:] if _factored(shape) else ()
    raise KeyError(f"no optimizer leaf {key!r}")


_LAYER = re.compile(r"layers\.(\d+)\.(.+)")


def leaves(names) -> Dict[str, List[str]]:
    """The reference's optimizer leaves over the port's parameter names:
    ``layers.<rest>`` -> ``[layers.0.<rest>, layers.1.<rest>, ...]`` (in
    layer order) for a scan-stacked layer parameter, ``name -> [name]``
    for any other. Raises ``ValueError`` if a stacked name misses a
    layer."""
    out: Dict[str, List[str]] = {}
    layer_of: Dict[str, Dict[int, str]] = {}
    for n in names:
        m = _LAYER.fullmatch(n)
        if m is None:
            out[n] = [n]
            continue
        leaf = f"layers.{m.group(2)}"
        out.setdefault(leaf, [])
        layer_of.setdefault(leaf, {})[int(m.group(1))] = n
    for leaf, by_layer in layer_of.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{leaf}: layers {sorted(by_layer)} are not "
                             f"0..{len(by_layer) - 1}")
        out[leaf] = [by_layer[i] for i in range(len(by_layer))]
    return out


def leaf_shape(members, params: Mapping[str, torch.Tensor]
               ) -> Tuple[int, ...]:
    """Shape of the leaf of :func:`leaves`' ``members``: the reference's
    stacked ``(n_layers, ...)`` for layer parameters, else the
    parameter's own."""
    shape = tuple(params[members[0]].shape)
    return (len(members),) + shape if _LAYER.fullmatch(members[0]) \
        else shape


def init(params: Mapping[str, torch.Tensor], ocfg: OptConfig) -> Dict:
    """Zero state on the parameters' device: AdamW's ``m`` and ``v``
    beside each parameter, in the moment dtype; Adafactor's float32 row
    / column second moments of each leaf of :func:`leaves`, in the
    reference's stacked shapes (:func:`moment_shape`)."""
    if ocfg.name == "adamw":
        return {k: {n: torch.zeros(p.shape, dtype=_mdt(ocfg),
                                   device=p.device)
                    for n, p in params.items()} for k in ("m", "v")}
    groups = leaves(params)
    return {k: {leaf: torch.zeros(moment_shape(k, leaf_shape(ms, params)),
                                  dtype=_F32, device=params[ms[0]].device)
                for leaf, ms in groups.items()} for k in ("vr", "vc")}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(_F32)))
                          for x in tensors))


@torch.no_grad()
def apply(params: Mapping[str, torch.Tensor],
          grads: Mapping[str, torch.Tensor], opt_state: Dict,
          step: torch.Tensor, ocfg: OptConfig) -> Tuple[Dict, Dict, Dict]:
    """One update: clip by the global norm, then AdamW or Adafactor.
    ``params`` and ``opt_state`` are updated in place and returned with
    the metrics ``{"grad_norm", "lr"}`` (0-d float32 tensors)."""
    gnorm = global_norm(grads[n] for n in params)
    scale = torch.clamp(ocfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(ocfg, step)
    metrics = {"grad_norm": gnorm, "lr": lr}

    if ocfg.name == "adamw":
        t = (step + 1).to(_F32)
        bc1 = 1.0 - ocfg.b1 ** t
        bc2 = 1.0 - ocfg.b2 ** t
        for n, p in params.items():
            m, v = opt_state["m"][n], opt_state["v"][n]
            g = grads[n].to(_F32) * scale
            m2 = ocfg.b1 * m.to(_F32) + (1 - ocfg.b1) * g
            v2 = ocfg.b2 * v.to(_F32) + (1 - ocfg.b2) * g * g
            u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + ocfg.eps)
            u = u + ocfg.weight_decay * p.to(_F32)
            p.copy_(p.to(_F32) - lr * u)
            m.copy_(m2)
            v.copy_(v2)
        return params, opt_state, metrics

    # -- adafactor (factored 2nd moments, no 1st moment) ----------------------
    b2 = 0.999
    for leaf, members in leaves(params).items():
        vr, vc = opt_state["vr"][leaf], opt_state["vc"][leaf]
        ps = [params[n] for n in members]
        shape = leaf_shape(members, params)
        if len(shape) > ps[0].dim():      # stacked: one f32 buffer
            g = torch.empty(shape, dtype=_F32, device=ps[0].device)
            for i, n in enumerate(members):
                g[i].copy_(grads[n])
            g.mul_(scale)
        else:
            g = grads[members[0]].to(_F32) * scale
        g2 = g * g + 1e-30
        if _factored(shape):
            vr2 = b2 * vr + (1 - b2) * g2.mean(dim=-1)
            vc2 = b2 * vc + (1 - b2) * g2.mean(dim=-2)
            denom = torch.clamp(vr2.mean(dim=-1, keepdim=True), min=1e-30)
            vhat = (vr2[..., None] * vc2[..., None, :]) / denom[..., None]
            vc.copy_(vc2)
        else:
            vr2 = b2 * vr + (1 - b2) * g2
            vhat = vr2
        del g2
        u = g / (torch.sqrt(vhat) + 1e-30)
        del g, vhat
        # update clipping (Adafactor d=1.0), over the whole leaf
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms_u, min=1.0)
        us = u.unbind(0) if len(shape) > ps[0].dim() else (u,)
        for p, ui in zip(ps, us):
            ui = ui + ocfg.weight_decay * p.to(_F32)
            p.copy_(p.to(_F32) - lr * ui)
        vr.copy_(vr2)
    return params, opt_state, metrics
