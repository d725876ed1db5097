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

Adafactor factors each tensor it is given. The reference's scan-stacked
layers hand it one ``(n_layers, ...)`` leaf per layer parameter, so there
a layer's vectors (``D``, ``dt_bias``, norm scales) get factored across
the layer axis and the update clip spans all layers; the port's layers
are separate tensors, and each is treated as the reference treats an
unstacked leaf. AdamW is elementwise and the same either way.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

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
    for a parameter of ``shape``: AdamW's moments are the parameter's
    shape; Adafactor factors a matrix into a row moment (``vr``, the last
    axis dropped) and a column moment (``vc``, the second last dropped)
    and keeps a vector's whole second moment in ``vr`` beside a 0-d
    ``vc``."""
    shape = tuple(shape)
    if key in ("m", "v"):
        return shape
    if key == "vr":
        return shape[:-1] if _factored(shape) else shape
    if key == "vc":
        return shape[:-2] + shape[-1:] if _factored(shape) else ()
    raise KeyError(f"no optimizer leaf {key!r}")


def init(params: Mapping[str, torch.Tensor], ocfg: OptConfig) -> Dict:
    """Zero state beside each parameter, on its device: AdamW's ``m`` and
    ``v`` in the moment dtype; Adafactor's float32 row / column second
    moments (:func:`moment_shape`)."""
    keys, dt = (("m", "v"), _mdt(ocfg)) if ocfg.name == "adamw" \
        else (("vr", "vc"), _F32)
    return {k: {n: torch.zeros(moment_shape(k, p.shape), dtype=dt,
                               device=p.device)
                for n, p in params.items()} for k in keys}


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
    for n, p in params.items():
        vr, vc = opt_state["vr"][n], opt_state["vc"][n]
        g = grads[n].to(_F32) * scale
        g2 = g * g + 1e-30
        if _factored(p.shape):
            vr2 = b2 * vr + (1 - b2) * g2.mean(dim=-1)
            vc2 = b2 * vc + (1 - b2) * g2.mean(dim=-2)
            denom = torch.clamp(vr2.mean(dim=-1, keepdim=True), min=1e-30)
            vhat = (vr2[..., None] * vc2[..., None, :]) / denom[..., None]
            vc.copy_(vc2)
        else:
            vr2 = b2 * vr + (1 - b2) * g2
            vhat = vr2
        u = g / (torch.sqrt(vhat) + 1e-30)
        # update clipping (Adafactor d=1.0)
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms_u, min=1.0)
        u = u + ocfg.weight_decay * p.to(_F32)
        p.copy_(p.to(_F32) - lr * u)
        vr.copy_(vr2)
    return params, opt_state, metrics
