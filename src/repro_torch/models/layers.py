"""Shared neural layers: dtypes, the fan-in init and the norms.

The port of :mod:`repro.models.layers`, as far as the SSM family needs it
(RoPE and the MLPs come with the dense families, ROADMAP queue 1 item 14).
Weights are ``nn.Parameter``s kept in the reference's ``(in, out)``
layout, so a layer computes ``x @ W`` exactly as the reference does and
its parameters convert without transposes
(:mod:`repro_torch.models.convert`). Random draws come from an explicit
``torch.Generator``; the reference's ``jax.random`` keys give other
numbers, so the tests hand both packages the reference's weights.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return _dtype(cfg.param_dtype)


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return _dtype(cfg.compute_dtype)


def dense_init(shape: Sequence[int], dtype: torch.dtype,
               generator: torch.Generator, in_axis: int = 0,
               device=None) -> nn.Parameter:
    """Truncated-normal fan-in init (LeCun-ish): a standard normal cut at
    ±2, scaled by ``1 / sqrt(shape[in_axis])``, drawn in float32 from
    ``generator`` (which must live on ``device``) and cast to ``dtype``."""
    fan_in = max(shape[in_axis], 1)
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                          generator=generator)
    return nn.Parameter(w.mul_(1.0 / fan_in ** 0.5).to(dtype))


# -- norms -------------------------------------------------------------------


class Norm(nn.Module):
    """RMSNorm or LayerNorm parameters: ``scale`` (ones) and, for
    layernorm, ``bias`` (zeros), in the config's param dtype; applied by
    :func:`norm_apply`."""

    def __init__(self, cfg: ArchConfig, d: Optional[int] = None,
                 device=None):
        super().__init__()
        d = d or cfg.d_model
        dt = param_dtype(cfg)
        self.scale = nn.Parameter(torch.ones(d, dtype=dt, device=device))
        if cfg.norm == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, dtype=dt,
                                                 device=device))


def norm_init(cfg: ArchConfig, d: Optional[int] = None, device=None) -> Norm:
    return Norm(cfg, d, device)


def norm_apply(p: Norm, x: torch.Tensor, kind: str,
               eps: float = 1e-5) -> torch.Tensor:
    """Normalise the last axis in float32 and return ``x``'s dtype."""
    xf = x.to(torch.float32)
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p.scale.to(torch.float32) + p.bias.to(torch.float32)
    else:  # rmsnorm
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p.scale.to(torch.float32)
    return out.to(x.dtype)
