"""Mixture-of-Experts with GShard-style grouped one-hot dispatch.

The port of :mod:`repro.models.moe`. The reference expresses dispatch
and combine as einsums with one-hot tensors of shape ``(groups,
group_size, experts, capacity)``, outside any kernel; the port keeps
those einsums (a later change may gather and scatter tokens instead).
A layer's parameters live in :class:`MoE` under the reference's names:
``router`` (d, E) in float32 whatever the param dtype, the stacked
experts ``w_gate`` / ``w_up`` (E, d, ff) and ``w_down`` (E, ff, d), and
for arctic the dense residual MLP ``dense``.

Expert parallel (``moe_apply(..., shard=ModelShard)``, the sharded
serving steps'): a rank holds block ``shard.index`` of the experts
(the router and, for arctic, the dense residual MLP as the specs leave
them). The dispatch and combine masks are computed once for the whole
group from the whole router, the rank runs its experts' slices of them,
and the combined outputs, partial sums over the experts, are added over
the ranks (in float32, rounded once: ``layers.cut_matmul``'s rule)
before the residual MLP joins.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.axisctx import constrain
from repro_torch.distributed.collectives import cut_for
from repro_torch.models.layers import (dense_init, gelu, mlp_apply, mlp_init,
                                       param_dtype, wide_matmul)

_F32 = torch.float32


class MoE(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        dt = param_dtype(cfg)
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = dense_init((d, e), _F32, generator, device=device)
        self.w_gate = dense_init((e, d, ff), dt, generator, in_axis=1,
                                 device=device)
        self.w_up = dense_init((e, d, ff), dt, generator, in_axis=1,
                               device=device)
        self.w_down = dense_init((e, ff, d), dt, generator, in_axis=1,
                                 device=device)
        if cfg.moe_dense_residual:
            self.dense = mlp_init(cfg, generator, device)


def moe_init(cfg: ArchConfig, generator: torch.Generator,
             device=None) -> MoE:
    return MoE(cfg, generator, device)


def _dispatch_masks(gates: torch.Tensor, top_k: int, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GShard top-k dispatch with per-(group, expert) capacity.

    gates: (G, S, E) softmax router probs.
    Returns dispatch (G, S, E, C) in {0, 1}, combine (G, S, E, C)
    gate-weighted, and the aux load-balancing loss (scalar, f32). A token
    whose position in its expert's queue is ``capacity`` or more is
    dropped: its capacity slot row is all zeros (``jax.nn.one_hot`` of an
    index out of range; ``F.one_hot`` would raise)."""
    G, S, E = gates.shape
    slots = torch.arange(capacity, device=gates.device)
    remaining = gates
    used = torch.zeros((G, E), dtype=_F32, device=gates.device)
    density_sum = torch.zeros((G, E), dtype=_F32, device=gates.device)
    dispatch = combine = None
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                   # (G, S)
        onehot = F.one_hot(idx, E).to(_F32)                     # (G, S, E)
        density_sum = density_sum + onehot.mean(dim=1)
        pos = (torch.cumsum(onehot, dim=1) - onehot) + used[:, None, :]
        keep = onehot * (pos < capacity)
        cap_slot = (pos.to(torch.int32)[..., None] == slots).to(_F32)
        d_k = keep[..., None] * cap_slot                        # (G,S,E,C)
        c_k = d_k * gates[..., None]
        dispatch = d_k if dispatch is None else dispatch + d_k
        combine = c_k if combine is None else combine + c_k
        used = used + keep.sum(dim=1)
        remaining = remaining * (1.0 - onehot)
    # Switch-style aux loss: E * mean_e(fraction routed) * mean_e(prob)
    density = density_sum / top_k
    prob_mean = gates.mean(dim=1)
    aux = (density * prob_mean).sum(dim=-1).mean() * E
    return dispatch, combine, aux


def moe_apply(p: MoE, cfg: ArchConfig, x: torch.Tensor, shard=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out, aux_loss). ``B·T`` must be a multiple of the
    dispatch group, ``min(moe_group_size, B·T)`` tokens. ``shard``: an
    expert-parallel rank's (the module docstring)."""
    B, T, d = x.shape
    Sg = min(cfg.moe_group_size, B * T)
    if (B * T) % Sg:
        raise ValueError(f"B*T = {B * T} tokens are not a multiple of the "
                         f"MoE group size {Sg}")
    G = (B * T) // Sg
    E, k = cfg.n_experts, cfg.top_k
    xg = x.reshape(G, Sg, d)
    gates = torch.softmax(xg.to(_F32) @ p.router, dim=-1)
    # aqplint: disable=AQP101(Sg/k/E are shape- and config-derived Python ints: no tensor is read)
    capacity = max(int(Sg * k * cfg.capacity_factor / E), 4)
    dispatch, combine, aux = _dispatch_masks(gates, k, capacity)
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)
    ep = cut_for(shard, p.w_up)          # an expert-parallel rank's
    E_r = p.w_up.shape[0]
    if ep is not None:                    # its block of experts
        e0 = ep.index * E_r
        dispatch = dispatch[:, :, e0:e0 + E_r]
        combine = combine[:, :, e0:e0 + E_r]

    xin = torch.einsum("gsec,gsd->gecd", dispatch, xg)
    xin = constrain(xin, "batch", "experts", None, None)
    if cfg.act == "swiglu":
        h = F.silu(torch.einsum("gecd,edf->gecf", xin, p.w_gate)) \
            * torch.einsum("gecd,edf->gecf", xin, p.w_up)
    else:
        h = gelu(torch.einsum("gecd,edf->gecf", xin, p.w_up))
    h = constrain(h, "batch", "experts", None, None)
    hout = torch.einsum("gecf,efd->gecd", h, p.w_down)
    hout = constrain(hout, "batch", "experts", None, None)
    if ep is None:
        out = torch.einsum("gecd,gsec->gsd", hout, combine)
    else:   # a partial sum over this rank's experts, as cut_matmul's
        out = ep.reduce(wide_matmul(combine.reshape(G, Sg, -1),
                                    hout.reshape(G, -1, d))).to(x.dtype)
    out = out.reshape(B, T, d)
    out = constrain(out, "batch", "seq", "embed")
    if cfg.moe_dense_residual:
        out = out + mlp_apply(p.dense, cfg, x, shard)
    return out, aux.to(_F32)
