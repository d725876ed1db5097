"""Optimizers: AdamW (configurable moment dtype) and Adafactor (factored
second moments).

The port of :mod:`repro.train.optimizer`. Where the reference maps pure
functions over a parameter pytree, the port works on a flat ``{name:
tensor}`` dict (``dict(module.named_parameters())``): :func:`init`
builds the state dicts, :func:`apply` computes every update in float32,
writes the new parameters and moments **in place** (no second copy of
a 7B model's state) and returns ``(params, state, metrics)``. Each
update is the reference's per-leaf formula, operation for operation.

:func:`state_specs` lays the optimizer state out from the parameter
specs (:mod:`repro_torch.distributed.sharding`): AdamW's moments take
their parameter's spec, Adafactor's row and column moments its stacked
leaf's spec less the dim they average over. :func:`apply` takes the
parameters, gradients and moments as tensors on one device or as
DTensors laid out by those specs (one rank a device): the updates are
elementwise on each rank's shards, and what spans the ranks that hold
different parts of a leaf is reduced across them with
:func:`repro_torch.distributed.collectives.sum_over` (the same bits on
every rank): the global gradient norm (each shard counted once, on the
first of its replicas), Adafactor's row and column means and its update
clip. On one device the operations are what they were.

Adafactor sees the leaves the reference sees. The reference stacks a
layer parameter of every layer into one ``(n_layers, ...)`` leaf; the
port's layers are separate tensors (``layers.<i>.<rest>``), so
:func:`leaves` groups them back under the stacked name
``layers.<rest>``. :func:`init` keeps Adafactor's moments in the stacked
shapes under those names, and :func:`apply` computes each leaf's update
on the stack (a layer's vector is factored across the layer axis, and
the update clip spans all layers), then writes each layer's slice back.
The stack and the update's float32 temporaries are one leaf's size at
a time, never the whole model's. A stacked leaf whose layers are
matrices (dbrx's ``(n_layers, E, d, ff)`` experts) has per-layer
factored moments, and only its update clip spans the stack: it is
updated a layer at a time, in two passes (:func:`_adafactor_layers`),
so its temporaries are one layer's. Parameters outside the layers stay
single leaves. AdamW is elementwise and works per tensor.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import all_gather, sum_over
from repro_torch.distributed.sharding import P

_F32 = torch.float32
_B2 = 0.999           # Adafactor's second-moment decay


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


# a scan-stacked layer parameter: ``<stack>.<i>.<rest>``, or the
# hybrid's ``layers.<group>.<i>.<rest>``
_LAYER = re.compile(r"(layers|tail_layers|enc_layers|dec_layers)"
                    r"\.(\d+)\.(?:(\d+)\.)?([^\d].*)")


def _stack_index(name: str):
    """``(leaf, index)`` of a stacked layer parameter (``index`` a tuple
    of one or two layer indices), or ``None``."""
    m = _LAYER.fullmatch(name)
    if m is None:
        return None
    idx = (int(m.group(2)),) if m.group(3) is None else (int(m.group(2)),
                                                        int(m.group(3)))
    return f"{m.group(1)}.{m.group(4)}", idx


def _grid(idx) -> Tuple[int, ...]:
    return tuple(max(i[k] for i in idx) + 1 for k in range(len(idx[0])))


def leaves(names) -> Dict[str, List[str]]:
    """The reference's optimizer leaves over the port's parameter names:
    ``<stack>.<rest>`` -> its layers' ``<stack>.<i>.<rest>`` in layer
    order for a scan-stacked layer parameter (the stacks ``layers``,
    ``tail_layers``, ``enc_layers`` and ``dec_layers``; the hybrid's
    ``layers.<group>.<i>.<rest>`` group by group), ``name -> [name]`` for
    any other. Raises ``ValueError`` if a stack misses a layer."""
    out: Dict[str, List[str]] = {}
    layer_of: Dict[str, Dict[Tuple[int, ...], str]] = {}
    for n in names:
        hit = _stack_index(n)
        if hit is None:
            out[n] = [n]
            continue
        leaf, idx = hit
        out.setdefault(leaf, [])
        layer_of.setdefault(leaf, {})[idx] = n
    for leaf, by_layer in layer_of.items():
        idx = sorted(by_layer)
        if idx != list(itertools.product(*map(range, _grid(idx)))):
            raise ValueError(f"{leaf}: layers {idx} are not a full grid")
        out[leaf] = [by_layer[i] for i in idx]
    return out


def leaf_shape(members, params: Mapping[str, torch.Tensor]
               ) -> Tuple[int, ...]:
    """Shape of the leaf of :func:`leaves`' ``members``: the reference's
    stacked ``(n_layers, ...)`` (the hybrid's ``(n_groups, period,
    ...)``) for layer parameters, else the parameter's own."""
    shape = tuple(params[members[0]].shape)
    if _stack_index(members[0]) is None:
        return shape
    return _grid([_stack_index(n)[1] for n in members]) + shape


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


def state_specs(param_spec_tree: Mapping, params, ocfg: OptConfig) -> Dict:
    """Optimizer-state specs from the parameter specs (``{name: spec}``,
    :func:`repro_torch.distributed.sharding.param_specs`) and the
    parameters (a module or ``{name: tensor}``): AdamW's ``m`` and ``v``
    take each parameter's spec; Adafactor's leaves (:func:`leaves`) take
    their stacked spec (``None`` on the stack's dims, the layer's spec
    behind), ``vr`` less its last entry and ``vc`` less its second to
    last when the leaf is factored, else ``vr`` all of it and ``vc``
    ``P()`` (the reference's ``state_specs``)."""
    if not isinstance(params, Mapping):
        params = dict(params.named_parameters())
    if ocfg.name == "adamw":
        return {"m": dict(param_spec_tree), "v": dict(param_spec_tree)}
    out: Dict[str, Dict[str, P]] = {"vr": {}, "vc": {}}
    for leaf, members in leaves(params).items():
        shape = leaf_shape(members, params)
        nd = params[members[0]].dim()
        parts = ([None] * (len(shape) - nd)
                 + list(P(*param_spec_tree[members[0]]).padded(nd)))
        if _factored(shape):
            out["vr"][leaf] = P(*parts[:-1])
            out["vc"][leaf] = P(*(parts[:-2] + parts[-1:]))
        else:
            out["vr"][leaf] = P(*parts)
            out["vc"][leaf] = P()
    return out


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (its storage: writes land in the
    DTensor), or ``x``."""
    return x.to_local() if _is_dtensor(x) else x


class _Layout:
    """Where a leaf's dims are cut: on one device nothing, for a DTensor
    the mesh dims that shard each of its dims. ``mean`` and ``total``
    reduce across the ranks that hold different parts; ``owner`` is true
    on one rank of each set of replicas of this rank's shard."""

    def __init__(self, t: torch.Tensor):
        self.mesh = None
        self.by_dim: Dict[int, List[int]] = {}
        self.owner = True
        self.ndim = t.dim()
        if not _is_dtensor(t):
            return
        self.mesh = t.device_mesh
        coord = self.mesh.get_coordinate()
        for k, pl in enumerate(t.placements):
            if pl.is_shard():
                # keyed from the end: a stacked leaf's stack dims come first
                self.by_dim.setdefault(pl.dim % self.ndim - self.ndim,
                                       []).append(k)
            elif coord[k] != 0:
                self.owner = False

    def _dims(self, pdim: Optional[int] = None) -> List[int]:
        if pdim is None:
            return sorted(k for ks in self.by_dim.values() for k in ks)
        return self.by_dim.get(pdim, [])

    def _count(self, dims: List[int]) -> int:
        return math.prod(self.mesh.shape[k] for k in dims)

    def mean(self, x: torch.Tensor, dim: int, pdim: int,
             keepdim: bool = False) -> torch.Tensor:
        """``x.mean(dim)`` over the whole leaf, ``x``'s ``dim`` being the
        leaf's dim ``pdim`` (negative: counted from the end, so a stack's
        dims are never cut)."""
        dims = self._dims(pdim)
        if not dims:
            return x.mean(dim=dim, keepdim=keepdim)
        s = sum_over(x.sum(dim=dim, keepdim=keepdim), self.mesh, dims)
        return s / (x.shape[dim] * self._count(dims))

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """A per-shard sum summed over every part of the leaf."""
        return sum_over(x, self.mesh, self._dims()) if self.mesh else x

    def numel(self, local_numel: int) -> int:
        return local_numel * (self._count(self._dims()) if self.mesh else 1)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32. DTensors
    (one rank a device): each rank sums the squares of the shards it
    owns (the first replica of each), and the ranks' partial sums are
    gathered and added in rank order, so every rank has the same
    bits."""
    tensors = list(tensors)
    if not tensors or not _is_dtensor(tensors[0]):
        return torch.sqrt(sum(torch.sum(torch.square(x.to(_F32)))
                              for x in tensors))
    part = torch.zeros((), dtype=_F32, device=_local(tensors[0]).device)
    for x in tensors:
        if _Layout(x).owner:
            part = part + torch.sum(torch.square(_local(x).to(_F32)))
    return torch.sqrt(all_gather(part).sum())


@torch.no_grad()
def apply(params: Mapping[str, torch.Tensor],
          grads: Mapping[str, torch.Tensor], opt_state: Dict,
          step: torch.Tensor, ocfg: OptConfig) -> Tuple[Dict, Dict, Dict]:
    """One update: clip by the global norm, then AdamW or Adafactor.
    ``params`` and ``opt_state`` are updated in place and returned with
    the metrics ``{"grad_norm", "lr"}`` (0-d float32 tensors). Leaves may
    be DTensors laid out by :func:`state_specs` (the module docstring);
    ``step`` a tensor or a replicated DTensor."""
    gnorm = global_norm(grads[n] for n in params)
    scale = torch.clamp(ocfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = _local(step)
    lr = lr_at(ocfg, step)
    metrics = {"grad_norm": gnorm, "lr": lr}

    if ocfg.name == "adamw":
        t = (step + 1).to(_F32)
        bc1 = 1.0 - ocfg.b1 ** t
        bc2 = 1.0 - ocfg.b2 ** t
        for n, p in params.items():
            p = _local(p)
            m, v = _local(opt_state["m"][n]), _local(opt_state["v"][n])
            g = _local(grads[n]).to(_F32) * scale
            m2 = ocfg.b1 * m.to(_F32) + (1 - ocfg.b1) * g
            v2 = ocfg.b2 * v.to(_F32) + (1 - ocfg.b2) * g * g
            u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + ocfg.eps)
            u = u + ocfg.weight_decay * p.to(_F32)
            p.copy_(p.to(_F32) - lr * u)
            m.copy_(m2)
            v.copy_(v2)
        return params, opt_state, metrics

    # -- adafactor (factored 2nd moments, no 1st moment) ----------------------
    for leaf, members in leaves(params).items():
        lay = _Layout(params[members[0]])
        vr = _local(opt_state["vr"][leaf])
        vc = _local(opt_state["vc"][leaf])
        ps = [_local(params[n]) for n in members]
        gs = [_local(grads[n]) for n in members]
        lead = len(leaf_shape(members, params)) - ps[0].dim()
        shape = tuple(vr.shape[:lead]) + tuple(ps[0].shape)  # this shard's
        factored = _factored(leaf_shape(members, params))
        if lead and _factored(ps[0].shape):
            _adafactor_layers(ps, gs, vr.flatten(0, lead - 1),
                              vc.flatten(0, lead - 1), scale, lr, ocfg, lay)
            continue
        if lead:                          # stacked: one f32 buffer
            g = torch.empty(shape, dtype=_F32, device=ps[0].device)
            flat = g.view(-1, *ps[0].shape)
            for i, gi in enumerate(gs):
                flat[i].copy_(gi)
            g.mul_(scale)
        else:
            g = gs[0].to(_F32) * scale
        g2 = g * g + 1e-30
        if factored:
            vr2 = _B2 * vr + (1 - _B2) * lay.mean(g2, -1, -1)
            vc2 = _B2 * vc + (1 - _B2) * lay.mean(g2, -2, -2)
            denom = torch.clamp(lay.mean(vr2, -1, -2, keepdim=True),
                                min=1e-30)
            vhat = (vr2[..., None] * vc2[..., None, :]) / denom[..., None]
            vc.copy_(vc2)
        else:
            vr2 = _B2 * vr + (1 - _B2) * g2
            vhat = vr2
        del g2
        u = g / (torch.sqrt(vhat) + 1e-30)
        del g, vhat
        # update clipping (Adafactor d=1.0), over the whole leaf
        if lay.mesh is None:
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
        else:
            rms_u = torch.sqrt(lay.total(torch.sum(u * u))
                               / lay.numel(u.numel()) + 1e-30)
        u = u / torch.clamp(rms_u, min=1.0)
        us = u.reshape(-1, *ps[0].shape).unbind(0) if lead else (u,)
        for p, ui in zip(ps, us):
            ui = ui + ocfg.weight_decay * p.to(_F32)
            p.copy_(p.to(_F32) - lr * ui)
        vr.copy_(vr2)
    return params, opt_state, metrics


def _adafactor_unclipped(g: torch.Tensor, vr: torch.Tensor,
                         vc: torch.Tensor, scale: torch.Tensor,
                         lay: _Layout):
    """One matrix's (or one layer's stack of matrices') Adafactor update
    before the clip, with its new row and column moments: the formula of
    :func:`apply`'s stacked path on one slice, each operation the same,
    in place where it can be, so that the float32 temporaries are two of
    the slice's size at most. ``lay`` reduces the means across ranks."""
    g = g.to(_F32) * scale
    g2 = g * g
    g2.add_(1e-30)
    vr2 = _B2 * vr + (1 - _B2) * lay.mean(g2, -1, -1)
    vc2 = _B2 * vc + (1 - _B2) * lay.mean(g2, -2, -2)
    del g2
    denom = torch.clamp(lay.mean(vr2, -1, -2, keepdim=True), min=1e-30)
    vhat = vr2[..., None] * vc2[..., None, :]
    vhat.div_(denom[..., None])
    u = g.div_(vhat.sqrt_().add_(1e-30))
    return u, vr2, vc2


def _adafactor_layers(ps, gs, vr, vc, scale, lr, ocfg: OptConfig,
                      lay: _Layout) -> None:
    """Adafactor on a stacked leaf whose layers are matrices (dbrx's
    ``(n_layers, E, d, ff)`` experts), a layer at a time: their factored
    moments are the layer's own, and only the update clip spans the
    stack, so a first pass sums the updates' squares and a second
    computes each update again (the same bits) and applies it clipped.
    The float32 temporaries are one layer's, not the stack's."""
    sq = torch.zeros((), dtype=_F32, device=vr.device)
    new = []
    for i, g in enumerate(gs):
        u, vr2, vc2 = _adafactor_unclipped(g, vr[i], vc[i], scale, lay)
        sq += torch.sum(u.square_())
        new.append((vr2, vc2))
        del u
    count = lay.numel(sum(g.numel() for g in gs))
    clip = torch.clamp(torch.sqrt(lay.total(sq) / count + 1e-30), min=1.0)
    for i, (p, g) in enumerate(zip(ps, gs)):
        # u / clip + wd * p, times lr, off p: apply's operations in place
        u = _adafactor_unclipped(g, vr[i], vc[i], scale, lay)[0].div_(clip)
        u.add_(p.to(_F32, copy=True).mul_(ocfg.weight_decay)).mul_(lr)
        p.copy_(p.to(_F32, copy=True).sub_(u))
        del u
    for i, (vr2, vc2) in enumerate(new):
        vr[i].copy_(vr2)
        vc[i].copy_(vc2)
