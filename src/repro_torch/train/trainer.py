"""Training step builder: microbatch gradient accumulation, clipping, the
optimizer update and the per-token loss CI state.

The port of :mod:`repro.train.trainer`. A state is ``{"params": the LM
module, "opt": the optimizer's state dicts, "step": 0-d int32 tensor}``,
all on one device. ``build_train_step(model, ocfg)`` returns
``train_step(state, batch) -> (state, metrics)``; it updates the
module's parameters and the optimizer state in place (PyTorch runs
eagerly: there is nothing to jit) and returns the same state with the
step advanced. Metrics are the reference's: loss, z_loss, aux_loss,
tokens, the per-token loss ``MomentState`` (merged across microbatches
with :func:`repro_torch.core.state.merge_moments`), grad_norm, lr and
total_loss.

Microbatch gradients come from ``torch.autograd.grad`` and are summed in
float32 buffers, as the reference's ``acc`` sums them, never through
``.grad`` (which would accumulate in the parameters' bfloat16).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from repro_torch.core.state import merge_moments
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as sh
from repro_torch.device import resolve_device
from repro_torch.models.zoo import Model
from repro_torch.train import optimizer as opt

_F32 = torch.float32


def init_state(model: Model, seed: int, ocfg: opt.OptConfig,
               device=None) -> Dict:
    """Fresh state: the LM from ``seed`` on ``device`` (``None`` = the
    card), zero optimizer moments, step 0."""
    dev = resolve_device(device)
    params = model.init(seed, device=dev)
    return {"params": params, "opt": opt.init(dict(params.named_parameters()), ocfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_state(model: Model, ocfg: opt.OptConfig) -> Dict:
    """The state's shapes and dtypes with no allocation: the model's own
    module (an ``LM``, or an ``EncDec``) and its optimizer state built on
    the ``meta`` device (the counterpart of the reference's
    ``jax.eval_shape`` dry run)."""
    return init_state(model, 0, ocfg, device="meta")


def _split_microbatches(batch: Dict, m: int):
    """The batch cut into ``m`` equal microbatches along the batch axis;
    0-d entries go to every microbatch."""
    if any(v.dim() >= 1 and v.shape[0] % m for v in batch.values()):
        raise ValueError(f"batch size is not a multiple of the {m} "
                         "microbatches")
    parts = {k: v.chunk(m, dim=0) if v.dim() >= 1 else (v,) * m
             for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(m)]


def _gradients(model: Model, window: Optional[int]) -> Callable:
    """``grads(module, batch) -> (loss, metrics, {name: grad})``: the loss
    and its gradients over the config's microbatches (summed in float32
    and averaged when there are several), the reference's metrics merged
    across them."""
    cfg = model.cfg
    micro = max(cfg.microbatches, 1)

    def loss_and_grads(params, plist, mb):
        loss, metrics = model.loss(params, mb, window)
        grads = torch.autograd.grad(loss, plist)
        return loss, metrics, grads

    def grads_of(params, batch):
        named = dict(params.named_parameters())
        names, plist = list(named), list(named.values())
        if micro == 1:
            loss, metrics, g = loss_and_grads(params, plist, batch)
            return loss, metrics, dict(zip(names, g))
        g_acc, metrics = None, None
        for mb in _split_microbatches(batch, micro):
            _, m_i, g = loss_and_grads(params, plist, mb)
            if g_acc is None:
                g_acc = [gi.to(_F32) for gi in g]
                metrics = m_i
            else:
                for a, gi in zip(g_acc, g):
                    a.add_(gi.to(_F32))
                metrics = {
                    **{k: metrics[k] + m_i[k]
                       for k in ("loss", "z_loss", "aux_loss", "tokens")},
                    "loss_ci_state": merge_moments(
                        metrics["loss_ci_state"], m_i["loss_ci_state"])}
            # a microbatch's gradients go before the next one's come
            del g
        grads = {n: a.div_(micro) for n, a in zip(names, g_acc)}
        metrics = {**{k: metrics[k] / micro
                      for k in ("loss", "z_loss", "aux_loss")},
                   "tokens": metrics["tokens"],
                   "loss_ci_state": metrics["loss_ci_state"]}
        return metrics["loss"], metrics, grads

    return grads_of


def build_train_step(model: Model, ocfg: opt.OptConfig,
                     window: Optional[int] = None,
                     grad_transform: Optional[Callable] = None) -> Callable:
    """grad_transform: optional ``{name: grad} -> {name: grad}`` hook
    applied to the (float32 when accumulated) gradients before the
    update."""
    grads_of = _gradients(model, window)

    def train_step(state: Dict, batch: Dict):
        params = state["params"]
        named = dict(params.named_parameters())
        loss, metrics, grads = grads_of(params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        # a named range, so that a profiler trace shows the update's span
        with torch.profiler.record_function("optimizer.apply"):
            _, new_opt, opt_metrics = opt.apply(named, grads, state["opt"],
                                                state["step"], ocfg)
        metrics = {**metrics, **opt_metrics, "total_loss": loss.detach()}
        new_state = {"params": params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, metrics

    return train_step


def build_sharded_train_step(model: Model, ocfg: opt.OptConfig, mesh,
                             state_spec: Dict, batch_spec: Dict,
                             window: Optional[int] = None) -> Callable:
    """The train step on a mesh, one rank a device (the counterpart of
    the reference's step jitted with ``in_shardings`` from the parameter,
    optimizer and batch specs). Every rank of ``mesh`` (a ``DeviceMesh``
    over the whole default group) calls ``train_step(state, batch)`` with
    its shards of a state laid out by ``state_spec``
    (:func:`repro_torch.distributed.sharding.distribute`: ``{"params":
    {name: DTensor}, "opt": ..., "step": ...}``) and the same whole
    ``batch``. Each step:

      * gathers every parameter whole into a model of its own on this
        rank's device (built on first use; all-gathers of up to
        ``sharding.GATHER_CHUNK_BYTES`` a rank);
      * takes this rank's slice of the batch by ``batch_spec`` (the dp
        axes' slice; ranks of one dp coordinate hold the same one);
      * runs :func:`build_train_step`'s loss and gradients on it
        (microbatches, remat);
      * all-reduces every gradient, in float32, with the loss metrics
        in one flat buffer over every rank and divides by their number:
        the mean over the dp axes, the same bits on every rank; each rank
        keeps its shard of each gradient;
      * applies the optimizer to its shards (:func:`repro_torch.train.
        optimizer.apply`, which reduces the norm and Adafactor's means
        across ranks).

    Compute is data parallel over the dp axes; the ``"model"`` axis
    shards storage only (no tensor-parallel matmul). Returns the new
    state (the same DTensors, updated in place, and the step advanced)
    and the metrics of :func:`build_train_step`, over the whole batch
    (the losses the mean of the dp slices', the CI state their merge)."""
    grads_of = _gradients(model, window)
    dp_dims = [k for k, a in enumerate(sh.axis_sizes(mesh))
               if a in sh.mesh_dp_axes(mesh)]
    n_dp = math.prod(int(mesh.shape[k]) for k in dp_dims)
    held: Dict[str, nn.Module] = {}

    def local_batch(batch: Dict) -> Dict:
        coord = mesh.get_coordinate()
        return {k: v[sh.shard_slices(
            mesh, sh.P(*batch_spec.get(k, ())).padded(v.dim()), v.shape,
            coord)] for k, v in batch.items()}

    def train_step(state: Dict, batch: Dict):
        params = state["params"]
        names = list(params)
        dev = params[names[0]].to_local().device
        if "module" not in held:
            for n, p in params.items():
                want = sh.placements(mesh, sh.P(*state_spec["params"][n]))
                if tuple(p.placements) != want:
                    raise ValueError(f"{n} is laid out {p.placements}, not "
                                     f"by its spec {want}")
            held["module"] = model.init(0, device="meta").to_empty(
                device=dev)
        module = held["module"]
        named = dict(module.named_parameters())
        if list(named) != names:
            raise ValueError("the state's parameters are not the model's")
        sh.full_tensors([params[n] for n in names],
                        out=[named[n].data for n in names])
        loss, metrics, grads = grads_of(module, local_batch(batch))
        # one all-reduce of every gradient and the loss metrics
        keys = ("loss", "z_loss", "aux_loss", "tokens")
        flat = torch.cat([grads[n].reshape(-1).to(_F32) for n in names]
                         + [metrics[k].reshape(1).to(_F32) for k in keys]
                         + [loss.detach().reshape(1).to(_F32)])
        del grads
        coll.all_reduce_sum(flat)
        world = torch.full((), float(mesh.size()), dtype=_F32, device=dev)
        flat.div_(world)
        coord = mesh.get_coordinate()
        shards, off = {}, 0
        for n in names:
            p = params[n]
            full = flat[off:off + p.numel()].view(tuple(p.shape))
            off += p.numel()
            spec = sh.spec_of(mesh, p.placements, p.dim())
            shards[n] = sh.from_local(
                mesh, spec,
                full[sh.shard_slices(mesh, spec, p.shape, coord)].clone(),
                tuple(p.shape))
        means = flat[off:].clone()   # not a view: the buffer goes now
        # the CI states of the dp slices, merged in dp order
        ci = metrics["loss_ci_state"]
        every = coll.all_gather(torch.stack([x.reshape(()).to(_F32)
                                             for x in ci]))
        merged = None
        for r in coll.group_ranks(mesh, dp_dims):
            st = type(ci)(*every[r].unbind(0))
            merged = st if merged is None else merge_moments(merged, st)
        del flat
        with torch.profiler.record_function("optimizer.apply"):
            _, new_opt, opt_metrics = opt.apply(params, shards, state["opt"],
                                                state["step"], ocfg)
        metrics = {"loss": means[0], "z_loss": means[1],
                   "aux_loss": means[2],
                   "tokens": means[3] * n_dp, "loss_ci_state": merged,
                   **opt_metrics, "total_loss": means[4]}
        step = state["step"]
        new_step = (sh.from_local(mesh, (), step.to_local() + 1, ())
                    if hasattr(step, "to_local") else step + 1)
        return {"params": params, "opt": new_opt, "step": new_step}, metrics

    return train_step
