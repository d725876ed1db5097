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

from typing import Callable, Dict, Optional

import torch

from repro_torch.core.state import merge_moments
from repro_torch.device import resolve_device
from repro_torch.models import lm as lm_mod
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
    """The state's shapes and dtypes with no allocation: the LM and its
    optimizer state built on the ``meta`` device (the counterpart of the
    reference's ``jax.eval_shape`` dry run)."""
    params = lm_mod.lm_init(model.cfg, None, torch.device("meta"))
    return {"params": params, "opt": opt.init(dict(params.named_parameters()), ocfg),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def _split_microbatches(batch: Dict, m: int):
    """The batch cut into ``m`` equal microbatches along the batch axis;
    0-d entries go to every microbatch."""
    if any(v.dim() >= 1 and v.shape[0] % m for v in batch.values()):
        raise ValueError(f"batch size is not a multiple of the {m} "
                         "microbatches")
    parts = {k: v.chunk(m, dim=0) if v.dim() >= 1 else (v,) * m
             for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(m)]


def build_train_step(model: Model, ocfg: opt.OptConfig,
                     window: Optional[int] = None,
                     grad_transform: Optional[Callable] = None) -> Callable:
    """grad_transform: optional ``{name: grad} -> {name: grad}`` hook
    applied to the (float32 when accumulated) gradients before the
    update."""
    cfg = model.cfg
    micro = max(cfg.microbatches, 1)

    def loss_and_grads(params, plist, mb):
        loss, metrics = model.loss(params, mb, window)
        grads = torch.autograd.grad(loss, plist)
        return loss, metrics, grads

    def train_step(state: Dict, batch: Dict):
        params = state["params"]
        named = dict(params.named_parameters())
        names, plist = list(named), list(named.values())
        if micro == 1:
            loss, metrics, g = loss_and_grads(params, plist, batch)
            grads = dict(zip(names, g))
        else:
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
                           for k in ("loss", "z_loss", "aux_loss",
                                     "tokens")},
                        "loss_ci_state": merge_moments(
                            metrics["loss_ci_state"],
                            m_i["loss_ci_state"])}
                # a microbatch's gradients go before the next one's come
                del g
            grads = {n: a.div_(micro) for n, a in zip(names, g_acc)}
            metrics = {**{k: metrics[k] / micro
                          for k in ("loss", "z_loss", "aux_loss")},
                       "tokens": metrics["tokens"],
                       "loss_ci_state": metrics["loss_ci_state"]}
            loss = metrics["loss"]
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
