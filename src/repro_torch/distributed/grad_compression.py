"""Int8 gradient compression with error feedback.

The port of :mod:`repro.distributed.grad_compression`. Two layers:

  * :func:`compress_roundtrip`: per-leaf symmetric int8 quantize ->
    dequantize with an error-feedback residual carried beside the train
    state; it models the numerics of a compressed reduction, and
    ``lambda g: compress_roundtrip(g, fb)[0]`` fits the trainer's
    ``grad_transform`` hook (:func:`repro_torch.train.build_train_step`);
  * :func:`compressed_psum`: the wire primitive on ``torch.distributed``:
    every rank quantizes its gradient against the group's largest
    magnitude (one MAX all-reduce of a scalar), the int32 payloads are
    summed (one SUM all-reduce), and the sum is dequantized.

Gradients are ``{name: tensor}`` dicts, as the trainer passes them.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the
round trip gives the reference's bits.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist

_F32 = torch.float32


def _div127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` correctly rounded, as ``jnp`` divides: on the card
    torch turns a division by a Python number into a product with its
    reciprocal, an ulp off for some ``x``, so the divisor is a tensor on
    ``x``'s device."""
    return x / torch.full((), 127.0, dtype=x.dtype, device=x.device)


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale)`` with ``g ~ q * scale``, ``|q| <= 127``."""
    scale = _div127(g.abs().max()) + 1e-30
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(_F32) * scale


def init_error_feedback(params: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Zero float32 residuals beside each of ``params`` (``{name:
    tensor}``, e.g. ``dict(module.named_parameters())``)."""
    return {n: torch.zeros(p.shape, dtype=_F32, device=p.device)
            for n, p in params.items()}


def compress_roundtrip(grads: Mapping[str, torch.Tensor],
                       error_fb: Mapping[str, torch.Tensor]
                       ) -> Tuple[Dict[str, torch.Tensor],
                                  Dict[str, torch.Tensor]]:
    """Returns ``(dequantized grads, new error feedback)``: each
    gradient plus its residual, quantized and back, and what the
    quantization lost."""
    dq, fb = {}, {}
    for n, g in grads.items():
        g = g.to(_F32) + error_fb[n]
        dq[n] = dequantize(*quantize(g))
        fb[n] = g - dq[n]
    return dq, fb


def compressed_psum(g: torch.Tensor, group=None) -> torch.Tensor:
    """The int8-quantized sum of ``g`` over the ranks of ``group`` (the
    default group when ``None``): each rank quantizes against the global
    max scale, the int32 payloads are all-reduced, the sum is
    dequantized. Equals the plain sum up to int8 rounding."""
    gmax = g.abs().max().to(_F32)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    scale = _div127(gmax + 1e-30)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.to(_F32) * scale
