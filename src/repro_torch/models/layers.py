"""Shared neural layers: dtypes, the fan-in init, the norms, RoPE, the
MLPs, the float32 output head and per-layer remat.

The port of :mod:`repro.models.layers`. Weights are ``nn.Parameter``s
kept in the reference's ``(in, out)`` layout, so a layer computes
``x @ W`` exactly as the reference does and its parameters convert
without transposes (:mod:`repro_torch.models.convert`). Random draws
come from an explicit ``torch.Generator``; the reference's
``jax.random`` keys give other numbers, so the tests hand both packages
the reference's weights.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.axisctx import constrain
from repro_torch.distributed.collectives import cut_for


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


def head_norm_apply(scale: torch.Tensor, x: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMS-normalize the head_dim axis in float32 (qwen3); eps
    1e-6, not the norms' 1e-5."""
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)
            * scale.to(torch.float32)).to(x.dtype)


# -- RoPE --------------------------------------------------------------------


def rope_apply(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """The half-split rotation. x: (..., seq, heads, head_dim); positions:
    (..., seq) int. The angles are float32; ``x`` times them promotes to
    float32 (bf16 included, as in JAX) and the result is cast back."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLP ---------------------------------------------------------------------


class MLP(nn.Module):
    """The feed-forward block's parameters: ``w_gate``, ``w_up`` (d, ff)
    and ``w_down`` (ff, d) for swiglu, ``w_up`` and ``w_down`` for gelu;
    applied by :func:`mlp_apply`."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device=None, d: Optional[int] = None,
                 ff: Optional[int] = None):
        super().__init__()
        d = d or cfg.d_model
        ff = ff or cfg.d_ff
        dt = param_dtype(cfg)
        if cfg.act == "swiglu":
            self.w_gate = dense_init((d, ff), dt, generator, device=device)
        self.w_up = dense_init((d, ff), dt, generator, device=device)
        self.w_down = dense_init((ff, d), dt, generator, device=device)


def mlp_init(cfg: ArchConfig, generator: torch.Generator, device=None,
             d: Optional[int] = None, ff: Optional[int] = None) -> MLP:
    return MLP(cfg, generator, device, d, ff)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def wide_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result: ``a`` (..., k) by ``b`` (k, n),
    or batched, ``a`` (G, m, k) by ``b`` (G, k, n). From operands of one
    16-bit dtype a card (and the meta device) runs that dtype's GEMM,
    accumulating and writing float32 (``out_dtype``): the products of
    two such values are exact in float32, and no operand is widened.
    The CPU, which has no such kernel, does the same arithmetic on
    float32 copies; so do operands of other dtypes."""
    half = (torch.float16, torch.bfloat16)
    if a.device.type == "cpu" or a.dtype not in half or b.dtype != a.dtype:
        return a.to(torch.float32) @ b.to(torch.float32)
    if b.dim() == 3:
        return torch.bmm(a, b, out_dtype=torch.float32)
    out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def cut_matmul(x: torch.Tensor, w: torch.Tensor, shard) -> torch.Tensor:
    """``x @ w`` for a tensor-parallel rank (``shard``, a
    :class:`repro_torch.distributed.collectives.ModelShard`, or
    ``None``) where it holds a cut of ``w``'s rows (the contraction; by
    its spec, :func:`repro_torch.distributed.collectives.cut_for`): the
    rank's partial product in float32 (:func:`wide_matmul`), added over
    the ranks in float32 and rounded once to ``x``'s dtype, as one
    card's matmul rounds its float32 sum. A whole ``w``: ``x @ w``."""
    shard = cut_for(shard, w)
    if shard is None:
        return x @ w
    return shard.reduce(wide_matmul(x, w)).to(x.dtype)


def mlp_apply(p: MLP, cfg: ArchConfig, x: torch.Tensor,
              shard=None) -> torch.Tensor:
    """The MLP of ``x``. A tensor-parallel rank (``shard``, a
    :class:`repro_torch.distributed.collectives.ModelShard`) holds a
    block of the ``ff`` columns of ``w_gate`` / ``w_up`` and the same
    rows of ``w_down``: its product is a partial sum, added over the
    ranks (:func:`cut_matmul`)."""
    if cfg.act == "swiglu":
        h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    else:
        h = gelu(x @ p.w_up)
    if x.dim() == 3:
        h = constrain(h, "batch", "seq", "ff")
    out = cut_matmul(h, p.w_down, shard)
    return constrain(out, "batch", "seq", "embed") if x.dim() == 3 else out


# -- output head and remat ---------------------------------------------------


def _head_f32(owner: nn.Module, head: torch.Tensor) -> torch.Tensor:
    """``head`` in float32. Where no gradient is wanted the copy is kept
    on ``owner`` and made again only when the head's storage or version
    changes (``load_state_dict``, ``.to``): the head of falcon-mamba-7b
    or seamless-m4t is 1 GiB in float32, too much to convert every decode
    step."""
    if head.dtype == torch.float32 or (torch.is_grad_enabled()
                                       and head.requires_grad):
        return head.to(torch.float32)
    key = (head.device, head.data_ptr(), head._version)
    if getattr(owner, "_head_key", None) != key:
        # a normal tensor even under inference_mode, so that a later
        # forward outside it may use the copy
        with torch.inference_mode(False), torch.no_grad():
            owner._head_f32 = head.to(torch.float32)
        owner._head_key = key
    return owner._head_f32


def output_logits(owner: nn.Module, final_ln: Norm, head: torch.Tensor,
                  h: torch.Tensor, kind: str) -> torch.Tensor:
    """``final_ln(h) @ head`` from float32 operands: the reference takes
    this contraction from bf16 operands straight to float32
    (``preferred_element_type``), with no bf16 rounding of the result.
    ``owner`` keeps the head's float32 copy."""
    h = norm_apply(final_ln, h, kind)
    return h.to(torch.float32) @ _head_f32(owner, head)


def embed_lookup(embed: torch.Tensor, cfg: ArchConfig,
                 tokens: torch.Tensor, shard=None) -> torch.Tensor:
    """``embed[tokens]`` in the compute dtype. A tensor-parallel rank
    holding block ``shard.index`` of the vocab rows looks up the tokens
    of its block, zeros for the others, and adds the rows over the
    ranks: one rank's row and zeros, so the sum is the row."""
    shard = cut_for(shard, embed)
    if shard is None:
        return embed[tokens.long()].to(compute_dtype(cfg))
    V_r = embed.shape[0]
    t = tokens.long() - shard.index * V_r
    mine = ((t >= 0) & (t < V_r))[..., None]
    rows = embed[t.clamp(0, V_r - 1)]
    rows = torch.where(mine, rows, torch.zeros((), dtype=rows.dtype,
                                               device=rows.device))
    return shard.reduce(rows).to(compute_dtype(cfg))


def vocab_gather(head: torch.Tensor, logits: torch.Tensor,
                 shard=None) -> torch.Tensor:
    """The logits of ``head`` (the parameter holding the vocab: the
    output head, or a tied embedding), all-gathered over a
    tensor-parallel rank's ranks where it holds a block of the vocab;
    whole ones as they are."""
    shard = cut_for(shard, head)
    return logits if shard is None else shard.gather(logits, -1)


def _dots_policy(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of matrix products without batch dimensions (``mm``,
    ``addmm``, and a ``bmm`` of batch 1, which is how ``torch.einsum``
    lowers some unbatched products), recompute everything else, the
    batched products (attention scores, ``bmm`` of batch > 1)
    included."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, policy: str = "nothing"):
    """``fn`` rematerialised where a gradient is wanted: the reference's
    ``jax.checkpoint`` with the ``"nothing"`` policy (a call keeps only
    its inputs and runs again in the backward pass) or the ``"dots"``
    policy (:func:`_dots_policy`: the unbatched matmuls' outputs are kept
    and only the rest runs again). ``torch.utils.checkpoint``,
    non-reentrant; outside autograd it is ``fn``. ``fn`` takes modules,
    the config and tensors or constants. Neither policy changes a
    number: gradients are bit for bit those without remat."""
    if policy not in ("nothing", "dots"):
        raise ValueError(f"remat policy {policy!r}: 'nothing' or 'dots'")
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def layer(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return layer
