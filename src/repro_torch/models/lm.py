"""Unified decoder-only LM: the ``ssm`` (falcon-mamba), ``dense``,
``vlm`` (pixtral) and ``moe`` (dbrx, arctic) families.

The port of :mod:`repro.models.lm`, its ``ssm`` branches and its dense
``else`` branches. The reference scans one layer body over stacked
parameters; here the layers are an ``nn.ModuleList`` walked in order:
a pre-norm residual Mamba1 block (:class:`SSMLayer`) or a pre-norm
attention block followed by an MLP or an MoE (:class:`DenseLayer`). The
vlm family is the dense decoder behind a stubbed frontend: its patch
embeddings come in as ``extra_embeds`` and are prepended. The hybrid
(zamba2) and enc-dec families are not ported yet and raise
``NotImplementedError`` (ROADMAP queue 1 item 14).

Caches keep the reference's structure, stacked on a leading layer axis:
``{"layers": {"conv": (n_layers, B, K-1, din), "h": (n_layers, B, din,
n)}}`` for the ssm family, ``{"layers": {"k", "v"}}`` of shape
``(n_layers, B, S, K, hd)`` (post-RoPE, before the GQA repeat) for the
others. Each call returns a new cache and leaves its input as it was.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm
from repro_torch.models.attention import (attention, attn_init,
                                          decode_attention, init_cache)
from repro_torch.models.layers import (compute_dtype, dense_init, mlp_apply,
                                       mlp_init, norm_apply, norm_init,
                                       param_dtype)
from repro_torch.models.moe import moe_apply, moe_init

_F32 = torch.float32
PORTED_FAMILIES = ("ssm", "dense", "vlm", "moe")


def require_ported(cfg: ArchConfig) -> None:
    """Raise unless ``cfg``'s family is one the port runs."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the port "
            f"runs the {', '.join(PORTED_FAMILIES)} families; the hybrid "
            "and enc-dec come with ROADMAP queue 1 item 14")


# -- modules ------------------------------------------------------------------


class SSMLayer(nn.Module):
    """One residual layer: ``h + mamba(norm(h))`` (the reference's
    per-layer dict ``{"ln", "mamba"}``)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.ln = norm_init(cfg, device=device)
        self.mamba = ssm.mamba1_init(cfg, generator, device)


class DenseLayer(nn.Module):
    """One pre-norm attention layer: ``ln1``, ``attn``, ``ln2``, then
    ``mlp`` or, for the moe family, ``moe`` (the reference's per-layer
    dict)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.ln1 = norm_init(cfg, device=device)
        self.ln2 = norm_init(cfg, device=device)
        self.attn = attn_init(cfg, generator, device)
        if cfg.family == "moe":
            self.moe = moe_init(cfg, generator, device)
        else:
            self.mlp = mlp_init(cfg, generator, device)


class LM(nn.Module):
    """The LM's parameters: ``embed`` (vocab_padded, d), ``layers``,
    ``final_ln`` and, unless embeddings are tied, ``lm_head`` (d,
    vocab_padded). Built by :func:`lm_init`; run by :func:`lm_forward`,
    :func:`lm_prefill` and :func:`lm_decode_step`."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        require_ported(cfg)
        dt = param_dtype(cfg)
        # draw order: embed, layers, head (each from the one generator)
        self.embed = dense_init((cfg.vocab_padded, cfg.d_model), dt,
                                generator, device=device)
        self.final_ln = norm_init(cfg, device=device)
        layer = SSMLayer if cfg.family == "ssm" else DenseLayer
        self.layers = nn.ModuleList(layer(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.lm_head = dense_init((cfg.d_model, cfg.vocab_padded), dt,
                                      generator, device=device)


def lm_init(cfg: ArchConfig, generator: torch.Generator, device=None) -> LM:
    return LM(cfg, generator, device)


def _head_f32(params: LM, cfg: ArchConfig) -> torch.Tensor:
    """The output head in float32. Where no gradient is wanted the copy is
    kept on the module and made again only when the head's storage or
    version changes (``load_state_dict``, ``.to``): the head of
    falcon-mamba-7b is 1 GiB in float32, too much to convert every decode
    step."""
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    if head.dtype == _F32 or (torch.is_grad_enabled() and head.requires_grad):
        return head.to(_F32)
    key = (head.device, head.data_ptr(), head._version)
    if getattr(params, "_head_key", None) != key:
        # a normal tensor even under inference_mode, so that a later
        # forward outside it may use the copy
        with torch.inference_mode(False), torch.no_grad():
            params._head_f32 = head.to(_F32)
        params._head_key = key
    return params._head_f32


def _logits(params: LM, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """``final_ln(h) @ head`` from float32 operands: the reference takes
    this contraction from bf16 operands straight to float32
    (``preferred_element_type``), with no bf16 rounding of the result."""
    h = norm_apply(params.final_ln, h, cfg.norm)
    return h.to(_F32) @ _head_f32(params, cfg)


def _embed(params: LM, cfg: ArchConfig, tokens, extra_embeds):
    cdt = compute_dtype(cfg)
    h = params.embed[tokens.long()].to(cdt)
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(cdt), h], dim=1)
    return h


# -- forward (train / prefill) ------------------------------------------------


def lm_forward(params: LM, cfg: ArchConfig, tokens: torch.Tensor,
               extra_embeds: Optional[torch.Tensor] = None,
               window: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, T_text) int; extra_embeds: (B, T_front, d) for
    vlm/audio stubs (prepended). Returns (logits f32, aux_loss)."""
    require_ported(cfg)
    h = _embed(params, cfg, tokens, extra_embeds)
    aux = torch.zeros((), dtype=_F32, device=h.device)
    if cfg.family == "ssm":
        layer = _maybe_remat(cfg, _ssm_layer)
        for lp in params.layers:
            h = layer(lp, cfg, h)
    else:
        positions = _positions(h)
        layer = _maybe_remat(cfg, _dense_layer)
        for lp in params.layers:
            h, a = layer(lp, cfg, h, positions, window)
            aux = aux + a
    return _logits(params, cfg, h), aux


def _positions(h: torch.Tensor) -> torch.Tensor:
    B, T = h.shape[:2]
    return torch.arange(T, dtype=torch.int32, device=h.device)[None].expand(
        B, T)


def _ssm_layer(lp: SSMLayer, cfg: ArchConfig, h: torch.Tensor
               ) -> torch.Tensor:
    return h + ssm.mamba1_apply(lp.mamba, cfg, norm_apply(lp.ln, h, cfg.norm))


def _mix(lp: DenseLayer, cfg: ArchConfig, h: torch.Tensor):
    """The layer's MLP or MoE on ``ln2(h)``: (delta, aux)."""
    x = norm_apply(lp.ln2, h, cfg.norm)
    if cfg.family == "moe":
        return moe_apply(lp.moe, cfg, x)
    return mlp_apply(lp.mlp, cfg, x), torch.zeros((), dtype=_F32,
                                                  device=h.device)


def _dense_layer(lp: DenseLayer, cfg: ArchConfig, h: torch.Tensor,
                 positions: torch.Tensor, window: Optional[int]):
    h = h + attention(lp.attn, cfg, norm_apply(lp.ln1, h, cfg.norm),
                      positions, causal=True, window=window)
    m, aux = _mix(lp, cfg, h)
    return h + m, aux


def _maybe_remat(cfg: ArchConfig, fn):
    """Per-layer rematerialisation, the reference's ``jax.checkpoint`` with
    the ``"nothing"`` policy: where a gradient is wanted, a layer keeps
    only its inputs and runs again in the backward pass
    (``torch.utils.checkpoint``, non-reentrant; the Mamba1 scan kernel
    then runs twice a layer per step). ``fn`` takes the layer, the config
    and tensors or constants. The ``"dots"`` policy (keep the matmul
    outputs) is not ported yet."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy != "nothing":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported yet: the port "
            "rematerialises with the 'nothing' policy only (ROADMAP queue 1 "
            "item 14)")

    def layer(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)
    return layer


# -- prefill (forward + emit decode caches) -----------------------------------


def lm_prefill(params: LM, cfg: ArchConfig, tokens: torch.Tensor,
               extra_embeds: Optional[torch.Tensor] = None,
               window: Optional[int] = None
               ) -> Tuple[torch.Tensor, Dict]:
    """Forward pass that also materializes the decode cache (KV for the
    attention families, the final recurrent states and conv tails for the
    ssm family). Returns (last-position logits (B, 1, V), cache)."""
    require_ported(cfg)
    h = _embed(params, cfg, tokens, extra_embeds)
    if cfg.family != "ssm":
        positions = _positions(h)
        ks, vs = [], []
        for lp in params.layers:
            a, kv = attention(lp.attn, cfg, norm_apply(lp.ln1, h, cfg.norm),
                              positions, causal=True, window=window,
                              return_kv=True)
            h = h + a
            h = h + _mix(lp, cfg, h)[0]
            ks.append(kv["k"])
            vs.append(kv["v"])
        new_cache = {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}
        return _logits(params, cfg, h[:, -1:]), new_cache
    convs, states = [], []
    for lp in params.layers:
        y, cache = _ssm_prefill_layer(lp, cfg, h, ssm.mamba1_apply)
        h = h + y
        convs.append(cache["conv"])
        states.append(cache["h"])
    new_cache = {"layers": {"conv": torch.stack(convs),
                            "h": torch.stack(states)}}
    return _logits(params, cfg, h[:, -1:]), new_cache


def _ssm_prefill_layer(lp: SSMLayer, cfg: ArchConfig, h: torch.Tensor,
                       apply_fn):
    """Run the ssm layer, returning (delta, decode cache) — the cache is
    the scan's final carry (conv tail + recurrent state)."""
    xin = norm_apply(lp.ln, h, cfg.norm)
    return apply_fn(lp.mamba, cfg, xin, return_cache=True)


# -- decode -------------------------------------------------------------------


def lm_init_cache(cfg: ArchConfig, batch: int, max_len: int,
                  device=None) -> Dict:
    """Stacked per-layer caches (leading dim = layers)."""
    require_ported(cfg)
    if cfg.family != "ssm":
        one = init_cache(cfg, batch, max_len, compute_dtype(cfg), device)
    else:
        one = ssm.mamba1_cache(cfg, batch, compute_dtype(cfg), device)
    return {"layers": {k: v[None].expand(cfg.n_layers, *v.shape).clone()
                       for k, v in one.items()}}


def lm_decode_step(params: LM, cfg: ArchConfig, token: torch.Tensor, pos,
                   cache: Dict, window: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Dict]:
    """token: (B, 1) int; pos: the token's position, an int or a 0-d int
    tensor on the card (unused by the ssm family; see
    :func:`repro_torch.models.attention.decode_attention`). Returns
    (logits (B, 1, V) f32, new cache)."""
    require_ported(cfg)
    h = params.embed[token.long()].to(compute_dtype(cfg))
    layers = cache["layers"]
    if cfg.family != "ssm":
        ks, vs = [], []
        for i, lp in enumerate(params.layers):
            a, cl = decode_attention(
                lp.attn, cfg, norm_apply(lp.ln1, h, cfg.norm),
                {"k": layers["k"][i], "v": layers["v"][i]}, pos,
                window=window)
            h = h + a
            h = h + _mix(lp, cfg, h)[0]
            ks.append(cl["k"])
            vs.append(cl["v"])
        new_cache = {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}
        return _logits(params, cfg, h), new_cache
    convs, states = [], []
    for i, lp in enumerate(params.layers):
        y, cl = ssm.mamba1_decode(lp.mamba, cfg,
                                  norm_apply(lp.ln, h, cfg.norm),
                                  {"conv": layers["conv"][i],
                                   "h": layers["h"][i]})
        h = h + y
        convs.append(cl["conv"])
        states.append(cl["h"])
    new_cache = {"layers": {"conv": torch.stack(convs),
                            "h": torch.stack(states)}}
    return _logits(params, cfg, h), new_cache
