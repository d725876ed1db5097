"""Unified decoder-only LM: the ``ssm`` (falcon-mamba), ``dense``,
``vlm`` (pixtral), ``moe`` (dbrx, arctic) and ``hybrid`` (zamba2)
families.

The port of :mod:`repro.models.lm`. The reference scans one layer body
over stacked parameters; here the layers are an ``nn.ModuleList`` walked
in order: a pre-norm residual Mamba1 or Mamba2 block (:class:`SSMLayer`)
or a pre-norm attention block followed by an MLP or an MoE
(:class:`DenseLayer`). The vlm family is the dense decoder behind a
stubbed frontend: its patch embeddings come in as ``extra_embeds`` and
are prepended.

The hybrid (zamba2): ``n_groups = n_layers // period`` groups, each the
shared attention block (:class:`SharedBlock`) on ``concat(hidden,
embeddings)`` and then ``period`` Mamba2 layers, plus ``n_layers %
period`` trailing Mamba2 layers (``tail_layers``). The shared block's
weights are shared across its calls; its KV caches are one a group.

Caches keep the reference's structure, stacked on leading layer axes:
``{"layers": {"conv": (n_layers, B, K-1, din), "h": (n_layers, B, din,
n)}}`` for the ssm family; ``{"layers": {"k", "v"}}`` of shape
``(n_layers, B, S, K, hd)`` (post-RoPE, before the GQA repeat) for the
dense ones; for the hybrid ``{"attn": {"k", "v"}: (n_groups, B, S, K,
hd), "mamba": {...}: (n_groups, period, B, ...), "tail": {...}: (tail,
B, ...)}``. Each call returns a new cache and leaves its input as it was.

The hybrid's attention cache is a ring (:func:`lm_init_cache` gives it
``min(max_len, sliding_window)`` slots from 100,000 positions on):
position ``pos`` goes to slot ``pos % S`` with its RoPE at ``pos``, and a
step attends to every filled slot whose key lies in ``(pos - window,
pos]``. The reference passes ``pos % S`` itself as the position once it
wraps (RoPE at the wrong position, and the previous lap's keys masked
out); the port does not copy that.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.axisctx import constrain
from repro_torch.models import ssm
from repro_torch.models.attention import (attention, attn_init,
                                          decode_attention, init_cache)
from repro_torch.models.layers import (compute_dtype, dense_init,
                                       embed_lookup, mlp_apply, mlp_init,
                                       norm_apply, norm_init, output_logits,
                                       param_dtype, remat, vocab_gather)
from repro_torch.models.moe import moe_apply, moe_init

_F32 = torch.float32


# -- modules ------------------------------------------------------------------


class SSMLayer(nn.Module):
    """One residual layer: ``h + mamba(norm(h))`` (the reference's
    per-layer dict ``{"ln", "mamba"}``); the mixer is Mamba1 for the ssm
    family, Mamba2 for the hybrid."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.ln = norm_init(cfg, device=device)
        init = ssm.mamba1_init if cfg.family == "ssm" else ssm.mamba2_init
        self.mamba = init(cfg, generator, device)


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


class SharedBlock(nn.Module):
    """The hybrid's shared attention block (the reference's
    ``_shared_block_init``): ``in_proj`` (2d, d) from ``concat(hidden,
    embeddings)``, then ``ln1``, ``attn``, ``ln2`` and ``mlp``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        d = cfg.d_model
        self.in_proj = dense_init((2 * d, d), param_dtype(cfg), generator,
                                  device=device)
        self.ln1 = norm_init(cfg, device=device)
        self.ln2 = norm_init(cfg, device=device)
        self.attn = attn_init(cfg, generator, device)
        self.mlp = mlp_init(cfg, generator, device)


def hybrid_layout(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(period, n_groups, tail) of the hybrid's layers."""
    period = cfg.hybrid_attn_period
    n_groups = cfg.n_layers // period
    return period, n_groups, cfg.n_layers - n_groups * period


class LM(nn.Module):
    """The LM's parameters: ``embed`` (vocab_padded, d), ``layers``,
    ``final_ln`` and, unless embeddings are tied, ``lm_head`` (d,
    vocab_padded); for the hybrid ``layers`` holds ``n_groups`` groups of
    ``period`` layers, beside ``tail_layers`` (when the period does not
    divide the depth) and ``shared``. Built by :func:`lm_init`; run by
    :func:`lm_forward`, :func:`lm_prefill` and :func:`lm_decode_step`."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        if cfg.family == "encdec":
            raise ValueError("the enc-dec family is an EncDec "
                             "(repro_torch.models.encdec), not an LM")
        dt = param_dtype(cfg)
        # draw order: embed, layers, shared, head (from the one generator)
        self.embed = dense_init((cfg.vocab_padded, cfg.d_model), dt,
                                generator, device=device)
        self.final_ln = norm_init(cfg, device=device)

        def stack(layer, n):
            return nn.ModuleList(layer(cfg, generator, device)
                                 for _ in range(n))
        if cfg.family == "hybrid":
            period, n_groups, tail = hybrid_layout(cfg)
            self.layers = nn.ModuleList(stack(SSMLayer, period)
                                        for _ in range(n_groups))
            if tail:
                self.tail_layers = stack(SSMLayer, tail)
            self.shared = SharedBlock(cfg, generator, device)
        else:
            self.layers = stack(SSMLayer if cfg.family == "ssm"
                                else DenseLayer, cfg.n_layers)
        if not cfg.tie_embeddings:
            self.lm_head = dense_init((cfg.d_model, cfg.vocab_padded), dt,
                                      generator, device=device)


def lm_init(cfg: ArchConfig, generator: torch.Generator, device=None) -> LM:
    return LM(cfg, generator, device)


def _logits(params: LM, cfg: ArchConfig, h: torch.Tensor,
            shard=None) -> torch.Tensor:
    vocab = params.embed if cfg.tie_embeddings else params.lm_head
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = output_logits(params, params.final_ln, head, h, cfg.norm)
    return constrain(vocab_gather(vocab, logits, shard), "batch", "seq",
                     "vocab")


def _embed(params: LM, cfg: ArchConfig, tokens, extra_embeds, shard=None):
    cdt = compute_dtype(cfg)
    h = embed_lookup(params.embed, cfg, tokens, shard)
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(cdt), h], dim=1)
    return constrain(h, "batch", "seq", "embed")


def _tail_layers(params: LM) -> nn.ModuleList:
    return getattr(params, "tail_layers", nn.ModuleList())


def _stack(caches: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-layer cache dicts stacked on a new leading axis."""
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _index(cache: Dict[str, torch.Tensor], *i) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in cache.items()}


# -- forward (train / prefill) ------------------------------------------------


def lm_forward(params: LM, cfg: ArchConfig, tokens: torch.Tensor,
               extra_embeds: Optional[torch.Tensor] = None,
               window: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, T_text) int; extra_embeds: (B, T_front, d) for
    vlm/audio stubs (prepended). Returns (logits f32, aux_loss)."""
    h = _embed(params, cfg, tokens, extra_embeds)
    aux = torch.zeros((), dtype=_F32, device=h.device)
    if cfg.family == "ssm":
        layer = _maybe_remat(cfg, _ssm_layer)
        for lp in params.layers:
            h = layer(lp, cfg, h)
    elif cfg.family == "hybrid":
        positions, emb0 = _positions(h), h
        shared = _maybe_remat(cfg, _shared_block)
        layer = _maybe_remat(cfg, _ssm_layer)
        for group in params.layers:
            h = shared(params.shared, cfg, h, emb0, positions, window)
            for lp in group:
                h = layer(lp, cfg, h)
        for lp in _tail_layers(params):
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


def _ssm_apply(cfg: ArchConfig):
    return ssm.mamba1_apply if cfg.family == "ssm" else ssm.mamba2_apply


def _ssm_layer(lp: SSMLayer, cfg: ArchConfig, h: torch.Tensor
               ) -> torch.Tensor:
    return h + _ssm_apply(cfg)(lp.mamba, cfg, norm_apply(lp.ln, h, cfg.norm))


def _mix(lp: DenseLayer, cfg: ArchConfig, h: torch.Tensor, shard=None):
    """The layer's MLP or MoE on ``ln2(h)``: (delta, aux). ``shard``: a
    sharded serving step's (tensor parallel; :func:`_moe_of_slice`)."""
    x = norm_apply(lp.ln2, h, cfg.norm)
    if cfg.family == "moe":
        if shard is not None and shard.batch_groups:
            return _moe_of_slice(lp, cfg, x, shard)
        return moe_apply(lp.moe, cfg, x, shard)
    return mlp_apply(lp.mlp, cfg, x, shard), torch.zeros(
        (), dtype=_F32, device=h.device)


def _moe_of_slice(lp: DenseLayer, cfg: ArchConfig, x: torch.Tensor, shard):
    """The MoE of this dp slice's rows ``x`` (B_r, T, d) with the dispatch
    groups of the whole batch, as the single-card step forms them
    (``min(moe_group_size, B T)`` consecutive tokens): where this
    slice's tokens are not whole groups, the rows of every dp rank are
    gathered and the groups that cover this slice's tokens run here.
    The aux loss is that of the groups run."""
    B_r, T, d = x.shape
    n_dp = 1
    for g in shard.batch_groups:
        n_dp *= torch.distributed.get_world_size(g)
    Sg = min(cfg.moe_group_size, B_r * n_dp * T)
    if (B_r * T) % Sg == 0:
        return moe_apply(lp.moe, cfg, x, shard)
    every = shard.gather_batch(x).reshape(-1, d)
    idx = 0
    for g in shard.batch_groups:    # this rank's place in the gather
        idx = idx * torch.distributed.get_world_size(g) + \
            torch.distributed.get_rank(g)
    t0, t1 = idx * B_r * T, (idx + 1) * B_r * T
    a, b = t0 // Sg * Sg, -(-t1 // Sg) * Sg
    out, aux = moe_apply(lp.moe, cfg, every[a:b][None], shard)
    return out[0, t0 - a:t1 - a].reshape(B_r, T, d), aux


def _dense_layer(lp: DenseLayer, cfg: ArchConfig, h: torch.Tensor,
                 positions: torch.Tensor, window: Optional[int]):
    h = h + attention(lp.attn, cfg, norm_apply(lp.ln1, h, cfg.norm),
                      positions, causal=True, window=window)
    m, aux = _mix(lp, cfg, h)
    return h + m, aux


def _shared_in(sp: SharedBlock, h: torch.Tensor, emb: torch.Tensor):
    return torch.cat([h, emb], dim=-1) @ sp.in_proj


def _shared_out(sp: SharedBlock, cfg: ArchConfig, h: torch.Tensor,
                u: torch.Tensor, a: torch.Tensor, shard=None
                ) -> torch.Tensor:
    """The shared block after its attention: ``h + u'`` where ``u' = u +
    a`` plus the MLP of ``ln2(u')``."""
    u = u + a
    u = u + mlp_apply(sp.mlp, cfg, norm_apply(sp.ln2, u, cfg.norm), shard)
    return h + u


def _shared_block(sp: SharedBlock, cfg: ArchConfig, h: torch.Tensor,
                  emb: torch.Tensor, positions: torch.Tensor,
                  window: Optional[int]) -> torch.Tensor:
    u = _shared_in(sp, h, emb)
    a = attention(sp.attn, cfg, norm_apply(sp.ln1, u, cfg.norm), positions,
                  causal=True, window=window)
    return _shared_out(sp, cfg, h, u, a)


def _maybe_remat(cfg: ArchConfig, fn):
    """Per-layer rematerialisation under ``cfg.remat_policy``
    (:func:`repro_torch.models.layers.remat`; under ``"nothing"`` the
    Mamba1 scan kernel runs twice a layer per step)."""
    return remat(fn, cfg.remat_policy) if cfg.remat else fn


# -- prefill (forward + emit decode caches) -----------------------------------


def lm_prefill(params: LM, cfg: ArchConfig, tokens: torch.Tensor,
               extra_embeds: Optional[torch.Tensor] = None,
               window: Optional[int] = None, shard=None
               ) -> Tuple[torch.Tensor, Dict]:
    """Forward pass that also materializes the decode cache (KV for the
    attention families, the final recurrent states and conv tails for the
    ssm family, both for the hybrid). Returns (last-position logits (B,
    1, V), cache). ``shard``: a sharded prefill's
    :class:`repro_torch.distributed.collectives.ModelShard`: its layers
    are tensor parallel over the ``"model"`` ranks (each layer's
    module docstring) on this rank's rows, the cache holds this rank's
    cut of the heads and channels (every kv head where they are not
    cut), and an MoE layer reads its ``batch_groups``
    (:func:`_moe_of_slice`)."""
    h = _embed(params, cfg, tokens, extra_embeds, shard)
    positions = _positions(h)
    if cfg.family == "ssm":
        caches = []
        for lp in params.layers:
            y, c = _ssm_prefill_layer(lp, cfg, h, shard)
            h = h + y
            caches.append(c)
        new_cache = {"layers": _stack(caches)}
    elif cfg.family == "hybrid":
        sp, emb0 = params.shared, h
        kvs, groups = [], []
        for group in params.layers:
            u = _shared_in(sp, h, emb0)
            a, kv = attention(sp.attn, cfg, norm_apply(sp.ln1, u, cfg.norm),
                              positions, causal=True, window=window,
                              return_kv=True, shard=shard)
            h = _shared_out(sp, cfg, h, u, a, shard)
            kvs.append(kv)
            caches = []
            for lp in group:
                y, c = _ssm_prefill_layer(lp, cfg, h, shard)
                h = h + y
                caches.append(c)
            groups.append(_stack(caches))
        new_cache = {"attn": _stack(kvs), "mamba": _stack(groups)}
        caches = []
        for lp in _tail_layers(params):
            y, c = _ssm_prefill_layer(lp, cfg, h, shard)
            h = h + y
            caches.append(c)
        if caches:
            new_cache["tail"] = _stack(caches)
    else:
        kvs = []
        for lp in params.layers:
            a, kv = attention(lp.attn, cfg, norm_apply(lp.ln1, h, cfg.norm),
                              positions, causal=True, window=window,
                              return_kv=True, shard=shard)
            h = h + a
            h = h + _mix(lp, cfg, h, shard)[0]
            kvs.append(kv)
        new_cache = {"layers": _stack(kvs)}
    return _logits(params, cfg, h[:, -1:], shard), new_cache


def _ssm_prefill_layer(lp: SSMLayer, cfg: ArchConfig, h: torch.Tensor,
                       shard=None):
    """Run the ssm layer, returning (delta, decode cache) — the cache is
    the scan's final carry (conv tails + recurrent state)."""
    xin = norm_apply(lp.ln, h, cfg.norm)
    return _ssm_apply(cfg)(lp.mamba, cfg, xin, return_cache=True,
                           shard=shard)


# -- decode -------------------------------------------------------------------


def _stacked(one: Dict[str, torch.Tensor], *lead: int
             ) -> Dict[str, torch.Tensor]:
    return {k: v.expand(*lead, *v.shape).clone() for k, v in one.items()}


def lm_init_cache(cfg: ArchConfig, batch: int, max_len: int,
                  device=None) -> Dict:
    """Stacked per-layer caches (leading dims = layers). The hybrid's
    attention cache has ``min(max_len, sliding_window)`` slots (a ring)
    from ``max_len`` 100,000 on, else ``max_len``, as in the
    reference."""
    cdt = compute_dtype(cfg)
    if cfg.family == "ssm":
        return {"layers": _stacked(ssm.mamba1_cache(cfg, batch, cdt, device),
                                   cfg.n_layers)}
    if cfg.family == "hybrid":
        period, n_groups, tail = hybrid_layout(cfg)
        attn_len = (min(max_len, cfg.sliding_window or max_len)
                    if max_len >= 100_000 else max_len)
        one = ssm.mamba2_cache(cfg, batch, cdt, device)
        cache = {"mamba": _stacked(one, n_groups, period),
                 "attn": _stacked(init_cache(cfg, batch, attn_len, cdt,
                                             device), n_groups)}
        if tail:
            cache["tail"] = _stacked(one, tail)
        return cache
    return {"layers": _stacked(init_cache(cfg, batch, max_len, cdt, device),
                               cfg.n_layers)}


def lm_decode_step(params: LM, cfg: ArchConfig, token: torch.Tensor, pos,
                   cache: Dict, window: Optional[int] = None, shard=None
                   ) -> Tuple[torch.Tensor, Dict]:
    """token: (B, 1) int; pos: the token's position, an int or a 0-d int
    tensor on the card (unused by the ssm family; see
    :func:`repro_torch.models.attention.decode_attention`; the hybrid's
    attention cache is a ring). Returns (logits (B, 1, V) f32, new
    cache). ``shard`` (a :class:`repro_torch.distributed.collectives.
    ModelShard`): the layers are tensor parallel, as in
    :func:`lm_prefill`, and ``cache`` is this rank's shard, every leaf
    keeping its stack dims whole, which each layer works on
    (``decode_attention``, ``mamba1_decode``, ``mamba2_decode``)."""
    h = embed_lookup(params.embed, cfg, token, shard)
    if cfg.family == "ssm":
        layers, caches = cache["layers"], []
        for i, lp in enumerate(params.layers):
            y, c = ssm.mamba1_decode(lp.mamba, cfg,
                                     norm_apply(lp.ln, h, cfg.norm),
                                     _index(layers, i), shard)
            h = h + y
            caches.append(c)
        new_cache = {"layers": _stack(caches)}
    elif cfg.family == "hybrid":
        sp, emb0 = params.shared, h
        kvs, groups = [], []
        for g, group in enumerate(params.layers):
            u = _shared_in(sp, h, emb0)
            a, kv = decode_attention(sp.attn, cfg,
                                     norm_apply(sp.ln1, u, cfg.norm),
                                     _index(cache["attn"], g), pos,
                                     window=window, ring=True, shard=shard)
            h = _shared_out(sp, cfg, h, u, a, shard)
            kvs.append(kv)
            caches = []
            for i, lp in enumerate(group):
                y, c = ssm.mamba2_decode(lp.mamba, cfg,
                                         norm_apply(lp.ln, h, cfg.norm),
                                         _index(cache["mamba"], g, i), shard)
                h = h + y
                caches.append(c)
            groups.append(_stack(caches))
        new_cache = {"mamba": _stack(groups), "attn": _stack(kvs)}
        caches = []
        for i, lp in enumerate(_tail_layers(params)):
            y, c = ssm.mamba2_decode(lp.mamba, cfg,
                                     norm_apply(lp.ln, h, cfg.norm),
                                     _index(cache["tail"], i), shard)
            h = h + y
            caches.append(c)
        if caches:
            new_cache["tail"] = _stack(caches)
    else:
        layers, kvs = cache["layers"], []
        for i, lp in enumerate(params.layers):
            a, kv = decode_attention(lp.attn, cfg,
                                     norm_apply(lp.ln1, h, cfg.norm),
                                     _index(layers, i), pos, window=window,
                                     shard=shard)
            h = h + a
            h = h + _mix(lp, cfg, h, shard)[0]
            kvs.append(kv)
        new_cache = {"layers": _stack(kvs)}
    return _logits(params, cfg, h, shard), new_cache
