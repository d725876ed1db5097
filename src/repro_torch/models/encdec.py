"""Encoder-decoder backbone (seamless-m4t-large-v2).

The port of :mod:`repro.models.encdec`. The audio frontend is a stub:
``input_specs`` supplies precomputed frame embeddings (B, S_enc, d)
directly to the encoder, which attends bidirectionally. The decoder is
causal, with cross-attention to the encoder's memory; at decode time the
memory is a fixed precomputed tensor. Plain PyTorch, as the reference is
plain ``jnp`` (no kernel).

Parameters live in :class:`EncDec` under the reference's names
(``embed``, ``lm_head``, ``enc_layers``, ``dec_layers``, ``enc_ln``,
``final_ln``); the layers are ``nn.ModuleList``s walked in order. With
``cfg.remat`` each layer is rematerialised where a gradient is wanted,
always with the ``"nothing"`` policy, as the reference's ``_remat``.

Decode cache: ``{"self": {"k", "v"}: (n_layers, B, S, K, hd)}``.

``shard`` (a :class:`repro_torch.distributed.collectives.ModelShard`,
the sharded serving steps'): every layer of the encoder and decoder,
self- and cross-attention and MLP, is tensor parallel as in
:mod:`repro_torch.models.lm`, and so are the embedding and the head.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (attention, attn_init,
                                          decode_attention, init_cache,
                                          positions_of)
from repro_torch.models.layers import (compute_dtype, dense_init,
                                       embed_lookup, mlp_apply, mlp_init,
                                       norm_apply, norm_init, output_logits,
                                       param_dtype, remat, vocab_gather)

_F32 = torch.float32


class EncLayer(nn.Module):
    """``ln1``, ``attn`` (bidirectional), ``ln2``, ``mlp``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.ln1 = norm_init(cfg, device=device)
        self.ln2 = norm_init(cfg, device=device)
        self.attn = attn_init(cfg, generator, device)
        self.mlp = mlp_init(cfg, generator, device)


class DecLayer(nn.Module):
    """``ln1``, ``self_attn`` (causal), ``ln2``, ``cross_attn`` (on the
    memory), ``ln3``, ``mlp``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.ln1 = norm_init(cfg, device=device)
        self.ln2 = norm_init(cfg, device=device)
        self.ln3 = norm_init(cfg, device=device)
        self.self_attn = attn_init(cfg, generator, device)
        self.cross_attn = attn_init(cfg, generator, device)
        self.mlp = mlp_init(cfg, generator, device)


class EncDec(nn.Module):
    """``embed`` (vocab_padded, d), ``lm_head`` (d, vocab_padded),
    ``enc_layers`` (``cfg.enc_layers``), ``dec_layers``
    (``cfg.n_layers``), ``enc_ln`` and ``final_ln``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        dt = param_dtype(cfg)
        V, d = cfg.vocab_padded, cfg.d_model
        self.embed = dense_init((V, d), dt, generator, device=device)
        self.lm_head = dense_init((d, V), dt, generator, device=device)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, generator, device)
                                        for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(DecLayer(cfg, generator, device)
                                        for _ in range(cfg.n_layers))
        self.enc_ln = norm_init(cfg, device=device)
        self.final_ln = norm_init(cfg, device=device)


def encdec_init(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> EncDec:
    return EncDec(cfg, generator, device)


def _remat(cfg: ArchConfig, fn):
    """Per-layer remat under ``cfg.remat_policy``. The reference's
    enc-dec rematerialises under ``"nothing"`` whatever the policy; the
    policies give the same numbers bit for bit and differ only in memory
    and time."""
    return remat(fn, cfg.remat_policy) if cfg.remat else fn


def _positions(B: int, T: int, device) -> torch.Tensor:
    return torch.arange(T, dtype=torch.int32, device=device)[None].expand(
        B, T)


def _enc_layer(lp: EncLayer, cfg: ArchConfig, h: torch.Tensor,
               pos: torch.Tensor, shard=None) -> torch.Tensor:
    h = h + attention(lp.attn, cfg, norm_apply(lp.ln1, h, cfg.norm), pos,
                      causal=False, shard=shard)
    return h + mlp_apply(lp.mlp, cfg, norm_apply(lp.ln2, h, cfg.norm),
                         shard)


def encode(params: EncDec, cfg: ArchConfig, frame_embeds: torch.Tensor,
           shard=None) -> torch.Tensor:
    """frame_embeds: (B, S_enc, d) stub frontend output -> the memory
    (B, S_enc, d) in the compute dtype."""
    h = frame_embeds.to(compute_dtype(cfg))
    pos = _positions(*h.shape[:2], h.device)
    layer = _remat(cfg, _enc_layer)
    for lp in params.enc_layers:
        h = layer(lp, cfg, h, pos, shard)
    return norm_apply(params.enc_ln, h, cfg.norm)


def _cross_mlp(lp: DecLayer, cfg: ArchConfig, h: torch.Tensor,
               pos: torch.Tensor, memory: torch.Tensor,
               shard=None) -> torch.Tensor:
    """The decoder layer after its self-attention: cross-attention on
    ``memory``, then the MLP."""
    h = h + attention(lp.cross_attn, cfg, norm_apply(lp.ln2, h, cfg.norm),
                      pos, memory=memory, shard=shard)
    return h + mlp_apply(lp.mlp, cfg, norm_apply(lp.ln3, h, cfg.norm),
                         shard)


def _dec_layer(lp: DecLayer, cfg: ArchConfig, h: torch.Tensor,
               pos: torch.Tensor, memory: torch.Tensor,
               shard=None) -> torch.Tensor:
    h = h + attention(lp.self_attn, cfg, norm_apply(lp.ln1, h, cfg.norm),
                      pos, causal=True, shard=shard)
    return _cross_mlp(lp, cfg, h, pos, memory, shard)


def decode_train(params: EncDec, cfg: ArchConfig, tokens: torch.Tensor,
                 memory: torch.Tensor, last_only: bool = False,
                 shard=None) -> torch.Tensor:
    """Teacher-forced decoder pass. tokens: (B, S_dec); memory (B, S_enc,
    d). Returns float32 logits (B, S_dec, V), or with ``last_only`` the
    last position's (B, 1, V): the norm and the head act a position at a
    time, so these are the same numbers."""
    h = embed_lookup(params.embed, cfg, tokens, shard)
    pos = _positions(*h.shape[:2], h.device)
    layer = _remat(cfg, _dec_layer)
    for lp in params.dec_layers:
        h = layer(lp, cfg, h, pos, memory, shard)
    return _logits(params, cfg, h[:, -1:] if last_only else h, shard)


def _logits(params: EncDec, cfg: ArchConfig, h: torch.Tensor, shard=None):
    return vocab_gather(params.lm_head, output_logits(
        params, params.final_ln, params.lm_head, h, cfg.norm), shard)


def encdec_forward(params: EncDec, cfg: ArchConfig,
                   frame_embeds: torch.Tensor, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    memory = encode(params, cfg, frame_embeds)
    logits = decode_train(params, cfg, tokens, memory)
    return logits, torch.zeros((), dtype=_F32, device=logits.device)


def encdec_init_cache(cfg: ArchConfig, batch: int, max_len: int,
                      device=None) -> Dict:
    one = init_cache(cfg, batch, max_len, compute_dtype(cfg), device)
    return {"self": {k: v.expand(cfg.n_layers, *v.shape).clone()
                     for k, v in one.items()}}


def encdec_decode_step(params: EncDec, cfg: ArchConfig, token: torch.Tensor,
                       pos, cache: Dict, memory: torch.Tensor, shard=None
                       ) -> Tuple[torch.Tensor, Dict]:
    """token (B, 1); pos an int or a 0-d int tensor; memory (B, M, d) the
    precomputed encoder output. Returns (logits (B, 1, V) f32, ``{"self":
    new cache}``). ``shard``: the layers are this rank's cut and the
    self-attention cache is its shard
    (:func:`repro_torch.models.attention.decode_attention`)."""
    h = embed_lookup(params.embed, cfg, token, shard)
    posb = positions_of(pos, h.shape[0], h.device)
    ks, vs = [], []
    for i, lp in enumerate(params.dec_layers):
        a, kv = decode_attention(lp.self_attn, cfg,
                                 norm_apply(lp.ln1, h, cfg.norm),
                                 {k: v[i] for k, v in cache["self"].items()},
                                 pos, shard=shard)
        h = _cross_mlp(lp, cfg, h + a, posb, memory, shard)
        ks.append(kv["k"])
        vs.append(kv["v"])
    return _logits(params, cfg, h, shard), {"self": {"k": torch.stack(ks),
                                              "v": torch.stack(vs)}}
