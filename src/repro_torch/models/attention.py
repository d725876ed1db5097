"""GQA attention: train/prefill (full, causal, sliding-window, or
bidirectional), decode with a KV cache, and cross-attention.

The port of :mod:`repro.models.attention`. A layer's parameters live in
:class:`Attention` under the reference's names and ``(in, out)``
layouts; the functions take the module where the reference takes its
dict. The reference computes attention as plain einsums outside any
kernel, and so does the port: matmuls, a float32 softmax, and the
probabilities cast to ``v``'s dtype before their product with ``v``.
The scores are the reference's float32 contraction of the (bf16)
operands, so ``q`` and ``k`` are widened to float32 first: the product
of two bf16 values is exact in float32.

Decode caches: ``{"k", "v"}`` of shape ``(B, S, K, hd)``, post-RoPE and
before the GQA repeat. :func:`decode_attention` returns a new cache and
leaves its input as it was. Its ``pos`` may be a Python int or a 0-d
tensor on the cache's device, read without a host sync. The reference's
``dynamic_update_slice`` clamps a ``pos`` past the cache's end and
overwrites the last slot; the port raises ``ValueError`` for an int
``pos`` out of range and clamps a tensor ``pos`` as the reference does
(a check would cost a sync). The hybrid's cache is a ring
(``decode_attention(..., ring=True)``): every ``pos`` has its slot.

Tensor parallel (``attention(..., shard=ModelShard)`` and
``decode_attention(..., shard=)``, the sharded serving steps'): a rank
holds its ``"model"`` cut of ``wq`` / ``bq`` (a block of the H·hd
columns), of ``wk`` / ``wv`` where the kv heads divide the ranks (else
they are whole) and of ``wo`` (the same block of rows). It computes the
heads of its block and multiplies their outputs by its rows of ``wo``:
a partial sum, added over the ranks (``layers.cut_matmul``). Where the
block does not hold whole heads (arctic's 56 heads over 16 ranks), the
rank all-gathers q and computes every head its block touches, keeping
its own columns. A decode cache is this rank's shard, cut over the
mesh's ``"model"`` ranks by heads (``shard.cuts["k"]`` -2: this rank's
kv heads, those of its q heads) or by sequence (-3: slots ``[r S/M,
(r+1) S/M)``; q of every head all-gathered, the owner of the new
position's slot writes it, each rank's softmax partials ``(m, l, o)``
of every head all-gathered and merged in rank order, then the rank's
own heads go through its rows of ``wo``). No cache leaf is ever
gathered. One code path serves a cut and a whole layer (the whole
layer's block is all of it, its reduce and gather none), so without a
shard the step's bits are those of the single card.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.axisctx import constrain
from repro_torch.distributed.collectives import cut_for
from repro_torch.models.layers import (cut_matmul, dense_init,
                                       head_norm_apply, param_dtype,
                                       rope_apply)

_F32 = torch.float32


class Attention(nn.Module):
    """``wq`` (d, H·hd), ``wk`` / ``wv`` (d, K·hd), ``wo`` (H·hd, d); with
    ``qkv_bias`` also ``bq`` / ``bk`` / ``bv`` (zeros), with ``qk_norm``
    ``q_norm`` / ``k_norm`` (hd,) (ones)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        dt = param_dtype(cfg)
        d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = dense_init((d, h * hd), dt, generator, device=device)
        self.wk = dense_init((d, k * hd), dt, generator, device=device)
        self.wv = dense_init((d, k * hd), dt, generator, device=device)
        self.wo = dense_init((h * hd, d), dt, generator, device=device)
        if cfg.qkv_bias:
            for name, n in (("bq", h * hd), ("bk", k * hd), ("bv", k * hd)):
                setattr(self, name, nn.Parameter(
                    torch.zeros(n, dtype=dt, device=device)))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(hd, dtype=dt,
                                                  device=device))
            self.k_norm = nn.Parameter(torch.ones(hd, dtype=dt,
                                                  device=device))


def attn_init(cfg: ArchConfig, generator: torch.Generator,
              device=None) -> Attention:
    return Attention(cfg, generator, device)


class _Heads(NamedTuple):
    """The q heads ``[h0, h1)`` a rank computes (q all-gathered over
    ``"model"`` first where ``gather``), the columns ``[c0, c1)`` of
    their outputs that meet its rows of ``wo`` (counted from head
    ``h0``'s first)."""
    gather: bool
    h0: int
    h1: int
    c0: int
    c1: int


def _heads(p: Attention, cfg: ArchConfig, shard, every: bool = False
           ) -> _Heads:
    """This rank's :class:`_Heads`: the heads of its block of ``wq``'s
    columns, or, with ``every`` (the sequence rule's merge needs every
    head's partials), all of them."""
    hd, full = cfg.head_dim, cfg.n_heads * cfg.head_dim
    shard = cut_for(shard, p.wq)
    if shard is None:
        return _Heads(False, 0, cfg.n_heads, 0, full)
    width = p.wq.shape[1]
    c0 = shard.index * width
    c1 = c0 + width
    if not every and c0 % hd == 0 and c1 % hd == 0:
        return _Heads(False, c0 // hd, c1 // hd, 0, width)
    h0, h1 = (0, cfg.n_heads) if every else (c0 // hd, -(-c1 // hd))
    return _Heads(True, h0, h1, c0 - h0 * hd, c1 - h0 * hd)


def _project_q(p: Attention, cfg: ArchConfig, x: torch.Tensor,
               heads: Optional[_Heads] = None, shard=None):
    q = x @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    if heads is not None and heads.gather:
        q = shard.gather(q, -1)[..., heads.h0 * cfg.head_dim:
                                heads.h1 * cfg.head_dim]
    q = q.reshape(*x.shape[:-1], q.shape[-1] // cfg.head_dim, cfg.head_dim)
    q = constrain(q, "batch", "seq", "heads", None)
    if cfg.qk_norm:
        q = head_norm_apply(p.q_norm, q)
    return q


def _project_kv(p: Attention, cfg: ArchConfig, x: torch.Tensor):
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        k = k + p.bk
        v = v + p.bv
    k = k.reshape(*x.shape[:-1], k.shape[-1] // cfg.head_dim, cfg.head_dim)
    v = v.reshape(*x.shape[:-1], v.shape[-1] // cfg.head_dim, cfg.head_dim)
    k = constrain(k, "batch", "seq", "kv_heads", None)
    v = constrain(v, "batch", "seq", "kv_heads", None)
    if cfg.qk_norm:
        k = head_norm_apply(p.k_norm, k)
    return k, v


def _repeat_kv(cfg: ArchConfig, k: torch.Tensor) -> torch.Tensor:
    """``jnp.repeat`` along the head axis: each kv head repeats in place,
    (k0, k0, k1, k1, ...), not tiled."""
    if cfg.n_kv_heads == cfg.n_heads:
        return k
    k = k.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=-2)
    return constrain(k, "batch", "seq", "heads", None)


def _kv_for(cfg: ArchConfig, k: torch.Tensor, heads: _Heads
            ) -> torch.Tensor:
    """``k`` (..., K_r, hd) repeated for the q heads of ``heads``: the
    GQA repeat of every kv head here where they are those heads' own
    (a whole layer, the heads rule's cut), else the kv heads of the
    window ``[h0, h1)`` taken from every kv head, then repeated."""
    g = cfg.n_heads // cfg.n_kv_heads
    if k.shape[-2] * g == heads.h1 - heads.h0:
        return _repeat_kv(cfg, k)
    k0, k1 = heads.h0 // g, -(-heads.h1 // g)
    kr = k[..., k0:k1, :]
    if g > 1:
        kr = kr.repeat_interleave(g, dim=-2)
    return kr[..., heads.h0 - k0 * g:heads.h1 - k0 * g, :]


def _wo(p: Attention, out: torch.Tensor, heads: _Heads, shard
        ) -> torch.Tensor:
    """The heads' outputs (..., (h1 - h0) hd) through this rank's rows of
    ``wo``: its own columns kept, the partial sums added over the
    ranks where the rows are cut."""
    if heads.gather:
        out = out[..., heads.c0:heads.c1]
    return cut_matmul(out, p.wo, shard)


def _sdpa(q, k, v, mask, head_dim: int) -> torch.Tensor:
    """Scores and softmax in float32; q (B, T, H, hd), k / v (B, S, H,
    hd), mask broadcastable to (B, H, T, S)."""
    # a 0-d float32 tensor on the host, as the reference computes it
    scale = 1.0 / torch.sqrt(torch.tensor(head_dim, dtype=_F32))
    scores = torch.einsum("bthd,bshd->bhts", q.to(_F32), k.to(_F32)) * scale
    scores = constrain(scores, "batch", "heads", None, None)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)
    return constrain(out, "batch", "seq", "heads", None)


def _sdpa_chunked(q, k, v, positions, causal: bool, window: Optional[int],
                  head_dim: int, qc: int) -> torch.Tensor:
    """Q-chunked attention: never materializes the full (T, S) score
    tensor, only (qc, S) a chunk. Where a gradient is wanted each chunk
    is rematerialized in the backward pass."""
    B, T, H, hd = q.shape
    S = k.shape[1]
    kpos = positions[:, None, None, :]              # (B, 1, 1, S)

    def chunk(qi, pqi):                             # (B, qc, H, hd), (B, qc)
        mask = torch.ones((B, 1, qc, S), dtype=torch.bool, device=q.device)
        qpos = pqi[:, None, :, None]                # (B, 1, qc, 1)
        if causal:
            mask = qpos >= kpos
        if window is not None:
            mask = mask & (qpos - kpos < window)
        return _sdpa(qi, k, v, mask, head_dim)

    outs = []
    for i in range(T // qc):
        qi, pqi = q[:, i * qc:(i + 1) * qc], positions[:, i * qc:(i + 1) * qc]
        if torch.is_grad_enabled():
            outs.append(checkpoint(chunk, qi, pqi, use_reentrant=False))
        else:
            outs.append(chunk(qi, pqi))
    return torch.cat(outs, dim=1)


def attention(p: Attention, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None,
              memory: Optional[torch.Tensor] = None,
              return_kv: bool = False, shard=None):
    """Full-sequence attention (train / prefill / encoder / cross).

    memory: (B, M, d) for cross-attention (keys/values from memory,
    bidirectional over memory, no RoPE). return_kv: also return the
    ``{"k", "v"}`` pair (pre-GQA-repeat; a tensor-parallel rank's own
    kv heads where they are cut, else every one) so prefill can emit a
    decode cache. ``shard``: a tensor-parallel rank's (the module
    docstring)."""
    B, T, _ = x.shape
    heads = _heads(p, cfg, shard)
    q = _project_q(p, cfg, x, heads, shard)
    chunked = (memory is None and cfg.attn_chunk != 0
               and T > cfg.attn_chunk and T % cfg.attn_chunk == 0)
    if memory is None:
        k, v = _project_kv(p, cfg, x)
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)
        if not chunked:
            qpos = positions[..., :, None]   # (B?, T, 1)
            kpos = positions[..., None, :]   # (B?, 1, S)
            mask = torch.ones((T, T), dtype=torch.bool, device=x.device)
            if causal:
                mask = qpos >= kpos
            if window is not None:
                mask = mask & (qpos - kpos < window)
            if mask.ndim == 3:
                mask = mask[:, None, :, :]
    else:
        k, v = _project_kv(p, cfg, memory)
        mask = torch.ones((1, 1, T, memory.shape[1]), dtype=torch.bool,
                          device=x.device)
    kr = _kv_for(cfg, k, heads)
    vr = _kv_for(cfg, v, heads)
    if chunked:
        out = _sdpa_chunked(q, kr, vr, positions, causal, window,
                            cfg.head_dim, cfg.attn_chunk)
    else:
        out = _sdpa(q, kr, vr, mask, cfg.head_dim)
    out = _wo(p, out.reshape(B, T, -1), heads, shard)
    out = constrain(out, "batch", "seq", "embed")
    if return_kv:
        return out, {"k": k, "v": v}
    return out


# -- decode path --------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
               device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_slot(buf: torch.Tensor, new: torch.Tensor,
               pos: Union[int, torch.Tensor]) -> torch.Tensor:
    """A copy of ``buf`` (B, S, ...) with ``new`` (B, 1, ...) written at
    index ``pos`` of axis 1. An int ``pos`` outside ``[0, S)`` raises
    ``ValueError``; a tensor ``pos`` is clamped into it on the card, as
    the reference's ``dynamic_update_slice`` clamps (no host read)."""
    S = buf.shape[1]
    if isinstance(pos, torch.Tensor):
        idx = pos.reshape(1).to(device=buf.device, dtype=torch.long)
        return buf.index_copy(1, idx.clamp(0, S - 1), new)
    if not 0 <= pos < S:
        raise ValueError(f"decode position {pos} is outside the cache's "
                         f"{S} slots")
    out = buf.clone()
    out[:, pos:pos + 1] = new
    return out


def positions_of(pos: Union[int, torch.Tensor], B: int,
                 device) -> torch.Tensor:
    """(B, 1) int32 positions of a one-token step at ``pos``."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1, 1).to(device=device,
                                    dtype=torch.int32).expand(B, 1)
    return torch.full((B, 1), pos, dtype=torch.int32, device=device)


def decode_attention(p: Attention, cfg: ArchConfig, x: torch.Tensor,
                     cache: Dict, pos, *, window: Optional[int] = None,
                     ring: bool = False, shard=None
                     ) -> Tuple[torch.Tensor, Dict]:
    """One-token step. x: (B, 1, d); pos: int or 0-d int tensor, the
    current index; cache k/v: (B, S, K, hd). Returns (out, new cache).

    ``ring=True`` (the hybrid's cache): the S slots are a ring. Position
    ``pos`` goes to slot ``pos % S`` with its RoPE at ``pos``; slot ``j``
    then holds the key of position ``pos - (pos - j) mod S``, attended
    where that position is >= 0 and inside the window. Below the wrap
    (``pos < S``) this is the plain cache's step.

    ``shard`` (a :class:`repro_torch.distributed.collectives.ModelShard`):
    the layer is this rank's cut and ``cache`` its shard (the module
    docstring)."""
    if shard is not None and shard.cuts.get("k") == -3:
        return _decode_seq(p, cfg, x, cache, pos, window, ring, shard)
    B = x.shape[0]
    S = cache["k"].shape[1]
    heads = _heads(p, cfg, shard)
    q, k_new, v_new = _new_qkv(p, cfg, x, pos, heads, shard)
    slot = pos % S if ring else pos
    k_cache = write_slot(cache["k"], k_new, slot)
    v_cache = write_slot(cache["v"], v_new, slot)
    kpos = torch.arange(S, dtype=torch.int32, device=x.device).view(
        1, 1, 1, S)
    mask = _slot_mask(kpos, pos, S, window, ring)
    out = _sdpa(q, _kv_for(cfg, k_cache, heads),
                _kv_for(cfg, v_cache, heads), mask, cfg.head_dim)
    out = _wo(p, out.reshape(B, 1, -1), heads, shard)
    return out, {"k": k_cache, "v": v_cache}


def _new_qkv(p: Attention, cfg: ArchConfig, x: torch.Tensor, pos,
             heads: _Heads, shard):
    """The new token's q (B, 1, h1 - h0, hd) of ``heads`` and k / v
    (B, 1, K_r, hd) of this rank's kv heads, RoPE'd at ``pos``."""
    posb = positions_of(pos, x.shape[0], x.device)
    q = rope_apply(_project_q(p, cfg, x, heads, shard), posb,
                   cfg.rope_theta)
    k_new, v_new = _project_kv(p, cfg, x)
    return q, rope_apply(k_new, posb, cfg.rope_theta), v_new


def _slot_mask(kpos: torch.Tensor, pos, S: int, window: Optional[int],
               ring: bool):
    """The attended slots among those at global indices ``kpos`` of an
    ``S``-slot cache (a ring's slot ``j`` holds position ``pos - (pos -
    j) mod S``)."""
    if ring:
        kpos = pos - torch.remainder(pos - kpos, S)
        mask = kpos >= 0
    else:
        mask = kpos <= pos
    if window is not None:
        mask = mask & (kpos > pos - window)
    return mask


def _write_owned(buf: torch.Tensor, new: torch.Tensor, local):
    """``buf`` (B, S_r, ...) with ``new`` at local slot ``local`` where
    ``0 <= local < S_r``, else ``buf`` as it is (a tensor ``local`` is
    resolved on the device: the slot's old value is written back)."""
    S_r = buf.shape[1]
    if not isinstance(local, torch.Tensor):
        return write_slot(buf, new, local) if 0 <= local < S_r else buf
    idx = local.reshape(1).to(device=buf.device, dtype=torch.long)
    at = idx.clamp(0, S_r - 1)
    owned = ((idx >= 0) & (idx < S_r)).view(1, 1, *([1] * (buf.dim() - 2)))
    return buf.index_copy(1, at, torch.where(owned, new,
                                             buf.index_select(1, at)))


def _decode_seq(p: Attention, cfg: ArchConfig, x: torch.Tensor,
                cache: Dict, pos, window, ring: bool, shard):
    """The sequence rule: every head of this rank's slots, the softmax
    partials merged across ranks, then this rank's heads through its
    rows of ``wo``."""
    B = x.shape[0]
    S_r = cache["k"].shape[1]
    S = S_r * shard.count
    lo = shard.index * S_r
    heads = _heads(p, cfg, shard, every=True)
    q, k_new, v_new = _new_qkv(p, cfg, x, pos, heads, shard)
    if ring:
        slot = pos % S
    elif isinstance(pos, torch.Tensor):
        slot = pos.clamp(0, S - 1)    # write_slot's clamp, on the device
    elif not 0 <= pos < S:
        raise ValueError(f"decode position {pos} is outside the cache's "
                         f"{S} slots")
    else:
        slot = pos
    k_cache = _write_owned(cache["k"], k_new, slot - lo)
    v_cache = _write_owned(cache["v"], v_new, slot - lo)
    kpos = torch.arange(lo, lo + S_r, dtype=torch.int32,
                        device=x.device).view(1, 1, 1, S_r)
    mask = _slot_mask(kpos, pos, S, window, ring)       # (1|B, 1, 1, S_r)
    scale = 1.0 / torch.sqrt(torch.tensor(cfg.head_dim, dtype=_F32))
    kr, vr = _repeat_kv(cfg, k_cache), _repeat_kv(cfg, v_cache)
    scores = torch.einsum("bthd,bshd->bhts", q.to(_F32), kr.to(_F32)) \
        * scale
    scores = torch.where(mask, scores, -1e30)
    m = scores.amax(dim=-1, keepdim=True)               # (B, H, 1, 1)
    # a shard with every slot masked adds nothing: l and o are 0 there
    w = torch.where(mask, torch.exp(scores - m), 0.0)
    # the weights rounded to v's dtype and multiplied in it, as _sdpa
    # rounds its probabilities (the same bits in float32)
    o = torch.einsum("bhts,bshd->bhd", w.to(vr.dtype), vr)
    part = torch.cat([m[:, :, 0], w.sum(dim=-1), o.to(_F32)],
                     dim=-1)                            # (B, H, 2 + hd)
    every = shard.gather(part[None], 0)                 # (M, B, H, 2+hd)
    top = every[:, :, :, :1].amax(dim=0)
    l_sum = o_sum = None
    for r in range(shard.count):          # rank order: the same bits
        f = torch.exp(every[r, :, :, :1] - top)
        l_r, o_r = f * every[r, :, :, 1:2], f * every[r, :, :, 2:]
        l_sum = l_r if l_sum is None else l_sum + l_r
        o_sum = o_r if o_sum is None else o_sum + o_r
    out = (o_sum / l_sum).to(v_cache.dtype)             # (B, H, hd)
    return (_wo(p, out.reshape(B, 1, -1), heads, shard),
            {"k": k_cache, "v": v_cache})
