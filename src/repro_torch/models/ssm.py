"""Selective state-space layers: Mamba1 (falcon-mamba) and Mamba2 / SSD
(the zamba2 hybrid's backbone).

The port of :mod:`repro.models.ssm`. A block's parameters live in
:class:`Mamba1Block` / :class:`Mamba2Block` under the reference's names
and ``(in, out)`` layouts; the functions below take the block where the
reference takes its parameter dict, in the same argument order.

Two prefill paths, picked by ``cfg.ssm_impl`` as in the reference:

  * ``"pallas"``: the scan runs as one call of the hand-written kernel
    per layer (:func:`repro_torch.kernels.ops.selective_scan`: the CUDA
    kernel on the card, its plain version on the CPU), and its gradient
    as one call of the backward kernel
    (:func:`repro_torch.kernels.ops.selective_scan_bwd`) — the serving
    and training path;
  * ``"xla"``: plain PyTorch, chunk by chunk, each chunk's scan the
    reference's associative scan (:func:`associative_scan`, its
    state-expanded tensors in ``cfg.ssm_scan_dtype``, the carry in
    float32), differentiated by autograd. Its levels are materialised:
    (B, chunk, d_inner, n) tensors, several a level.

Decode is the O(1) recurrence in plain PyTorch, one step of
:func:`_mamba1_core`, as the reference computes it outside any kernel.

Mamba2 is plain PyTorch, as the reference's is plain ``jnp`` (no
kernel): :func:`mamba2_apply` is the chunked SSD form, a quadratic
intra-chunk product plus a float32 state carried from chunk to chunk,
and :func:`mamba2_decode` its O(1) recurrence.

Tensor parallel (``shard=ModelShard``, the sharded serving steps'): a
rank holds its ``"model"`` cut of a block, a block of the ``d_inner``
channels (Mamba1) or of the heads and their channels (Mamba2). Mamba1
runs its channels' conv, ``dt_proj`` and scan (the selective-scan
kernel on ``d_inner / n_model`` channels); ``proj_dt`` / ``proj_B`` /
``proj_C`` contract over the channels, so their products are partial
sums: computed in float32, added over the ranks in float32 (one
all-reduce of the small ``(B, L, dt_rank + 2n)`` product) and only then
rounded to the param dtype, once, as one card rounds the whole
product. Mamba2's B and C convs run on
the rank's state channels where ``n`` is cut and are all-gathered; its
gated norm adds each rank's sum of squares before ``rsqrt``. Both
finish with the rank's rows of ``out_proj``, a partial sum added over
the ranks. A decode cache is the rank's shard of the same channels and
heads.

Caches: Mamba1 ``{"conv": (B, K-1, din), "h": (B, din, n) float32}``;
Mamba2 ``{"conv_x": (B, K-1, din), "conv_B" / "conv_C": (B, K-1, n),
"h": (B, nh, hd, n) float32}``. Conv tails are copies, never views of a
layer's input.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.axisctx import constrain
from repro_torch.distributed.collectives import cut_for
from repro_torch.kernels.selective_scan import make_trainable_scan
from repro_torch.models.layers import (cut_matmul, dense_init, param_dtype,
                                       wide_matmul)

_F32 = torch.float32


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # F.softplus returns x itself above its threshold of 20, where
    # jax.nn.softplus adds log1p(exp(-x)) < 2.1e-9; in float32 that sum
    # rounds back to x, so the two agree there.
    return F.softplus(x.to(_F32))


def _causal_conv_chunk(xin: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """xin: (B, K-1+L, C) left-extended inputs; w: (K, C); b: (C,).
    Returns (B, L, C) float32 causal depthwise conv outputs, summed tap by
    tap in the reference's order."""
    K = w.shape[0]
    L = xin.shape[1] - (K - 1)
    out = torch.zeros((xin.shape[0], L, xin.shape[2]), dtype=_F32,
                      device=xin.device)
    for k in range(K):  # K static & small (4)
        out = out + xin[:, k:k + L].to(_F32) * w[k].to(_F32)
    return out + b.to(_F32)


# =============================== Mamba 1 ====================================


class Mamba1Block(nn.Module):
    """One Mamba1 mixer's parameters, named and laid out as the
    reference's ``mamba1_init`` dict: ``(in, out)`` projections in the
    param dtype; ``dt_bias``, ``A_log`` and ``D`` in float32 whatever the
    param dtype. Applied by :func:`mamba1_apply` / :func:`mamba1_decode`
    with the config, as the reference applies its dict."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        dt = param_dtype(cfg)
        d, din, n, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        rank = max(math.ceil(d / 16), 1)
        kw = dict(generator=generator, device=device)
        self.in_x = dense_init((d, din), dt, **kw)
        self.in_z = dense_init((d, din), dt, **kw)
        self.conv_w = dense_init((K, din), dt, in_axis=0, **kw)
        self.conv_b = nn.Parameter(torch.zeros(din, dtype=dt, device=device))
        self.proj_dt = dense_init((din, rank), dt, **kw)
        self.proj_B = dense_init((din, n), dt, **kw)
        self.proj_C = dense_init((din, n), dt, **kw)
        self.dt_proj = dense_init((rank, din), dt, **kw)
        # softplus^-1(0.01)
        self.dt_bias = nn.Parameter(torch.full((din,), -4.6, dtype=_F32,
                                               device=device))
        # S4D-real A init: A_log rows log(1..n)
        a_row = torch.log(torch.arange(1, n + 1, dtype=_F32, device=device))
        self.A_log = nn.Parameter(a_row.repeat(din, 1))
        self.D = nn.Parameter(torch.ones(din, dtype=_F32, device=device))
        self.out_proj = dense_init((din, d), dt, **kw)


def mamba1_init(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Mamba1Block:
    return Mamba1Block(cfg, generator, device)


def _projections(p: Mamba1Block, conv_out: torch.Tensor, shard=None):
    """dt (post-softplus), B, C and A of the scan from the post-conv
    activations, all float32. The three small projections round to the
    param dtype first, as the reference's do; ``dt_proj`` runs in
    float32. ``shard``: a rank of cut channels, whose three products
    are partial sums, added over the ranks (the module docstring)."""
    cv = conv_out.to(p.in_x.dtype)
    if shard is None:
        dt_low = (cv @ p.proj_dt).to(_F32)
        Bm = (cv @ p.proj_B).to(_F32)
        Cm = (cv @ p.proj_C).to(_F32)
    else:
        # the partial products in float32 (those of two param-dtype
        # values are exact), summed over the ranks, then rounded once to
        # the param dtype: one card's rounding of the whole product
        low = shard.reduce(torch.cat(
            [wide_matmul(cv, p.proj_dt), wide_matmul(cv, p.proj_B),
             wide_matmul(cv, p.proj_C)], dim=-1)).to(cv.dtype)
        dt_low, Bm, Cm = low.to(_F32).split(
            [p.proj_dt.shape[1], p.proj_B.shape[1], p.proj_C.shape[1]],
            dim=-1)
    dt = _softplus(dt_low @ p.dt_proj.to(_F32) + p.dt_bias)   # (B, L, din)
    A = -torch.exp(p.A_log)                                    # (din, n)
    return dt, Bm, Cm, A


def _sl(x: torch.Tensor, dim: int, start, stop, step=None) -> torch.Tensor:
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """``a[0], b[0], a[1], b[1], ...`` along ``dim``; ``a`` has as many
    entries as ``b`` or one more."""
    n = b.shape[dim]
    out = torch.stack([_sl(a, dim, 0, n), b], dim=dim + 1).flatten(dim,
                                                                   dim + 1)
    return out if a.shape[dim] == n else torch.cat([out, _sl(a, dim, n,
                                                             None)], dim)


def associative_scan(fn, elems: List[torch.Tensor], dim: int
                     ) -> List[torch.Tensor]:
    """Inclusive scan of the tensors ``elems`` along ``dim`` under the
    associative ``fn(a_list, b_list) -> list``, by
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs,
    scan the pairs, combine each scanned pair with the next even
    element, interleave. The same association order gives the same
    roundings as the reference's, bf16 included. Differentiable by
    autograd; its levels hold about twice the input's elements."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    pairs = fn([_sl(e, dim, 0, -1, 2) for e in elems],
               [_sl(e, dim, 1, None, 2) for e in elems])
    odd = associative_scan(fn, pairs, dim)
    if n % 2 == 0:
        even = fn([_sl(e, dim, 0, -1) for e in odd],
                  [_sl(e, dim, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [_sl(e, dim, 2, None, 2) for e in elems])
    even = [torch.cat([_sl(e, dim, 0, 1), r], dim)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def _muladd(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a + b * c`` rounded as XLA rounds it: one fused multiply-add in
    float32, each operation rounded in bfloat16."""
    if a.dtype == _F32:
        return torch.addcmul(a, b, c)
    return a + b * c


def _comb(a, b):
    """The linear recurrence's combine: ``(da, ua) then (db, ub)`` is
    ``(da db, ub + db ua)``."""
    (da, ua), (db, ub) = a, b
    return [da * db, _muladd(ub, db, ua)]


def _mamba1_core(p: Mamba1Block, cfg: ArchConfig, conv_out: torch.Tensor,
                 h: torch.Tensor, shard=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv_out: (B, L, din) f32 post-conv/silu; h: (B, din, n) carry.
    Returns (y (B,L,din) f32, h_new).

    The reference's chunk scan: the state-expanded ``decay`` and ``u``
    (B, L, din, n) are built in ``cfg.ssm_scan_dtype`` and scanned over
    L by :func:`associative_scan`; the carry ``h`` stays float32, so
    rounding does not compound beyond a chunk. ``y``'s sum over the
    states multiplies the states and ``C``, each rounded to the scan
    dtype, in float32 (the reference's einsum with
    ``preferred_element_type=float32``, which rounds no product)."""
    dt, Bm, Cm, A = _projections(p, conv_out, shard)
    return _scan_core(cfg, conv_out, dt, Bm, Cm, A, p.D, h)


def _scan_core(cfg: ArchConfig, conv_out, dt, Bm, Cm, A, D, h):
    """:func:`_mamba1_core` after its projections: ``conv_out``, ``dt``,
    ``A``, ``D`` and ``h`` of any set of channels (a tensor-parallel
    rank's), ``Bm`` / ``Cm`` of the whole block."""
    sdt = torch.bfloat16 if cfg.ssm_scan_dtype == "bfloat16" else _F32
    decay = torch.exp((dt[..., None] * A).to(_F32)).to(sdt)
    u = (dt * conv_out)[..., None].to(sdt) * Bm[:, :, None, :].to(sdt)
    dec_s, u_s = associative_scan(_comb, [decay, u], dim=1)
    hs = torch.addcmul(u_s.to(_F32), dec_s.to(_F32), h[:, None])
    y = torch.einsum("blin,bln->bli", hs.to(sdt).to(_F32),
                     Cm.to(sdt).to(_F32)) + conv_out * D
    return y, hs[:, -1]


def mamba1_apply(p: Mamba1Block, cfg: ArchConfig, x: torch.Tensor,
                 return_cache: bool = False, shard=None):
    """x: (B, L, d) -> (B, L, d); L must divide by min(cfg.ssm_chunk, L).
    With return_cache=True also returns the decode cache (final conv tail
    + recurrent state) from the scan carry. ``shard``: a
    tensor-parallel rank's (the module docstring).

    cfg.ssm_impl == "pallas" routes the recurrence through the
    hand-written selective-scan kernels (forward and backward)."""
    shard = cut_for(shard, p.in_x)
    if cfg.ssm_impl == "pallas":
        return _mamba1_apply_pallas(p, cfg, x, return_cache, shard)
    B, L, d = x.shape
    din, K = p.in_x.shape[1], cfg.ssm_conv
    Lc = min(cfg.ssm_chunk, L)
    if L % Lc:
        raise ValueError(f"mamba1_apply: L={L} is not a multiple of the "
                         f"chunk {Lc}")
    xs = constrain(x @ p.in_x, "batch", "seq", "inner")
    z = constrain(x @ p.in_z, "batch", "seq", "inner")
    h = torch.zeros((B, din, cfg.ssm_state), dtype=_F32, device=x.device)
    tail = torch.zeros((B, K - 1, din), dtype=x.dtype, device=x.device)
    ys = []
    for s in range(0, L, Lc):
        xin = torch.cat([tail, xs[:, s:s + Lc]], dim=1)
        conv = F.silu(_causal_conv_chunk(xin, p.conv_w, p.conv_b))
        y, h = _mamba1_core(p, cfg, conv, h, shard)
        y = y * F.silu(z[:, s:s + Lc].to(_F32))
        ys.append(y.to(x.dtype))
        tail = xin[:, -(K - 1):]
    y = constrain(torch.cat(ys, dim=1), "batch", "seq", "inner")
    out = constrain(cut_matmul(y, p.out_proj, shard), "batch", "seq",
                    "embed")
    if return_cache:
        # a copy: the view would keep the last chunk's whole input alive
        return out, {"conv": tail.clone(), "h": h}
    return out


def mamba1_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                 device=None) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=_F32,
                         device=device),
    }


def mamba1_decode(p: Mamba1Block, cfg: ArchConfig, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor], shard=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d) one token.

    ``shard`` (a :class:`repro_torch.distributed.collectives.ModelShard`):
    a tensor-parallel rank whose block holds its channels, and whose
    cache holds the same channels' conv tail and state
    (``cache_specs``' rule); it steps them, adding the projections'
    and ``out_proj``'s partial sums over the ranks (the module
    docstring)."""
    shard = cut_for(shard, p.in_x)
    K = cfg.ssm_conv
    xin = torch.cat([cache["conv"], x @ p.in_x], dim=1)
    conv = F.silu(_causal_conv_chunk(xin, p.conv_w, p.conv_b))  # (B, 1, din)
    dt, Bm, Cm, A = _projections(p, conv, shard)
    y, h_new = _scan_core(cfg, conv, dt, Bm, Cm, A, p.D, cache["h"])
    y = y * F.silu((x @ p.in_z).to(_F32))
    out = cut_matmul(y.to(x.dtype), p.out_proj, shard)
    return out, {"conv": xin[:, -(K - 1):], "h": h_new}


def _mamba1_apply_pallas(p: Mamba1Block, cfg: ArchConfig, x: torch.Tensor,
                         return_cache: bool = False, shard=None):
    """The hand-written selective-scan path: one kernel call for the whole
    sequence (a tensor-parallel rank's channels), the state carried on
    chip; under autograd the scan's gradient is one call of the backward
    kernel, which recomputes each 512-step chunk from the chunk-start
    states the forward saved."""
    B, L, d = x.shape
    din, K, n = p.in_x.shape[1], cfg.ssm_conv, cfg.ssm_state
    xs = constrain(x @ p.in_x, "batch", "seq", "inner")
    z = constrain(x @ p.in_z, "batch", "seq", "inner")
    xin = torch.cat([torch.zeros((B, K - 1, din), dtype=xs.dtype,
                                 device=x.device), xs], dim=1)
    conv = F.silu(_causal_conv_chunk(xin, p.conv_w, p.conv_b))
    dt, Bm, Cm, A = _projections(p, conv, shard)
    h0 = torch.zeros((B, din, n), dtype=_F32, device=x.device)
    scan = make_trainable_scan(din_tile=min(128, din), time_chunk=512)
    y, h_fin = scan(conv, dt, Bm, Cm, A, p.D.to(_F32), h0)
    y = y * F.silu(z.to(_F32))
    out = constrain(cut_matmul(y.to(x.dtype), p.out_proj, shard), "batch",
                    "seq", "embed")
    if return_cache:
        # a copy: a view of the tail would keep the layer's whole
        # (B, K-1+L, din) input alive with the cache (17 GB over 64 layers
        # at 8 x 2048 tokens)
        return out, {"conv": xin[:, -(K - 1):].to(x.dtype, copy=True),
                     "h": h_fin}
    return out


# =============================== Mamba 2 (SSD) ===============================


class Mamba2Block(nn.Module):
    """One Mamba2 mixer's parameters, named and laid out as the
    reference's ``mamba2_init`` dict: separate ``(in, out)`` projections
    for x, z, B, C and dt, one depthwise conv each for x, B and C, the
    gated norm's ``norm_scale`` and ``out_proj`` in the param dtype;
    ``A_log`` (log of 1..16 spread over the heads), ``D`` and ``dt_bias``
    per head in float32."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        dt = param_dtype(cfg)
        d, din, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
        nh, K = cfg.ssm_heads, cfg.ssm_conv
        kw = dict(generator=generator, device=device)
        self.in_x = dense_init((d, din), dt, **kw)
        self.in_z = dense_init((d, din), dt, **kw)
        self.in_B = dense_init((d, n), dt, **kw)
        self.in_C = dense_init((d, n), dt, **kw)
        self.in_dt = dense_init((d, nh), dt, **kw)
        for name, ch in (("x", din), ("B", n), ("C", n)):
            setattr(self, f"conv_{name}_w",
                    dense_init((K, ch), dt, in_axis=0, **kw))
            setattr(self, f"conv_{name}_b", nn.Parameter(
                torch.zeros(ch, dtype=dt, device=device)))
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, nh, dtype=_F32, device=device)))
        self.D = nn.Parameter(torch.ones(nh, dtype=_F32, device=device))
        self.dt_bias = nn.Parameter(torch.full((nh,), -2.2, dtype=_F32,
                                               device=device))
        self.norm_scale = nn.Parameter(torch.ones(din, dtype=dt,
                                                  device=device))
        self.out_proj = dense_init((din, d), dt, **kw)


def mamba2_init(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Mamba2Block:
    return Mamba2Block(cfg, generator, device)


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5, shard=None,
                   d_inner: int = 0) -> torch.Tensor:
    """``y * silu(z)`` RMS-normalised over all of ``d_inner``, in
    float32 (``y`` is float32). ``shard``: a rank of cut channels, whose
    sum of squares is added over the ranks before the mean."""
    y = y * F.silu(z.to(_F32))
    if shard is None:
        ms = (y * y).mean(dim=-1, keepdim=True)
    else:
        ms = shard.reduce((y * y).sum(dim=-1, keepdim=True)) / d_inner
    return y * torch.rsqrt(ms + eps) * scale.to(_F32)


def _state_conv(p: Mamba2Block, cfg: ArchConfig, name: str,
                new: torch.Tensor, tail: torch.Tensor, shard):
    """Mamba2's B or C conv (``name``) and its SiLU, float32, on the
    left-extended ``cat(tail, new)`` (B, K-1+L, n_r): ``(out (B, L, n) of
    every state channel, the extended input, whose last K-1 rows are the
    new cache tail)``. A rank whose ``in_B`` / ``in_C`` hold a cut of
    the channels all-gathers the outputs."""
    xin = torch.cat([tail, new], dim=1)
    out = F.silu(_causal_conv_chunk(xin, getattr(p, f"conv_{name}_w"),
                                    getattr(p, f"conv_{name}_b")))
    if cut_for(shard, getattr(p, f"in_{name}")) is not None:
        out = shard.gather(out, -1)
    return out, xin


def _tail(xin: torch.Tensor, K: int) -> torch.Tensor:
    # a copy: a view would keep the whole left-extended input alive
    return xin[:, -(K - 1):].clone()


def mamba2_apply(p: Mamba2Block, cfg: ArchConfig, x: torch.Tensor,
                 return_cache: bool = False, shard=None):
    """Chunked SSD. x: (B, L, d) -> (B, L, d); L must divide by
    min(cfg.ssm_chunk, L). With return_cache=True also returns the decode
    cache (final conv tails + state) from the chunk carry. ``shard``: a
    tensor-parallel rank's (the module docstring; a rank of cut state
    channels gathers each chunk's B and C conv outputs).

    Each chunk of Lc steps: ``y = (C Bᵀ ∘ seg ∘ dt) x`` within the chunk
    plus ``C S exp(cum)`` from the carried state ``S``, which then decays
    by the chunk's whole ``exp(cum[-1])`` and gains the chunk's
    contributions. ``seg`` is ``exp`` of the masked exponent: entries
    above the diagonal get -30 before the ``exp`` (then times the mask),
    so that none can overflow and poison a gradient with ``0 * inf``."""
    B, L, d = x.shape
    shard = cut_for(shard, p.in_x)
    din, n = p.in_x.shape[1], cfg.ssm_state
    nh, hd, K = p.in_dt.shape[1], cfg.ssm_head_dim, cfg.ssm_conv
    Lc = min(cfg.ssm_chunk, L)
    if L % Lc:
        raise ValueError(f"mamba2_apply: L={L} is not a multiple of the "
                         f"chunk {Lc}")
    z = constrain(x @ p.in_z, "batch", "seq", "inner")
    xr = constrain(x @ p.in_x, "batch", "seq", "inner")
    Bm = x @ p.in_B
    Cm = x @ p.in_C
    dt_raw = constrain(x @ p.in_dt, "batch", "seq", "ssm_heads")
    A = -torch.exp(p.A_log.to(_F32))                      # (nh,)
    idx = torch.arange(Lc, device=x.device)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]   # (1,Lc,Lc,1)
    S = torch.zeros((B, nh, hd, n), dtype=_F32, device=x.device)
    tx = torch.zeros((B, K - 1, din), dtype=x.dtype, device=x.device)
    tb = torch.zeros((B, K - 1, Bm.shape[-1]), dtype=x.dtype,
                     device=x.device)
    tc = torch.zeros_like(tb)
    ys = []
    for s in range(0, L, Lc):
        xin_x = torch.cat([tx, xr[:, s:s + Lc]], dim=1)
        xconv = F.silu(_causal_conv_chunk(xin_x, p.conv_x_w, p.conv_x_b))
        Bc, xin_b = _state_conv(p, cfg, "B", Bm[:, s:s + Lc], tb, shard)
        Cc, xin_c = _state_conv(p, cfg, "C", Cm[:, s:s + Lc], tc, shard)
        xc = xconv.reshape(B, Lc, nh, hd)
        # bf16 + float32 promotes to float32, as in the reference
        dt = _softplus(dt_raw[:, s:s + Lc] + p.dt_bias)     # (B, Lc, nh)
        cum = torch.cumsum(dt * A, dim=1)
        # intra-chunk quadratic form
        CB = torch.einsum("bln,bmn->blm", Cc, Bc)
        diff = torch.where(tri, cum[:, :, None, :] - cum[:, None, :, :],
                           -30.0)
        seg = torch.exp(diff) * tri
        att = CB[..., None] * seg * dt[:, None, :, :]       # (B,Lc,Lc,nh)
        y_intra = torch.einsum("blmh,bmhp->blhp", att, xc)
        # inter-chunk via the carried state
        y_inter = torch.einsum("bln,bhpn->blhp", Cc, S) \
            * torch.exp(cum)[..., None]
        # state update
        w_last = torch.exp(cum[:, -1:, :] - cum) * dt        # (B, Lc, nh)
        contrib = torch.einsum("blh,bln,blhp->bhpn", w_last, Bc, xc)
        S = torch.exp(cum[:, -1])[:, :, None, None] * S + contrib
        y = y_intra + y_inter + p.D[None, None, :, None] * xc
        ys.append(y.reshape(B, Lc, din))
        tx, tb, tc = xin_x[:, -(K - 1):], xin_b[:, -(K - 1):], \
            xin_c[:, -(K - 1):]
    y = constrain(ys[0] if len(ys) == 1 else torch.cat(ys, dim=1),
                  "batch", "seq", "inner")
    y = _gated_rmsnorm(y, z, p.norm_scale, shard=shard, d_inner=cfg.d_inner)
    out = constrain(cut_matmul(y.to(x.dtype), p.out_proj, shard), "batch",
                    "seq", "embed")
    if return_cache:
        return out, {"conv_x": tx.clone(), "conv_B": tb.clone(),
                     "conv_C": tc.clone(), "h": S}
    return out


def mamba2_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                 device=None) -> Dict[str, torch.Tensor]:
    n, K = cfg.ssm_state, cfg.ssm_conv
    return {
        "conv_x": torch.zeros((batch, K - 1, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_B": torch.zeros((batch, K - 1, n), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, K - 1, n), dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
                         dtype=_F32, device=device),
    }


def mamba2_decode(p: Mamba2Block, cfg: ArchConfig, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor], shard=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d) one token; one step of the recurrence
    ``h = exp(dt A) h + dt B x``, ``y = C h + D x``.

    ``shard`` (a :class:`repro_torch.distributed.collectives.ModelShard`):
    a tensor-parallel rank whose block holds its heads and their
    channels, and whose cache holds the same heads' state and channels'
    conv tails (``cache_specs``' rule; B's and C's where ``n`` is cut);
    it steps them (the module docstring)."""
    B = x.shape[0]
    shard = cut_for(shard, p.in_x)
    din = p.in_x.shape[1]
    nh, hd, K = p.in_dt.shape[1], cfg.ssm_head_dim, cfg.ssm_conv
    z = x @ p.in_z
    xin_x = torch.cat([cache["conv_x"], x @ p.in_x], dim=1)
    xconv = F.silu(_causal_conv_chunk(xin_x, p.conv_x_w, p.conv_x_b))
    Bc, xin_b = _state_conv(p, cfg, "B", x @ p.in_B, cache["conv_B"], shard)
    Cc, xin_c = _state_conv(p, cfg, "C", x @ p.in_C, cache["conv_C"], shard)
    dt_raw = x @ p.in_dt
    xc = xconv[:, 0].reshape(B, nh, hd)
    dt = _softplus(dt_raw[:, 0] + p.dt_bias)               # (B, nh_r)
    A = -torch.exp(p.A_log.to(_F32))
    decay = torch.exp(dt * A)                              # (B, nh_r)
    contrib = dt[:, :, None, None] * Bc[:, 0, None, None, :] \
        * xc[:, :, :, None]                                # (B, nh_r, hd, n)
    h_new = decay[:, :, None, None] * cache["h"] + contrib
    y = torch.einsum("bn,bhpn->bhp", Cc[:, 0], h_new) \
        + p.D[None, :, None] * xc
    y = _gated_rmsnorm(y.reshape(B, 1, din), z, p.norm_scale, shard=shard,
                       d_inner=cfg.d_inner)
    out = cut_matmul(y.to(x.dtype), p.out_proj, shard)
    return out, {"conv_x": _tail(xin_x, K), "conv_B": _tail(xin_b, K),
                 "conv_C": _tail(xin_c, K), "h": h_new}
