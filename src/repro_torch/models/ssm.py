"""Selective state-space layers: Mamba1 (falcon-mamba).

The port of :mod:`repro.models.ssm`, its Mamba1 half. A block's
parameters live in :class:`Mamba1Block` under the reference's names and
``(in, out)`` layouts; the functions below take the block where the
reference takes its parameter dict, in the same argument order.

Two prefill paths, picked by ``cfg.ssm_impl`` as in the reference:

  * ``"pallas"``: the scan runs as one call of the hand-written kernel
    per layer (:func:`repro_torch.kernels.ops.selective_scan`: the CUDA
    kernel on the card, its plain version on the CPU), and its gradient
    as one call of the backward kernel
    (:func:`repro_torch.kernels.ops.selective_scan_bwd`) — the serving
    and training path;
  * ``"xla"``: plain PyTorch, chunk by chunk, each chunk's scan the
    sequential recurrence (the reference runs an associative scan per
    chunk), differentiated by autograd. Correct but not fast.

Decode is the O(1) recurrence in plain PyTorch, one step of
:func:`_mamba1_core`, as the reference computes it outside any kernel.

Caches: ``{"conv": (B, K-1, din), "h": (B, din, n) float32}``.

Mamba2 (the zamba2 hybrid's block) is not ported yet: its functions
raise ``NotImplementedError`` (ROADMAP queue 1 item 14).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.selective_scan import make_trainable_scan
from repro_torch.models.layers import dense_init, param_dtype

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


def _projections(p: Mamba1Block, conv_out: torch.Tensor):
    """dt (post-softplus), B, C and A of the scan from the post-conv
    activations, all float32. The three small projections round to the
    param dtype first, as the reference's do; ``dt_proj`` runs in
    float32."""
    cv = conv_out.to(p.in_x.dtype)
    dt_low = (cv @ p.proj_dt).to(_F32)
    Bm = (cv @ p.proj_B).to(_F32)
    Cm = (cv @ p.proj_C).to(_F32)
    dt = _softplus(dt_low @ p.dt_proj.to(_F32) + p.dt_bias)   # (B, L, din)
    A = -torch.exp(p.A_log)                                    # (din, n)
    return dt, Bm, Cm, A


def _mamba1_core(p: Mamba1Block, cfg: ArchConfig, conv_out: torch.Tensor,
                 h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv_out: (B, L, din) f32 post-conv/silu; h: (B, din, n) carry.
    Returns (y (B,L,din) f32, h_new). The scan is the plain sequential
    recurrence in float32; ``y``'s sum over the states is taken in
    float32 from float32 operands (the reference's einsum with
    ``preferred_element_type=float32``)."""
    if cfg.ssm_scan_dtype != "float32":
        raise NotImplementedError(
            f"ssm_scan_dtype={cfg.ssm_scan_dtype!r}: the port's plain scan "
            "runs in float32 only")
    dt, Bm, Cm, A = _projections(p, conv_out)
    ys = []
    for t in range(conv_out.shape[1]):
        y_t, h = _ref.selective_scan_step(conv_out[:, t], dt[:, t], Bm[:, t],
                                          Cm[:, t], A, p.D, h)
        ys.append(y_t)
    y = ys[0][:, None] if len(ys) == 1 else torch.stack(ys, dim=1)
    return y, h


def mamba1_apply(p: Mamba1Block, cfg: ArchConfig, x: torch.Tensor,
                 return_cache: bool = False):
    """x: (B, L, d) -> (B, L, d); L must divide by min(cfg.ssm_chunk, L).
    With return_cache=True also returns the decode cache (final conv tail
    + recurrent state) from the scan carry.

    cfg.ssm_impl == "pallas" routes the recurrence through the
    hand-written selective-scan kernels (forward and backward)."""
    if cfg.ssm_impl == "pallas":
        return _mamba1_apply_pallas(p, cfg, x, return_cache)
    B, L, d = x.shape
    din, K = cfg.d_inner, cfg.ssm_conv
    Lc = min(cfg.ssm_chunk, L)
    if L % Lc:
        raise ValueError(f"mamba1_apply: L={L} is not a multiple of the "
                         f"chunk {Lc}")
    xs = x @ p.in_x
    z = x @ p.in_z
    h = torch.zeros((B, din, cfg.ssm_state), dtype=_F32, device=x.device)
    tail = torch.zeros((B, K - 1, din), dtype=x.dtype, device=x.device)
    ys = []
    for s in range(0, L, Lc):
        xin = torch.cat([tail, xs[:, s:s + Lc]], dim=1)
        conv = F.silu(_causal_conv_chunk(xin, p.conv_w, p.conv_b))
        y, h = _mamba1_core(p, cfg, conv, h)
        y = y * F.silu(z[:, s:s + Lc].to(_F32))
        ys.append(y.to(x.dtype))
        tail = xin[:, -(K - 1):]
    out = torch.cat(ys, dim=1) @ p.out_proj
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
                  cache: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d) one token."""
    K = cfg.ssm_conv
    xs = x @ p.in_x
    z = x @ p.in_z
    xin = torch.cat([cache["conv"], xs], dim=1)            # (B, K, din)
    conv = F.silu(_causal_conv_chunk(xin, p.conv_w, p.conv_b))
    y, h_new = _mamba1_core(p, cfg, conv, cache["h"])
    y = y * F.silu(z.to(_F32))
    out = y.to(x.dtype) @ p.out_proj
    return out, {"conv": xin[:, -(K - 1):], "h": h_new}


def _mamba1_apply_pallas(p: Mamba1Block, cfg: ArchConfig, x: torch.Tensor,
                         return_cache: bool = False):
    """The hand-written selective-scan path: one kernel call for the whole
    sequence, the state carried on chip; under autograd the scan's
    gradient is one call of the backward kernel, which recomputes each
    512-step chunk from the chunk-start states the forward saved."""
    B, L, d = x.shape
    din, K, n = cfg.d_inner, cfg.ssm_conv, cfg.ssm_state
    xs = x @ p.in_x
    z = x @ p.in_z
    xin = torch.cat([torch.zeros((B, K - 1, din), dtype=xs.dtype,
                                 device=x.device), xs], dim=1)
    conv = F.silu(_causal_conv_chunk(xin, p.conv_w, p.conv_b))
    dt, Bm, Cm, A = _projections(p, conv)
    h0 = torch.zeros((B, din, n), dtype=_F32, device=x.device)
    scan = make_trainable_scan(din_tile=min(128, din), time_chunk=512)
    y, h_fin = scan(conv, dt, Bm, Cm, A, p.D.to(_F32), h0)
    y = y * F.silu(z.to(_F32))
    out = y.to(x.dtype) @ p.out_proj
    if return_cache:
        # a copy: a view of the tail would keep the layer's whole
        # (B, K-1+L, din) input alive with the cache (17 GB over 64 layers
        # at 8 x 2048 tokens)
        return out, {"conv": xin[:, -(K - 1):].to(x.dtype, copy=True),
                     "h": h_fin}
    return out


# =============================== Mamba 2 (SSD) ===============================


def _mamba2_not_ported(*args, **kwargs):
    raise NotImplementedError(
        "Mamba2 (the zamba2 hybrid's SSD block) is not ported yet: it comes "
        "with the hybrid family, ROADMAP queue 1 item 14")


mamba2_init = mamba2_apply = mamba2_cache = mamba2_decode = _mamba2_not_ported
