"""Plain PyTorch versions of the port's kernels (the ``ref.py`` layer).

Each computes what its kernel computes, on any device, with the same
outputs as the JAX package's oracles in :mod:`repro.kernels.ref`. The
CPU tests run them, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card. Nothing on the engine's path calls them for
tensors that live on the card: :mod:`repro_torch.kernels.ops` launches
the kernel there. The Mamba1 model calls the plain scan on the card on
purpose, where the reference computes it outside any kernel: decode's
one-step recurrence (:func:`selective_scan_step`) and the ``xla``
prefill path.
"""

from __future__ import annotations

from typing import Optional

import torch


def block_agg_ref(values, gids, mask, center, *, num_groups: int):
    """Plain version of :func:`repro_torch.kernels.block_agg.block_agg`
    over flat ``(N,)`` rows: per group ``g``,
    ``count = Σ m``, ``dsum = Σ (v - c)·m``, ``dsq = Σ (v - c)²·m``, and
    the masked min / max (``+inf`` / ``-inf`` when the group is empty).

    The three sums are one ``index_add_`` of an ``(N, 3)`` column stack:
    on the CPU it adds rows in row order, the same order as the JAX
    package's ``.at[].add`` scatter, so the two agree bit for bit. The
    extremes are one ``amin`` scatter over ``(v | +inf, -v | +inf)``,
    the max taken as the negated min, as the JAX oracle does.

    Returns ``(sums (3, G), vmin (1, G), vmax (1, G))`` float32.
    """
    v = values.reshape(-1).to(torch.float32)
    m = mask.reshape(-1).to(torch.float32)
    gid = gids.reshape(-1).to(torch.int64)
    dv = v - float(center)   # the scalar rounds to float32, as in JAX # aqplint: disable=AQP101(center is a Python number: no host sync)
    cols = torch.stack([m, dv * m, dv * dv * m], dim=1)            # (N, 3)
    sums = torch.zeros((num_groups, 3), dtype=torch.float32,
                       device=v.device).index_add_(0, gid, cols)
    live = m > 0
    inf = float("inf")
    mm = torch.stack([torch.where(live, v, inf),
                      torch.where(live, -v, inf)], dim=1)          # (N, 2)
    mins = torch.full((num_groups, 2), float("inf"), dtype=torch.float32,
                      device=v.device).scatter_reduce_(
        0, gid[:, None].expand(-1, 2), mm, "amin", include_self=True)
    return sums.T.contiguous(), mins[None, :, 0], -mins[None, :, 1]


def block_agg_blocks_ref(values, gids, mask, blk, tvalid, center, *,
                         num_groups: int):
    """Plain version of the kernel's full interface: gather blocks ``blk``
    of the ``(nb, block_rows)`` slabs, zero the mask of lanes whose
    ``tvalid`` is false, and fold the rows in order (as the reference's
    ``fused_round`` gathers before its fold)."""
    mask = mask[blk] * tvalid[:, None].to(torch.float32)
    return block_agg_ref(values[blk], gids[blk], mask, center,
                         num_groups=num_groups)


def hist_bins_ref(values, a: float, b: float, nbins: int):
    """Bin index of each value on the uniform ``nbins``-bin grid over
    ``[a, b]``, in float32 exactly as the reference computes it:
    ``clip((v - f32(a)) * f32(inv_width), 0, nbins - 1)`` truncated, with
    ``inv_width = nbins / max(b - a, 1e-30)`` over the LOGICAL bin count.

    ``+inf`` lands in bin ``nbins - 1`` and ``-inf`` in bin 0. A NaN lands
    in bin 0, as the JAX package's float-to-int conversion puts it there
    on the CPU; torch's conversion would give ``INT32_MIN``, so NaN is
    mapped to 0 before the cast. Returns int64 ``(N,)`` bins."""
    inv_width = float(nbins) / max(float(b) - float(a), 1e-30) # aqplint: disable=AQP101(the grid's Python numbers: no host sync)
    # Python scalars round to float32, as in JAX; one op each, no FMA
    t = torch.clamp((values - float(a)) * inv_width, 0.0, nbins - 1.0) # aqplint: disable=AQP101(a is a Python number: no host sync)
    return torch.nan_to_num(t, nan=0.0).to(torch.int64)


def grouped_hist_ref(values, gids, mask, a: float, b: float, *,
                     num_groups: int, nbins: int):
    """Plain version of :func:`repro_torch.kernels.grouped_hist.
    grouped_hist` over flat rows: ``hist[g, k] = Σ m · 1[gid = g] ·
    1[bin(v) = k]`` (:func:`hist_bins_ref`), the counterpart of
    :func:`repro.kernels.ref.grouped_hist_ref`.

    The mask is added as it is. The engine's masks are 0 or 1, so every
    count is a whole number, exact in float32 up to 2**24 per bin, and
    any order of the adds gives the same bits. Returns float32
    ``(num_groups, nbins)``."""
    v = values.reshape(-1).to(torch.float32)
    m = mask.reshape(-1).to(torch.float32)
    gid = gids.reshape(-1).to(torch.int64)
    flat = gid * nbins + hist_bins_ref(v, a, b, nbins)
    hist = torch.zeros(num_groups * nbins, dtype=torch.float32,
                       device=v.device).index_add_(0, flat, m)
    return hist.reshape(num_groups, nbins)


def fused_fold_ref(values, gids, mask, blk, tvalid, center, a: float,
                   b: float, *, num_groups: int, nbins: int):
    """Plain version of :func:`repro_torch.kernels.fused_fold.fused_fold`:
    :func:`block_agg_blocks_ref`'s sums and extremes plus
    :func:`grouped_hist_ref` over the same selected rows (blocks ``blk``
    of the ``(nb, block_rows)`` slabs, lanes whose ``tvalid`` is false
    masked out). Returns ``(sums (3, G), vmin (1, G), vmax (1, G),
    hist (G, nbins))`` float32."""
    mask = mask[blk] * tvalid[:, None].to(torch.float32)
    v, g = values[blk], gids[blk]
    sums, vmin, vmax = block_agg_ref(v, g, mask, center,
                                     num_groups=num_groups)
    hist = grouped_hist_ref(v, g, mask, a, b, num_groups=num_groups,
                            nbins=nbins)
    return sums, vmin, vmax, hist


def active_blocks_ref(words, active_words):
    """Plain version of
    :func:`repro_torch.kernels.bitmap_active.active_blocks`:
    ``flag[i] = any_w(words[i, w] & active[w]) != 0``.

    Words are uint32 bit patterns carried in int32 tensors (torch has no
    ``max``/``>``/``any`` for ``uint32`` on the CPU), so the AND and the
    zero test run on int32 and give the same bits. Returns int32
    ``(nblocks,)`` flags."""
    hit = torch.bitwise_and(words.to(torch.int32),
                            active_words.to(torch.int32)[None, :])
    return (hit != 0).any(dim=1).to(torch.int32)


def budget_select_ref(flags: torch.Tensor, pos: torch.Tensor,
                      left: torch.Tensor, window: int, budget: int):
    """Budgeted selection, replicating the reference cursor bit for bit
    (:func:`repro.kernels.fused_scan._budget_select`): take the first
    ``budget`` flagged blocks; the cursor cut is one past the budget-th
    selected block, else the window's ``left`` positions in range (the
    limit-clamped window end). ``pos`` and ``left`` are int64 device
    scalars. Returns ``(take mask over the window, new_pos (device
    scalar), inclusive flag count per position)``."""
    csum = torch.cumsum(flags.to(torch.int32), 0)
    take = flags & (csum <= budget)
    n_sel = csum[window - 1]
    # argmax over an int tensor: the first maximal index, like jnp.argmax
    # over the bool mask in the reference
    cut = torch.argmax(((csum == budget) & flags).to(torch.int32))
    covered = torch.where(n_sel >= budget, cut + 1, left)
    return take, pos + covered, csum


def gather_blocks_ref(take: torch.Tensor, csum: torch.Tensor,
                      win: torch.Tensor, window: int, budget: int):
    """Selected window positions -> padded block ids + padding-lane mask
    + window position per lane, with no host sync (the reference's
    ``jnp.nonzero(take, size=budget, fill_value=window)``): the k-th taken
    position scatters to lane k, every other position to a spare lane
    that is dropped. Padding lanes point at block 0 with ``tvalid`` False
    and ``take_idx`` = window."""
    dev = take.device
    lane = torch.where(take, csum - 1, budget).to(torch.int64)
    take_idx = torch.full((budget + 1,), window, dtype=torch.int64,
                          device=dev)
    take_idx.scatter_(0, lane, torch.arange(window, dtype=torch.int64,
                                            device=dev))
    take_idx = take_idx[:budget]
    tvalid = take_idx < window
    blk = torch.where(tvalid, win[torch.clamp(take_idx, max=window - 1)],
                      torch.zeros((), dtype=win.dtype, device=dev))
    return blk, tvalid, take_idx


def active_blocks_multi_ref(words, stack):
    """Plain version of :func:`repro_torch.kernels.bitmap_active.
    active_blocks_multi`, the multi-query probe of shared-scan serving:
    row ``q`` of the result is :func:`active_blocks_ref` of ``words``
    against ``stack[q]`` (the reference's ``ref`` branch of
    ``ops.active_blocks_multi``). ``words`` is ``(n, W)`` and ``stack``
    ``(Q, W)``, uint32 bits in int32. Returns int32 ``(Q, n)``."""
    hit = torch.bitwise_and(words.to(torch.int32)[None, :, :],
                            stack.to(torch.int32)[:, None, :])
    return (hit != 0).any(dim=2).to(torch.int32)


def round_window_ref(order_pad, pos: torch.Tensor, go: torch.Tensor, *,
                     nb: int, window: int, lap_end: Optional[int] = None,
                     wrap: bool = False):
    """The round's cursor window, read with no host sync: ``(win, left)``,
    the ``window`` block ids of ``order_pad`` from ``pos`` and the count
    of those positions in range, ``min(window, lap_end - pos)``, or 0
    when the round is not to run (``go`` false, or ``pos`` outside
    ``[lap_end - nb, lap_end]``; ``win`` is then read from position 0 and
    never used).

    ``lap_end`` is the cursor limit (``nb`` by default: a solo scan); a
    slot of a shared pass walks the lap ``[anchor, anchor + nb)`` and
    passes ``anchor + nb``. With ``wrap`` the window starts at ``pos %
    nb`` of a wrap-filled ``order_pad`` (its tail the order's head), so
    a lap past ``nb`` reads a rotation of the scan order."""
    dev = order_pad.device
    end = nb if lap_end is None else lap_end
    live = go & (pos >= end - nb) & (pos <= end)
    left = torch.where(live, torch.clamp(end - pos, max=window),
                       torch.zeros((), dtype=torch.int64, device=dev))
    start = torch.remainder(pos, nb) if wrap else pos
    start = torch.where(live, start, torch.zeros_like(pos))
    offs = torch.arange(window, dtype=torch.int64, device=dev)
    return order_pad[start + offs], left


def round_select_ref(order_pad, static_ok, words, active_words,
                     pos: torch.Tensor, go: torch.Tensor, *, nb: int,
                     window: int, budget: int, probe: bool,
                     lap_end: Optional[int] = None, wrap: bool = False):
    """Plain version of :func:`repro_torch.kernels.bitmap_active.
    round_select`, the fused round's head: the cursor window of
    ``order_pad`` from ``pos`` (:func:`round_window_ref`, with the slot's
    ``lap_end`` and ``wrap``), its static prefilter and (with ``probe``)
    activity verdicts, :func:`budget_select_ref` and
    :func:`gather_blocks_ref`, as the reference's ``fused_round`` (and,
    for a slot of a shared pass, ``_round_scan(bound=, wrap=)``) computes
    them before its fold. ``active_words`` is one ``(W,)`` mask or a
    ``(Q, W)`` stack, whose flags are the union over its rows, ``(ok &
    probe_q).any(0)`` (the reference's ``fused_round_multi``). ``pos``
    (int64) and ``go`` (bool) are device scalars; a round that is not to
    run selects nothing and leaves the cursor where it is. Reads nothing
    back on the host. Returns ``(ok (window,) bool, flags (window,) bool,
    new_pos () int64, blk (budget,) int32, tvalid (budget,) bool)``."""
    win, left = round_window_ref(order_pad, pos, go, nb=nb, window=window,
                                 lap_end=lap_end, wrap=wrap)
    offs = torch.arange(window, dtype=torch.int64, device=order_pad.device)
    ok = static_ok[win] & (offs < left)
    flags = ok
    if probe:
        stack = active_words.reshape(-1, active_words.shape[-1])
        act = active_blocks_multi_ref(words[win], stack) > 0
        flags = (ok[None, :] & act).any(dim=0)
    take, new_pos, csum = budget_select_ref(flags, pos, left, window,
                                            budget)
    blk, tvalid, _ = gather_blocks_ref(take, csum, win, window, budget)
    return ok, flags, new_pos, blk, tvalid


def selective_scan_ref(x, dt, b, c, a, d, h0, time_chunk: int):
    """Plain version of :func:`repro_torch.kernels.selective_scan.
    selective_scan`: the Mamba1 scan as the sequential recurrence of the
    reference's Pallas body (:func:`repro.kernels.selective_scan._kernel`),

        h_t = exp(dt_t · A) ⊙ h_{t-1} + (dt_t · x_t) B_t
        y_t = Σ_n h_t[:, n] C_t[n] + D · x_t

    one float32 operation at a time in that order (the CUDA kernel rounds
    alike; only the order of the sum over ``n`` differs).

    Args:
      x, dt: ``(B, L, din)`` — post-conv activations, post-softplus dt.
      b, c: ``(B, L, n)``; a: ``(din, n)`` (negative); d: ``(din,)``.
      h0: ``(B, din, n)`` carry-in state.
      time_chunk: chunk length ``tc`` (clamped to ``L``; must divide it).

    Returns ``(y (B, L, din), hout (B, din, n), hseg (B, L / tc, din, n))``
    float32, ``hseg[:, k]`` the state at the start of chunk ``k`` (what the
    backward kernel recomputes each chunk from)."""
    B, L, din = x.shape
    n = b.shape[-1]
    tc = min(time_chunk, L)
    if L % tc:
        raise ValueError(f"selective_scan_ref: L={L} is not a multiple of "
                         f"the time chunk {tc}")
    f32 = torch.float32
    x, dt, b, c, a, d, h = (t.to(f32) for t in (x, dt, b, c, a, d, h0))
    y = torch.empty((B, L, din), dtype=f32, device=x.device)
    hseg = torch.empty((B, L // tc, din, n), dtype=f32, device=x.device)
    for t in range(L):
        if t % tc == 0:
            hseg[:, t // tc] = h
        y[:, t], h = selective_scan_step(x[:, t], dt[:, t], b[:, t],
                                         c[:, t], a, d, h)
    return y, h, hseg


def selective_scan_step(x_t, dt_t, b_t, c_t, a, d, h):
    """One step of :func:`selective_scan_ref`'s recurrence, in float32:
    ``x_t, dt_t`` ``(B, din)``; ``b_t, c_t`` ``(B, n)``; ``a`` ``(din, n)``;
    ``d`` ``(din,)``; ``h`` ``(B, din, n)``. Returns ``(y_t (B, din),
    h_t)``."""
    h = selective_scan_state_step(x_t, dt_t, b_t, a, h)
    return (h * c_t[:, None, :]).sum(-1) + d * x_t, h


def selective_scan_state_step(x_t, dt_t, b_t, a, h):
    """The state update of one step,
    ``h_t = exp(dt_t · A) ⊙ h_{t-1} + (dt_t · x_t) B_t``, in float32."""
    decay = torch.exp(dt_t[:, :, None] * a)                    # (B, din, n)
    u = (dt_t * x_t)[:, :, None] * b_t[:, None, :]
    return decay * h + u


def selective_scan_bwd_ref(x, dt, b, c, a, d, hseg, ybar, houtbar,
                           time_chunk: int):
    """Plain version of :func:`repro_torch.kernels.selective_scan.
    selective_scan_bwd`: the scan's backward as the reference's Pallas
    body computes it (:func:`repro.kernels.selective_scan._bwd_kernel`),
    step for step. For each chunk ``k`` of ``tc`` steps, last first, the
    chunk's states are recomputed from ``hseg[:, k]`` (the forward's own
    float32 operations, so its own bits) and the adjoint ``hbar`` runs
    backwards through the chunk:

        dC_t  = Σ_i ybar_t h_t              dD += ybar_t x_t
        hbar += ybar_t C_t                  g   = hbar h_{t-1} exp(dt_t A)
        s     = Σ_n hbar B_t                dB_t = Σ_i hbar (dt_t x_t)
        dA   += g dt_t                      ddt_t = Σ_n g A + s x_t
        dx_t  = ybar_t D + s dt_t           hbar *= exp(dt_t A)

    dA and dD are kept per (batch row, chunk) and summed at the end, as
    the reference's ``_backward`` sums its partials.

    Args: the forward's ``x, dt, b, c, a, d`` (shapes as
    :func:`selective_scan_ref`), its ``hseg (B, L / tc, din, n)``, the
    cotangents ``ybar (B, L, din)`` and ``houtbar (B, din, n)``, and the
    forward's ``time_chunk``.

    Returns ``(dx, ddt (B, L, din), dB, dC (B, L, n), dA (din, n),
    dD (din,), dh0 (B, din, n))`` float32."""
    B, L, din = x.shape
    n = b.shape[-1]
    tc = min(time_chunk, L)
    if L % tc or hseg.shape[1] != L // tc:
        raise ValueError(f"selective_scan_bwd_ref: L={L} and hseg's "
                         f"{hseg.shape[1]} chunks do not fit the time chunk "
                         f"{tc}")
    f32 = torch.float32
    x, dt, b, c, a, d, hseg, ybar, hbar = (
        t.to(f32) for t in (x, dt, b, c, a, d, hseg, ybar, houtbar))
    n_chunks = L // tc
    kw = dict(dtype=f32, device=x.device)
    dx = torch.empty((B, L, din), **kw)
    ddt = torch.empty((B, L, din), **kw)
    db = torch.empty((B, L, n), **kw)
    dc = torch.empty((B, L, n), **kw)
    da_p = torch.empty((B, n_chunks, din, n), **kw)
    dd_p = torch.empty((B, n_chunks, din), **kw)
    for k in reversed(range(n_chunks)):
        lo = k * tc
        hist = []
        h = hseg[:, k]
        for t in range(lo, lo + tc):
            h = selective_scan_state_step(x[:, t], dt[:, t], b[:, t], a, h)
            hist.append(h)
        da_acc = torch.zeros((B, din, n), **kw)
        dd_acc = torch.zeros((B, din), **kw)
        for t in reversed(range(lo, lo + tc)):
            x_t, dt_t, b_t, c_t, ybar_t = (x[:, t], dt[:, t], b[:, t],
                                           c[:, t], ybar[:, t])
            h_t = hist[t - lo]
            h_prev = hist[t - lo - 1] if t > lo else hseg[:, k]
            dc[:, t] = (ybar_t[:, :, None] * h_t).sum(1)
            dd_acc = dd_acc + ybar_t * x_t
            xbar = ybar_t * d
            hbar = hbar + ybar_t[:, :, None] * c_t[:, None, :]
            decay = torch.exp(dt_t[:, :, None] * a)
            decaybar = hbar * h_prev
            dtxbar = (hbar * b_t[:, None, :]).sum(-1)
            db[:, t] = (hbar * (dt_t * x_t)[:, :, None]).sum(1)
            da_acc = da_acc + decaybar * decay * dt_t[:, :, None]
            ddt[:, t] = (decaybar * decay * a).sum(-1) + dtxbar * x_t
            dx[:, t] = xbar + dtxbar * dt_t
            hbar = hbar * decay
        da_p[:, k] = da_acc
        dd_p[:, k] = dd_acc
    return dx, ddt, db, dc, da_p.sum(dim=(0, 1)), dd_p.sum(dim=(0, 1)), hbar
