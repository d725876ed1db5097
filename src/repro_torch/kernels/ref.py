"""Plain PyTorch versions of the port's kernels (the ``ref.py`` layer).

Each computes what its kernel computes, on any device, with the same
outputs as the JAX package's oracles in :mod:`repro.kernels.ref`. The
CPU tests run them, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card. Nothing on the engine's path calls them for
tensors that live on the card: :mod:`repro_torch.kernels.ops` launches
the kernel there.
"""

from __future__ import annotations

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
    dv = v - float(center)   # the scalar rounds to float32, as in JAX
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
