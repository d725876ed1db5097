"""Python wrappers of the CUDA activity-probe kernels
``csrc/bitmap_active.cu``.

:func:`active_blocks` is the Hopper counterpart of
:func:`repro.kernels.bitmap_active.active_blocks`: ``flag[i] =
any_w(words[row_i, w] & active[w]) != 0`` over packed block-by-group
bitmaps, where ``row_i`` is ``win[i]`` (rows read in place) or ``i``
(every row: the static prefilter, the per-block path). Words are uint32
bit patterns carried in int32 tensors.

:func:`active_blocks_multi` is shared-scan serving's form of the probe:
a ``(Q, W)`` stack of masks, one a query, against the same rows in one
launch (``out[q, i]``), each row's words read once for all Q masks.

:func:`round_select` is the fused scan round's head: the same probe over
the cursor window, with the static prefilter, the budgeted selection and
the fold's lane table, in one launch (the source's header says how). It
reads the cursor and its ``go`` flag from device scalars, so a CUDA
graph of many rounds replays each round from the cursor the last one
left. For a slot of a shared pass it takes a stack of masks (their
union), the slot's lap end and a wrapped window.

These wrappers only launch: they take CUDA tensors and raise on anything
else. :mod:`repro_torch.kernels.ops` chooses between them and the plain
versions by the tensors' device. ``active_blocks.launches``,
``active_blocks_multi.launches`` and ``round_select.launches`` count the
launches.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"active_blocks: {msg}")


def probe_traffic(words: torch.Tensor, masks: torch.Tensor,
                  win: Optional[torch.Tensor] = None):
    """``(read, written)`` bytes of one probe of the rows of ``words``
    (those of ``win`` when given) against ``masks``, a ``(W,)`` mask or a
    ``(Q, W)`` stack: the rows' words, the masks and the row ids read,
    ``Q`` int32 flags a row written."""
    n = words.shape[0] if win is None else win.shape[0]
    q = masks.shape[0] if masks.dim() == 2 else 1
    return (n * words.shape[1] * 4 + masks.numel() * 4
            + (0 if win is None else n * 4), q * n * 4)


def head_traffic(words: torch.Tensor, active_words: torch.Tensor, *,
                 window: int, budget: int, probe: bool):
    """``(read, written)`` bytes of one round head: the window's
    ``order_pad`` entries and ``static_ok`` bytes (with ``probe`` also
    their rows' words and the masks) read; ``ok`` and ``flags`` (a byte
    a position), the lanes' int32 ``blk`` and bool ``tvalid`` and the
    int64 ``new_pos`` written."""
    read = window * (4 + 1)
    if probe:
        read += window * words.shape[1] * 4 + active_words.numel() * 4
    return read, 2 * window + budget * 5 + 8


def active_blocks(words: torch.Tensor, active_words: torch.Tensor,
                  win: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Probe rows of ``words`` (``(nb, W)`` int32 on a CUDA device)
    against ``active_words`` (``(W,)`` int32). ``win`` (``(n,)`` int32
    row ids, or None for all ``nb`` rows) picks the rows. Returns int32
    ``(n,)`` flags."""
    dev = words.device
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    _require(words.dim() == 2, f"words must be (nb, W), got "
             f"{tuple(words.shape)}")
    n_words = words.shape[1]
    _require(active_words.shape == (n_words,),
             f"active_words must be ({n_words},), got "
             f"{tuple(active_words.shape)}")
    for name, t in (("words", words), ("active_words", active_words)):
        _require(t.device == dev, f"{name} is on {t.device}, not {dev}")
        _require(t.dtype == torch.int32, f"{name} must be int32 (uint32 "
                 f"bits), got {t.dtype}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    win_ptr = None
    n = words.shape[0]
    if win is not None:
        _require(win.dim() == 1 and win.device == dev
                 and win.dtype == torch.int32 and win.is_contiguous(),
                 "win must be a contiguous 1-D int32 tensor on the words' "
                 "device")
        win_ptr = win.data_ptr()
        n = win.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    rc = _build.library().repro_bitmap_active(
        words.data_ptr(), win_ptr, n, n_words, active_words.data_ptr(),
        out.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "bitmap_active launch")
    active_blocks.launches += 1
    _build.report("active_blocks", *probe_traffic(words, active_words, win))
    return out


active_blocks.launches = 0


def active_blocks_multi(words: torch.Tensor, stack: torch.Tensor,
                        win: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Probe rows of ``words`` (``(nb, W)`` int32 on a CUDA device)
    against each row of ``stack`` (``(Q, W)`` int32), in one launch.
    ``win`` (``(n,)`` int32 row ids, or None for all ``nb`` rows) picks
    the rows. Returns int32 ``(Q, n)`` flags, row ``q`` bit for bit
    :func:`active_blocks` against ``stack[q]``."""
    dev = words.device
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    _require(words.dim() == 2 and stack.dim() == 2
             and stack.shape[1] == words.shape[1],
             f"words must be (nb, W) and stack (Q, W), got "
             f"{tuple(words.shape)} and {tuple(stack.shape)}")
    n_words, q = words.shape[1], stack.shape[0]
    _require(q * n_words * 4 <= 227 * 1024,
             f"the ({q}, {n_words}) stack must fit one CTA's shared memory "
             "(227 KB)")
    for name, t in (("words", words), ("stack", stack)):
        _require(t.device == dev, f"{name} is on {t.device}, not {dev}")
        _require(t.dtype == torch.int32, f"{name} must be int32 (uint32 "
                 f"bits), got {t.dtype}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    win_ptr = None
    n = words.shape[0]
    if win is not None:
        _require(win.dim() == 1 and win.device == dev
                 and win.dtype == torch.int32 and win.is_contiguous(),
                 "win must be a contiguous 1-D int32 tensor on the words' "
                 "device")
        win_ptr = win.data_ptr()
        n = win.shape[0]
    out = torch.empty((q, n), dtype=torch.int32, device=dev)
    rc = _build.library().repro_bitmap_active_multi(
        words.data_ptr(), win_ptr, n, n_words, stack.data_ptr(), q,
        out.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "bitmap_active_multi launch")
    active_blocks_multi.launches += 1
    _build.report("active_blocks_multi", *probe_traffic(words, stack, win))
    return out


active_blocks_multi.launches = 0


# The round head's look-back words per (device, stream): an int64 buffer
# (the epoch, then a word a CTA), zeroed once. The kernel keeps the epoch
# in the buffer and tags each call's words with a new one, so the buffer
# is never reset and no host value changes between calls (a captured
# CUDA graph replays right). A larger buffer replaces a too small one, so
# a caller that captures the head runs it once on the capture stream
# first (the buffer is then made outside the capture).
_lookback: Dict[Tuple[int, int], torch.Tensor] = {}


def _lookback_words(dev: torch.device, stream: int,
                    ctas: int) -> torch.Tensor:
    """The look-back buffer for a call on ``stream`` with ``ctas`` CTAs."""
    buf = _lookback.get((dev.index, stream))
    if buf is None or buf.numel() < 1 + ctas:
        buf = torch.zeros(max(1 + ctas, 129), dtype=torch.int64, device=dev)
        _lookback[(dev.index, stream)] = buf
    return buf


def round_select(order_pad: torch.Tensor, static_ok: torch.Tensor,
                 words: torch.Tensor, active_words: torch.Tensor,
                 pos: torch.Tensor, go: torch.Tensor, *, nb: int,
                 window: int, budget: int, probe: bool,
                 lap_end: Optional[int] = None, wrap: bool = False):
    """The fused round's head in one launch, as
    :func:`repro_torch.kernels.ops.round_select` describes it.

    Args: ``order_pad`` int32 with at least ``nb + window`` entries (the
    scan order, padded; wrap-filled for ``wrap``); ``static_ok`` ``(nb,)``
    bool; ``words`` ``(nb, W)`` and ``active_words`` ``(W,)`` or a ``(Q,
    W)`` stack, int32 (read only with ``probe``); ``pos`` an int64 and
    ``go`` a bool device scalar (the head checks ``lap_end - nb <= pos <=
    lap_end`` on the card); ``lap_end`` the cursor limit (``nb`` when
    None). Returns ``(ok, flags, new_pos, blk, tvalid)``, views of one
    allocation, equal bit for bit to
    :func:`repro_torch.kernels.ref.round_select_ref`."""
    dev = order_pad.device
    lap_end = nb if lap_end is None else lap_end
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    _require(window >= 1 and budget >= 1, f"window and budget must be >= 1, "
             f"got {window}, {budget}")
    _require(nb >= 1 and lap_end >= nb, f"nb must be >= 1 and lap_end >= "
             f"nb, got {nb}, {lap_end}")
    _require(pos.shape == () and pos.dtype == torch.int64
             and go.shape == () and go.dtype == torch.bool,
             "pos must be an int64 and go a bool device scalar")
    _require(order_pad.dim() == 1 and order_pad.dtype == torch.int32
             and order_pad.is_contiguous()
             and order_pad.shape[0] >= nb + window,
             "order_pad must be contiguous 1-D int32 with nb + window "
             "entries")
    _require(static_ok.dim() == 1 and static_ok.dtype == torch.bool
             and static_ok.is_contiguous() and static_ok.shape[0] >= nb,
             "static_ok must be contiguous 1-D bool with nb entries")
    tensors = [order_pad, static_ok, pos, go]
    words_ptr, active_ptr, n_words, n_active = None, None, 0, 0
    if probe:
        n_words = words.shape[1] if words.dim() == 2 else -1
        n_active = (active_words.shape[0] if active_words.dim() == 2
                    else 1)
        _require(n_words > 0 and words.shape[0] >= nb
                 and active_words.shape[-1] == n_words
                 and active_words.dim() in (1, 2) and n_active >= 1,
                 "words must be (nb, W) and active_words (W,) or (Q, W)")
        _require(n_active == 1 or n_words * 4 <= 48 * 1024,
                 f"a stack's OR of {n_words} words must fit 48 KB of "
                 "shared memory")
        for name, t in (("words", words), ("active_words", active_words)):
            _require(t.dtype == torch.int32 and t.is_contiguous(),
                     f"{name} must be contiguous int32 (uint32 bits)")
        tensors += [words, active_words]
        words_ptr, active_ptr = words.data_ptr(), active_words.data_ptr()
    _require(all(t.device == dev for t in tensors),
             "inputs must be on one device")
    # one allocation: new_pos (int64) | blk (int32) | ok | flags | tvalid
    o_blk = 8
    o_ok = o_blk + 4 * budget
    o_flags = o_ok + window
    o_tvalid = o_flags + window
    buf = torch.empty(o_tvalid + budget, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = _lookback_words(dev, stream, -(-window // 32))
    rc = _build.library().repro_round_select(
        order_pad.data_ptr(), static_ok.data_ptr(), words_ptr, n_words,
        active_ptr, n_active, pos.data_ptr(), go.data_ptr(), nb, lap_end,
        1 if wrap else 0, window, budget,
        buf.data_ptr() + o_ok,
        buf.data_ptr() + o_flags, buf.data_ptr(), buf.data_ptr() + o_blk,
        buf.data_ptr() + o_tvalid, status.data_ptr(), dev.index, stream)
    _build.check(rc, "round_select launch")
    round_select.launches += 1
    _build.report("round_select", *head_traffic(
        words, active_words, window=window, budget=budget, probe=probe))
    return (buf[o_ok:o_ok + window].view(torch.bool),
            buf[o_flags:o_flags + window].view(torch.bool),
            buf[:8].view(torch.int64).reshape(()),
            buf[o_blk:o_blk + 4 * budget].view(torch.int32),
            buf[o_tvalid:o_tvalid + budget].view(torch.bool))


round_select.launches = 0
