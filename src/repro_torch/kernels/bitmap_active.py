"""Python wrapper of the CUDA activity-probe kernel
``csrc/bitmap_active.cu``.

The Hopper counterpart of :func:`repro.kernels.bitmap_active.
active_blocks`: ``flag[i] = any_w(words[row_i, w] & active[w]) != 0``
over packed block-by-group bitmaps, where ``row_i`` is ``win[i]`` (the
fused round's cursor window, read in place) or ``i`` (every block, for
the static prefilter). Words are uint32 bit patterns carried in int32
tensors.

This wrapper only launches: it takes CUDA tensors and raises on anything
else. :func:`repro_torch.kernels.ops.active_blocks` chooses between it
and the plain version by the tensors' device.
``active_blocks.launches`` counts the launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"active_blocks: {msg}")


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
    return out


active_blocks.launches = 0
