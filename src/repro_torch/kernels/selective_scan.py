"""Python wrapper of the CUDA selective-scan kernel
``csrc/selective_scan.cu``.

The Hopper counterpart of :func:`repro.kernels.selective_scan._forward`:
the Mamba1 scan forward, ``h_t = exp(dt_t·A) ⊙ h_{t-1} + (dt_t·x_t) B_t``,
``y_t = ⟨h_t, C_t⟩ + D·x_t``, returning ``y``, the final state and the
state at the start of every time chunk (``hseg``, the layout the backward
kernel will read). One thread carries one (batch, channel) state in
registers; the sum over the ``n`` states runs in a fixed order, so the
result is the same on every run.

:func:`selective_scan` only launches: it takes CUDA tensors and raises on
anything else. :func:`repro_torch.kernels.ops.selective_scan` chooses
between it and the plain version by the tensors' device.
``selective_scan.launches`` counts the launches.

:func:`make_trainable_scan` is the port of the reference's custom-VJP
scan as a ``torch.autograd.Function``. Its forward runs the scan and saves
``hseg``; its backward (kernel #6, the reverse-chunk adjoint) is not
ported yet and raises.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.kernels import _build

DIN_TILE = 128
TIME_CHUNK = 512
STATE_SIZES = (8, 16)   # the kernel's instantiations of n


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"selective_scan: {msg}")


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                   h0: torch.Tensor, time_chunk: int = TIME_CHUNK
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the scan.

    Args:
      x, dt: ``(B, L, din)`` float32 on a CUDA device — post-conv
        activations and post-softplus dt.
      b, c: ``(B, L, n)`` float32, ``n`` in :data:`STATE_SIZES`.
      a: ``(din, n)`` float32 (negative decay rates, ``-exp(A_log)``).
      d: ``(din,)`` float32 skip term.
      h0: ``(B, din, n)`` float32 carry-in state.
      time_chunk: chunk length ``tc`` (clamped to ``L``; must divide it).

    Returns ``(y (B, L, din), hout (B, din, n), hseg (B, L / tc, din, n))``
    float32.
    """
    dev = x.device
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    _require(x.dim() == 3, f"x must be (B, L, din), got {tuple(x.shape)}")
    B, L, din = x.shape
    _require(b.dim() == 3, f"b must be (B, L, n), got {tuple(b.shape)}")
    n = b.shape[-1]
    _require(n in STATE_SIZES, f"state size n={n} is not one of the "
             f"kernel's instantiations {STATE_SIZES}")
    for name, t, shape in (("x", x, (B, L, din)), ("dt", dt, (B, L, din)),
                           ("b", b, (B, L, n)), ("c", c, (B, L, n)),
                           ("a", a, (din, n)), ("d", d, (din,)),
                           ("h0", h0, (B, din, n))):
        _require(t.device == dev, f"{name} is on {t.device}, not {dev}")
        _require(t.dtype == torch.float32, f"{name} must be float32, got "
                 f"{t.dtype}")
        _require(tuple(t.shape) == shape, f"{name} must be {shape}, got "
                 f"{tuple(t.shape)}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(B >= 1 and L >= 1 and din >= 1, f"empty input {(B, L, din)}")
    _require(B <= 65535, f"batch {B} exceeds the grid's 65535 rows")
    tc = min(time_chunk, L)
    _require(tc >= 1 and L % tc == 0, f"L={L} is not a multiple of the "
             f"time chunk {tc}")
    y = torch.empty((B, L, din), dtype=torch.float32, device=dev)
    hout = torch.empty((B, din, n), dtype=torch.float32, device=dev)
    hseg = torch.empty((B, L // tc, din, n), dtype=torch.float32, device=dev)
    rc = _build.library().repro_selective_scan(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a.data_ptr(), d.data_ptr(), h0.data_ptr(), B, L, din, n, tc,
        y.data_ptr(), hout.data_ptr(), hseg.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "selective_scan launch")
    selective_scan.launches += 1
    return y, hout, hseg


selective_scan.launches = 0


class _TrainableScan(torch.autograd.Function):
    """The scan with its chunk-start states saved for the backward pass."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, d, h0, din_tile, time_chunk):
        # ops dispatches by device and imports this module: import it here
        from repro_torch.kernels import ops

        y, hout, hseg = ops.selective_scan(x, dt, b, c, a, d, h0,
                                           din_tile=din_tile,
                                           time_chunk=time_chunk)
        ctx.save_for_backward(x, dt, b, c, a, d, hseg)
        return y, hout

    @staticmethod
    def backward(ctx, ybar, houtbar):
        raise NotImplementedError(
            "the selective-scan backward (kernel #6, "
            "repro.kernels.selective_scan._backward) is not ported yet: it "
            "comes with the training slice, ROADMAP queue 1 item 8")


def make_trainable_scan(din_tile: int = DIN_TILE,
                        time_chunk: int = TIME_CHUNK) -> Callable:
    """The port of :func:`repro.kernels.selective_scan.make_trainable_scan`:
    ``scan(x, dt, b, c, a, d, h0) -> (y, hout)`` through
    :func:`repro_torch.kernels.ops.selective_scan` (the CUDA kernel on the
    card, the plain version on the CPU). The forward saves ``hseg`` for
    the backward, which raises ``NotImplementedError`` until the training
    slice ports it; serving runs it under ``torch.inference_mode()``."""

    def scan(x, dt, b, c, a, d, h0):
        return _TrainableScan.apply(x, dt, b, c, a, d, h0, din_tile,
                                    time_chunk)

    return scan
