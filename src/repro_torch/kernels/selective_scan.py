"""Python wrappers of the CUDA selective-scan kernels
``csrc/selective_scan.cu`` (forward) and ``csrc/selective_scan_bwd.cu``
(backward).

:func:`selective_scan` is the Hopper counterpart of
:func:`repro.kernels.selective_scan._forward`: the Mamba1 scan forward,
``h_t = exp(dt_t·A) ⊙ h_{t-1} + (dt_t·x_t) B_t``,
``y_t = ⟨h_t, C_t⟩ + D·x_t``, returning ``y``, the final state and the
state at the start of every time chunk (``hseg``). A lane carries four of
a channel's ``n`` states in registers (``n / 4`` lanes a channel, 256
threads a CTA, two CTAs an SM); x, dt, B and C reach shared memory through
a double-buffered ``cp.async`` ring of :data:`SCAN_STAGE_STEPS` steps. Each
lane sums ``h·C`` over its own four states in state order, and the CTA
adds a channel's lane partials in lane order, then ``D·x``: a fixed order,
so ``y`` is the same on every run. ``hseg`` and ``hout`` are the plain
version's bits. :func:`plan` mirrors the source's launch constants.

:func:`selective_scan_bwd` is the counterpart of
:func:`repro.kernels.selective_scan._backward`: the reverse-chunk adjoint,
recomputing each chunk's states from ``hseg`` (two states a lane, the
history by sub-chunk in shared memory and registers) and returning the
seven gradients. Its sums over channels, batch rows and chunks run in
fixed orders with no float atomics, so it too gives the same bits every
run.

Both wrappers only launch: they take CUDA tensors and raise on anything
else. :func:`repro_torch.kernels.ops.selective_scan` and
:func:`~repro_torch.kernels.ops.selective_scan_bwd` choose between them
and the plain versions by the tensors' device. ``.launches`` on each
counts its launches.

:func:`make_trainable_scan` is the port of the reference's custom-VJP
scan as a ``torch.autograd.Function``: its forward runs the scan and saves
``hseg``, its backward runs :func:`~repro_torch.kernels.ops.
selective_scan_bwd` (the kernel on the card, the plain version on the
CPU).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

DIN_TILE = 128
TIME_CHUNK = 512
STATE_SIZES = (8, 16)   # the kernels' instantiations of n
BWD_CHANNELS_PER_BLOCK = 128  # channels a cluster sums dB / dC over
BWD_MAX_TIME_CHUNK = 512      # kSub * kMaxCheckpoints in the source
# the forward's launch constants (kStates, kThreads, kMinCtas, kSeg in
# csrc/selective_scan.cu) and the H100 limits its plan is checked against
SCAN_STATES_PER_LANE = 4
SCAN_THREADS = 256
SCAN_CTAS_PER_SM = 2
SCAN_STAGE_STEPS = 32
H100_SMS = 132
SMEM_PER_SM = 233_472       # 228 KB of shared memory an SM
SMEM_PER_CTA = 232_448      # 227 KB a CTA can take
SMEM_RESERVED_PER_CTA = 1024


class ScanPlan(NamedTuple):
    lanes_per_channel: int
    channels_per_cta: int
    threads: int
    ctas: int
    smem_bytes: int
    ctas_per_sm: int
    waves: int          # rounds of resident CTAs on H100_SMS SMs
    fill: float         # share of the waves' CTA slots the grid fills
    segments: int       # staged segments a CTA walks


def plan(B: int, L: int, din: int, n: int, tc: int) -> ScanPlan:
    """The forward kernel's launch for ``(B, L, din, n, tc)``, as the
    source computes it: a grid of ``ceil(din / channels_per_cta)`` by
    ``B`` CTAs, each with two stages of x, dt (``(steps, channels)``) and
    B, C (``(steps, n)``) and the ``(steps, threads)`` y partials in
    shared memory; ``ctas_per_sm`` is the launch bounds' two unless shared
    memory allows fewer."""
    lanes = n // SCAN_STATES_PER_LANE
    ch = SCAN_THREADS // lanes
    stage = SCAN_STAGE_STEPS * (2 * ch + 2 * n)
    smem = 4 * (2 * stage + SCAN_STAGE_STEPS * SCAN_THREADS)
    per_sm = min(SCAN_CTAS_PER_SM,
                 SMEM_PER_SM // (smem + SMEM_RESERVED_PER_CTA))
    ctas = -(-din // ch) * B
    slots = H100_SMS * per_sm
    waves = -(-ctas // slots)
    fill = ctas / (waves * slots)
    tcl = min(tc, L)
    segments = L // tcl * -(-tcl // SCAN_STAGE_STEPS)
    return ScanPlan(lanes, ch, SCAN_THREADS, ctas, smem, per_sm, waves,
                    fill, segments)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"selective_scan: {msg}")


def traffic(B: int, L: int, din: int, n: int, tc: int):
    """``(read, written)`` bytes of the forward: ``x``, ``dt`` ``(B, L,
    din)``, ``b``, ``c`` ``(B, L, n)``, ``a`` ``(din, n)``, ``d``, ``h0``
    read; ``y``, ``hout`` and ``hseg`` written; all float32."""
    read = 4 * (2 * B * L * din + 2 * B * L * n + din * n + din
                + B * din * n)
    return read, 4 * (B * L * din + B * din * n + B * (L // tc) * din * n)


def bwd_traffic(B: int, L: int, din: int, n: int, tc: int):
    """``(read, written)`` bytes of the backward: the forward's inputs
    but ``h0``, ``hseg``, ``ybar`` and ``houtbar`` read; ``dx``, ``ddt``,
    ``dB``, ``dC``, ``dA``, ``dD`` and ``dh0`` written (its scratch
    partials not counted); all float32."""
    read = 4 * (3 * B * L * din + 2 * B * L * n + din * n + din
                + B * (L // tc) * din * n + B * din * n)
    return read, 4 * (2 * B * L * din + 2 * B * L * n + din * n + din
                      + B * din * n)


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
    _build.report("selective_scan", *traffic(B, L, din, n, tc))
    return y, hout, hseg


selective_scan.launches = 0


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                       hseg: torch.Tensor, ybar: torch.Tensor,
                       houtbar: torch.Tensor, time_chunk: int = TIME_CHUNK
                       ) -> Tuple[torch.Tensor, ...]:
    """Launch the backward.

    Args:
      x, dt, b, c, a, d: the forward's inputs (shapes and dtype as
        :func:`selective_scan`), on a CUDA device.
      hseg: ``(B, L / tc, din, n)`` the forward's chunk-start states.
      ybar: ``(B, L, din)`` cotangent of ``y``.
      houtbar: ``(B, din, n)`` cotangent of the final state.
      time_chunk: the forward's chunk length ``tc`` (clamped to ``L``).

    Returns ``(dx, ddt (B, L, din), dB, dC (B, L, n), dA (din, n),
    dD (din,), dh0 (B, din, n))`` float32.
    """
    dev = x.device
    _require(dev.type == "cuda", f"needs CUDA tensors, got {dev}")
    _require(x.dim() == 3, f"x must be (B, L, din), got {tuple(x.shape)}")
    B, L, din = x.shape
    _require(b.dim() == 3, f"b must be (B, L, n), got {tuple(b.shape)}")
    n = b.shape[-1]
    _require(n in STATE_SIZES, f"state size n={n} is not one of the "
             f"kernel's instantiations {STATE_SIZES}")
    _require(B >= 1 and L >= 1 and din >= 1, f"empty input {(B, L, din)}")
    _require(B <= 65535, f"batch {B} exceeds the grid's 65535 rows")
    tc = min(time_chunk, L)
    _require(tc >= 1 and L % tc == 0, f"L={L} is not a multiple of the "
             f"time chunk {tc}")
    n_chunks = L // tc
    for name, t, shape in (("x", x, (B, L, din)), ("dt", dt, (B, L, din)),
                           ("b", b, (B, L, n)), ("c", c, (B, L, n)),
                           ("a", a, (din, n)), ("d", d, (din,)),
                           ("hseg", hseg, (B, n_chunks, din, n)),
                           ("ybar", ybar, (B, L, din)),
                           ("houtbar", houtbar, (B, din, n))):
        _require(t.device == dev, f"{name} is on {t.device}, not {dev}")
        _require(t.dtype == torch.float32, f"{name} must be float32, got "
                 f"{t.dtype}")
        _require(tuple(t.shape) == shape, f"{name} must be {shape}, got "
                 f"{tuple(t.shape)}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(tc <= BWD_MAX_TIME_CHUNK, f"time chunk {tc} exceeds the "
             f"backward's {BWD_MAX_TIME_CHUNK} (its checkpoints live in "
             "shared memory)")
    nblk = -(-din // BWD_CHANNELS_PER_BLOCK)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    # scratch: the clusters' dB / dC partials and the per-(batch row,
    # chunk) dA / dD partials; the recomputed states never leave the SM
    bc_part = empty(B, L, nblk, 2 * n)
    da_part = empty(B, n_chunks, din, n)
    dd_part = empty(B, n_chunks, din)
    outs = (empty(B, L, din), empty(B, L, din), empty(B, L, n),
            empty(B, L, n), empty(din, n), empty(din), empty(B, din, n))
    rc = _build.library().repro_selective_scan_bwd(
        *(t.data_ptr() for t in (x, dt, b, c, a, d, hseg, ybar, houtbar)),
        B, L, din, n, tc, nblk,
        *(t.data_ptr() for t in (bc_part, da_part, dd_part)),
        *(t.data_ptr() for t in outs), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "selective_scan_bwd launch")
    selective_scan_bwd.launches += 1
    _build.report("selective_scan_bwd", *bwd_traffic(B, L, din, n, tc))
    return outs


selective_scan_bwd.launches = 0


class _TrainableScan(torch.autograd.Function):
    """The scan with its chunk-start states saved for the backward pass,
    whose gradients come from :func:`repro_torch.kernels.ops.
    selective_scan_bwd`."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, d, h0, din_tile, time_chunk):
        # ops dispatches by device and imports this module: import it here
        from repro_torch.kernels import ops

        y, hout, hseg = ops.selective_scan(x, dt, b, c, a, d, h0,
                                           din_tile=din_tile,
                                           time_chunk=time_chunk)
        ctx.save_for_backward(x, dt, b, c, a, d, hseg)
        ctx.time_chunk = time_chunk
        return y, hout

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ybar, houtbar):
        from repro_torch.kernels import ops

        x, dt, b, c, a, d, hseg = ctx.saved_tensors
        grads = ops.selective_scan_bwd(x, dt, b, c, a, d, hseg, ybar,
                                       houtbar, time_chunk=ctx.time_chunk)
        return (*grads, None, None)


def make_trainable_scan(din_tile: int = DIN_TILE,
                        time_chunk: int = TIME_CHUNK) -> Callable:
    """The port of :func:`repro.kernels.selective_scan.make_trainable_scan`:
    ``scan(x, dt, b, c, a, d, h0) -> (y, hout)`` through
    :func:`repro_torch.kernels.ops.selective_scan`, differentiable in all
    seven inputs. The forward saves ``hseg``; the backward recomputes each
    chunk from it (:func:`repro_torch.kernels.ops.selective_scan_bwd`: the
    CUDA kernel on the card, the plain version on the CPU) and returns
    float32 gradients, which autograd casts to each input's dtype."""

    def scan(x, dt, b, c, a, d, h0):
        return _TrainableScan.apply(x, dt, b, c, a, d, h0, din_tile,
                                    time_chunk)

    return scan
