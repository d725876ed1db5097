"""The port's selective scan on the CPU against the JAX package.

``selective_scan_ref`` (the plain version the CUDA kernel is held to on
the card) against the reference's Pallas kernel in interpret mode and
against the reference recurrence of ``tests/test_kernels.py``, at that
file's shapes; ``ops.selective_scan`` dispatch and shape contract; the
autograd wrapper's forward. The backward: ``selective_scan_bwd_ref`` and
the autograd wrapper's gradients against the VJP of the reference's
``make_trainable_scan`` (its Pallas backward in interpret mode) and
against ``jax.grad`` of the reference recurrence.

Tolerances:
  * forward, 1e-5 absolute and relative. Both sides run the same
    sequential float32 recurrence; only the order of the sum over the
    ``n`` states and the ``exp`` implementation differ, so the
    differences are a few float32 ulps (measured ~1e-6 here);
  * backward against the Pallas VJP, ``max |port - ref| <= 1e-5 *
    max |ref|`` per gradient: the same float32 operations, with the sums
    over ``n``, over channels and over chunks taken in other orders
    (measured <= 3.1e-7);
  * against autodiff of the recurrence, ``tests/test_kernels.py``'s own
    2e-3 (autodiff differentiates another sequence of operations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import selective_scan as jscan
from repro_torch.kernels import ops, ref
from repro_torch.kernels.selective_scan import make_trainable_scan
from tests.helpers.torch_parity import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = 1e-5
GRADS = ("dx", "ddt", "db", "dc", "da", "dd", "dh0")

# (B, L, din, n, tc): tests/test_kernels.py's scan shapes, a ragged-free
# multi-chunk case and the falcon-mamba state size at a small width
SHAPES = [(2, 64, 256, 16, 32), (2, 128, 128, 8, 128), (1, 96, 128, 16, 32),
          (3, 40, 128, 8, 8)]


def _inputs(seed, B, L, din, n):
    """x ~ N(0, 1), dt = softplus(N(-4.6, 0.5)), B, C ~ N(0, 1),
    A = -(1..n), D ~ N(1, 0.1), h0 ~ N(0, 0.1) — the smoke script's
    inputs, in float32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, L, din))
    dt = np.log1p(np.exp(rng.normal(-4.6, 0.5, (B, L, din))))
    b = rng.normal(0, 1, (B, L, n))
    c = rng.normal(0, 1, (B, L, n))
    a = -np.tile(np.arange(1, n + 1, dtype=np.float64), (din, 1))
    d = rng.normal(1, 0.1, din)
    h0 = rng.normal(0, 0.1, (B, din, n))
    return [np.asarray(t, np.float32) for t in (x, dt, b, c, a, d, h0)]


def _jax_recurrence(x, dt, b, c, a, d, h0):
    """The reference recurrence of tests/test_kernels.py (lax.scan)."""
    def step(h, inp):
        x_t, dt_t, b_t, c_t = inp
        decay = jnp.exp(dt_t[:, :, None] * a)
        u = (dt_t * x_t)[:, :, None] * b_t[:, None, :]
        h = decay * h + u
        y = jnp.sum(h * c_t[:, None, :], -1) + d * x_t
        return h, y
    xs = tuple(jnp.swapaxes(t, 0, 1) for t in (x, dt, b, c))
    h, ys = jax.lax.scan(step, h0, xs)
    return jnp.swapaxes(ys, 0, 1), h


@pytest.mark.parametrize("B,L,din,n,tc", SHAPES)
def test_ref_matches_pallas_forward(B, L, din, n, tc):
    """y, hout and every chunk-start state against ``_forward``'s three
    outputs (interpret mode, the Pallas body's own arithmetic)."""
    args = _inputs(L + n, B, L, din, n)
    want = jscan._forward(*(jnp.asarray(t) for t in args),
                          din_tile=min(128, din), time_chunk=tc,
                          interpret=True)
    got = ref.selective_scan_ref(*(torch.from_numpy(t) for t in args),
                                 time_chunk=tc)
    assert got[2].shape == (B, L // tc, din, n)
    for name, g, w in zip(("y", "hout", "hseg"), got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g, w, err_msg=_worst(name, g, w), **TOL)


def _worst(name, got, want):
    """What a failure of this comparison should name: the element that
    most exceeds the tolerance, its index, both values, the tolerance
    there, how many elements exceed it, non-finite counts, and torch's
    thread count (a numerical cause names values; a killed worker never
    reaches this line)."""
    err = np.abs(got.astype(np.float64) - want)
    allowed = TOL["atol"] + TOL["rtol"] * np.abs(want.astype(np.float64))
    excess = np.nan_to_num(err - allowed, nan=np.inf)
    i = np.unravel_index(int(np.argmax(excess)), excess.shape)
    return (f"{name}: worst index {tuple(int(k) for k in i)}, got "
            f"{got[i]!r}, want {want[i]!r}, |diff| {err[i]!r} against "
            f"tolerance {allowed[i]!r} (rtol {TOL['rtol']}, atol "
            f"{TOL['atol']}); {int((excess > 0).sum())} of {excess.size} "
            f"over; non-finite got {int((~np.isfinite(got)).sum())}, want "
            f"{int((~np.isfinite(want)).sum())}; torch threads "
            f"{torch.get_num_threads()}")


@pytest.mark.parametrize("B,L,din,n,tc", SHAPES[:2])
def test_ref_matches_reference_recurrence(B, L, din, n, tc):
    args = _inputs(7 * L + n, B, L, din, n)
    y_want, h_want = _jax_recurrence(*(jnp.asarray(t) for t in args))
    y, h, hseg = ref.selective_scan_ref(*(torch.from_numpy(t) for t in args),
                                        time_chunk=tc)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), **TOL)
    # chunk 0 starts from h0, chunk k from the state after k * tc steps
    np.testing.assert_array_equal(hseg[:, 0].numpy(), args[6])
    if L // tc > 1:
        _, h_mid = _jax_recurrence(*(jnp.asarray(t[:, :tc]) for t in
                                     args[:4]), *map(jnp.asarray, args[4:]))
        np.testing.assert_allclose(hseg[:, 1].numpy(), np.asarray(h_mid),
                                   **TOL)


def test_public_selective_scan_matches_ops():
    """ops.selective_scan on CPU tensors is the plain version; its first
    two outputs are the reference's public ``selective_scan``."""
    B, L, din, n = 2, 64, 256, 16
    args = _inputs(3, B, L, din, n)
    y_want, h_want = jscan.selective_scan(*(jnp.asarray(t) for t in args),
                                          time_chunk=32, interpret=True)
    y, h, hseg = ops.selective_scan(*(torch.from_numpy(t) for t in args),
                                    time_chunk=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), **TOL)
    same = ref.selective_scan_ref(*(torch.from_numpy(t) for t in args),
                                  time_chunk=32)
    for g, w in zip((y, h, hseg), same):
        assert torch.equal(g, w)


@pytest.mark.parametrize("L,din,din_tile,tc", [(96, 128, 128, 64),
                                               (64, 192, 128, 512)])
def test_ops_keeps_the_reference_shape_contract(L, din, din_tile, tc):
    """L must be a multiple of min(tc, L) and din of the din tile, as the
    reference's grid requires, on every device."""
    args = _inputs(0, 1, L, din, 8)
    with pytest.raises(ValueError, match="multiples"):
        ops.selective_scan(*(torch.from_numpy(t) for t in args),
                           din_tile=din_tile, time_chunk=tc)


def test_trainable_scan_forward_matches_reference():
    """The autograd wrapper's forward is the reference's custom-VJP
    forward (``make_trainable_scan``) on the same inputs."""
    B, L, din, n = 2, 64, 128, 8
    args = _inputs(11, B, L, din, n)
    want = jscan.make_trainable_scan(din_tile=128, time_chunk=16,
                                     interpret=True)(
        *(jnp.asarray(t) for t in args))
    got = make_trainable_scan(din_tile=128, time_chunk=16)(
        *(torch.from_numpy(t) for t in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_inputs_are_cast_to_float32():
    args = _inputs(5, 1, 32, 128, 8)
    f64 = [torch.from_numpy(t.astype(np.float64)) for t in args]
    y, h, _ = ops.selective_scan(*f64)
    assert y.dtype == h.dtype == torch.float32
    want = ops.selective_scan(*(torch.from_numpy(t) for t in args))
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])


# -- the backward -------------------------------------------------------------

# (B, L, din, n, tc): tests/test_kernels.py's custom-VJP shape (4 chunks),
# two din tiles over 3 chunks at n 16, and 5 chunks of 8 steps at B 3
BWD_SHAPES = [(2, 64, 128, 8, 16), (1, 96, 256, 16, 32), (3, 40, 128, 8, 8)]


def _vjp_inputs(seed, B, L, din, n):
    """test_selective_scan_custom_vjp's inputs: dt = |N(0.05, 0.02)| and
    A = -exp(N(0, 0.5)), so every decay rate differs."""
    rng = np.random.default_rng(seed)
    args = [rng.normal(0, 1, (B, L, din)),
            np.abs(rng.normal(0.05, 0.02, (B, L, din))),
            rng.normal(0, 1, (B, L, n)), rng.normal(0, 1, (B, L, n)),
            -np.exp(rng.normal(0, 0.5, (din, n))),
            rng.normal(1, 0.1, din), rng.normal(0, 0.1, (B, din, n))]
    return [np.asarray(a, np.float32) for a in args]


def _loss(y, h):
    """test_selective_scan_custom_vjp's loss."""
    return (y ** 2).sum() * 0.5 + (h * h).sum()


def _port_grads(args, tc):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h = make_trainable_scan(din_tile=128, time_chunk=tc)(*ts)
    _loss(y, h).backward()
    return [t.grad for t in ts]


def _assert_grads_close(got, want, tol):
    for name, g, w in zip(GRADS, got, want):
        w = np.asarray(w)
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape and g.dtype == np.float32, name
        err = float(np.abs(g - w).max())
        assert err <= tol * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("B,L,din,n,tc", BWD_SHAPES)
def test_bwd_matches_pallas_vjp(B, L, din, n, tc):
    """The plain backward, fed the reference forward's own residuals and
    cotangents, and the autograd wrapper's gradients, against the VJP of
    the reference's ``make_trainable_scan`` (interpret mode)."""
    args = _vjp_inputs(B * L + n, B, L, din, n)
    scan = jscan.make_trainable_scan(din_tile=128, time_chunk=tc,
                                     interpret=True)
    jargs = [jnp.asarray(a) for a in args]
    (y, h), vjp = jax.vjp(scan, *jargs)
    want = vjp((y, 2 * h))             # the cotangents of _loss
    _, _, hseg = jscan._forward(*jargs, din_tile=128, time_chunk=tc,
                                interpret=True)
    ts = [torch.from_numpy(a) for a in args]
    got = ref.selective_scan_bwd_ref(
        *ts[:6], *(torch.from_numpy(np.array(t)) for t in (hseg, y, 2 * h)),
        time_chunk=tc)
    _assert_grads_close(got, want, BWD_TOL)
    _assert_grads_close(_port_grads(args, tc), want, BWD_TOL)


def test_trainable_scan_grads_match_autodiff_of_recurrence():
    """test_selective_scan_custom_vjp on the port: the wrapper's gradients
    against jax.grad of the reference recurrence, at that test's 2e-3."""
    B, L, din, n = 2, 64, 128, 8
    args = _vjp_inputs(0, B, L, din, n)
    want = jax.grad(lambda *a: _loss(*_jax_recurrence(*a)),
                    argnums=tuple(range(7)))(*map(jnp.asarray, args))
    for name, g, w in zip(GRADS, _port_grads(args, 16), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-3, err_msg=name)


def test_ops_bwd_casts_and_dispatches_to_the_plain_version():
    """ops.selective_scan_bwd on CPU tensors is the plain version, with
    its inputs cast to float32; the time chunk is clamped to L."""
    B, L, din, n = 1, 24, 128, 8
    args = [torch.from_numpy(a) for a in _vjp_inputs(4, B, L, din, n)]
    y, h, hseg = ops.selective_scan(*args, time_chunk=512)
    cot = (torch.ones_like(y), torch.zeros_like(h))
    got = ops.selective_scan_bwd(*(t.double() for t in args[:6]), hseg,
                                 *cot, time_chunk=512)
    want = ref.selective_scan_bwd_ref(*args[:6], hseg, *cot, time_chunk=L)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
