"""The Mamba1 ``xla`` path's chunked associative scan on the CPU against
the JAX package.

``repro_torch.models.ssm.associative_scan`` follows
``jax.lax.associative_scan``'s recursion (pairs, the scan of the pairs,
the even fill, the interleave), so its roundings are the reference's:
the scan alone is compared bit for bit in float32 and bfloat16, and
against the sequential recurrence in float32. Then one block of the
reduced falcon-mamba-7b (d_model 128, d_inner 256, n 16, chunk 32) with
``ssm_impl="xla"``, its output and its gradients, against the
reference's on the reference's weights, with the scan in float32 and in
bfloat16, at L 64 (two chunks) and L 20 (one chunk of odd halves).

Tolerances (``max |port - ref| <= tol * max |ref|``):
  * float32 block output 1e-5 and gradients 1e-4, those of
    ``tests/test_torch_train.py`` (the same operations; the projections'
    and the state sum's matmuls add in other orders);
  * bfloat16 scan: the output and the gradients 1.5e-2, the bf16
    precedent of ``tests/test_torch_models.py``; and the port's distance
    from its own float32 scan at most 1.5x the reference's distance from
    the reference's float32 scan (the precedent of
    ``tests/test_torch_hybrid_encdec.py``);
  * the scan against the sequential recurrence: 1e-5 (float32, other
    association orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import ssm as jax_ssm
from repro_torch.configs import ArchConfig
from repro_torch.models import convert, ssm
from tests.helpers.torch_parity import one_torch_thread  # noqa: F401

F32_OUT, F32_GRAD, BF16, RECUR = 1e-5, 1e-4, 1.5e-2, 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _decay_and_u(L: int, seed: int):
    rng = np.random.default_rng(seed)
    d = np.exp(-rng.uniform(0, 0.3, (2, L, 8, 4))).astype(np.float32)
    u = rng.normal(0, 1, (2, L, 8, 4)).astype(np.float32)
    return d, u


def _jcomb(a, b):
    da, ua = a
    db, ub = b
    return (da * db, ub + db * ua)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [1, 2, 7, 20, 64, 256])
def test_associative_scan_bitwise_reference(L, dtype):
    d, u = _decay_and_u(L, L)
    jd, ju = (jnp.asarray(a).astype(dtype) for a in (d, u))
    want = jax.jit(lambda a, b: jax.lax.associative_scan(
        _jcomb, (a, b), axis=1))(jd, ju)
    tdt = getattr(torch, dtype)
    got = ssm.associative_scan(ssm._comb, [torch.from_numpy(d).to(tdt),
                                           torch.from_numpy(u).to(tdt)],
                               dim=1)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("L", [1, 5, 64, 100])
def test_associative_scan_matches_recurrence(L):
    d, u = _decay_and_u(L, 100 + L)
    got_d, got_u = ssm.associative_scan(
        ssm._comb, [torch.from_numpy(d), torch.from_numpy(u)], dim=1)
    h = np.zeros_like(u[:, 0], dtype=np.float64)
    dec = np.ones_like(h)
    hs, decs = [], []
    for t in range(L):
        h = d[:, t] * h + u[:, t]
        dec = dec * d[:, t]
        hs.append(h)
        decs.append(dec)
    assert _rel(got_u, np.stack(hs, 1)) <= RECUR
    assert _rel(got_d, np.stack(decs, 1)) <= RECUR


def _block(scan_dtype: str):
    """One reduced falcon-mamba block in float32 on the ``xla`` path, the
    scan in ``scan_dtype``: (reference cfg, params, port cfg, block)."""
    jcfg = dataclasses.replace(jax_get("falcon_mamba_7b", reduced=True),
                               param_dtype="float32",
                               compute_dtype="float32", ssm_impl="xla",
                               ssm_scan_dtype=scan_dtype)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    jp = jax_ssm.mamba1_init(jax.random.PRNGKey(0), jcfg)
    p = ssm.mamba1_init(cfg, torch.Generator().manual_seed(0))
    p.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                              cfg))
    return jcfg, jp, cfg, p


def _run_both(scan_dtype: str, L: int):
    """Output and gradients (of the mean square of the output, over the
    parameters and the input) of one block in both packages."""
    jcfg, jp, cfg, p = _block(scan_dtype)
    x = np.random.default_rng(L).normal(0, 1, (2, L, cfg.d_model)).astype(
        np.float32)

    def jloss(q, xx):
        y = jax_ssm.mamba1_apply(q, jcfg, xx)
        return (y ** 2).mean(), y
    (_, want), (wg, wgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(
        jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ssm.mamba1_apply(p, cfg, xt)
    (got ** 2).mean().backward()
    grads = {k: t.grad for k, t in p.named_parameters()}
    grads["x"] = xt.grad
    wants = dict(wg, x=wgx)
    return got, want, grads, wants


@pytest.mark.parametrize("L", [64, 20])
@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16"])
def test_mamba1_xla_apply_and_grad_match_reference(scan_dtype, L):
    got, want, grads, wants = _run_both(scan_dtype, L)
    f32 = scan_dtype == "float32"
    assert _rel(got, want) <= (F32_OUT if f32 else BF16)
    assert grads.keys() == wants.keys()
    for k, w in wants.items():
        assert _rel(grads[k], w) <= (F32_GRAD if f32 else BF16), k


@pytest.mark.parametrize("L", [64, 20])
def test_bf16_scan_is_as_close_to_float32_as_reference(L):
    """The port's bf16 scan sits no further from its float32 scan than
    1.5x the reference's bf16 scan from the reference's float32 scan, on
    the output and on every gradient."""
    g32, w32, gg32, wg32 = _run_both("float32", L)
    g16, w16, gg16, wg16 = _run_both("bfloat16", L)
    assert _rel(g16, g32) <= 1.5 * _rel(w16, w32)
    for k in wg32:
        assert _rel(gg16[k], gg32[k]) <= 1.5 * max(_rel(wg16[k], wg32[k]),
                                                   1e-7), k


def test_mamba1_xla_decode_step_in_bf16_scan_dtype():
    """Decode runs one step of the same core: with the scan in bf16 it
    matches the reference's decode (the state carried in float32)."""
    jcfg, jp, cfg, p = _block("bfloat16")
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)
    conv = rng.normal(0, 1, (2, cfg.ssm_conv - 1, cfg.d_inner)).astype(
        np.float32)
    h = rng.normal(0, 1, (2, cfg.d_inner, cfg.ssm_state)).astype(np.float32)
    want, wc = jax_ssm.mamba1_decode(jp, jcfg, jnp.asarray(x),
                                     {"conv": jnp.asarray(conv),
                                      "h": jnp.asarray(h)})
    with torch.inference_mode():
        got, gc = ssm.mamba1_decode(p, cfg, torch.from_numpy(x),
                                    {"conv": torch.from_numpy(conv),
                                     "h": torch.from_numpy(h)})
    assert _rel(got, want) <= BF16
    assert gc["h"].dtype == torch.float32
    assert _rel(gc["h"], wc["h"]) <= BF16
