"""The port's training path on the CPU against the JAX package.

The reduced falcon-mamba-7b (4 layers, d_model 128, d_inner 256, n 16,
vocab 512) in float32 with ``ssm_impl="pallas"``: the reference's scan and
its backward run as Pallas kernels in interpret mode, the port's as their
plain versions. Inputs come from seeded numpy RNGs or from the
reference's weights (``params_from_jax``), never from either framework's
own random numbers.

Tolerances, with their reasons (``max |port - ref| <= tol * max |ref|``
unless stated):
  * loss, z-loss, grad norm, token counts and the loss CI state: 1e-5
    relative. The same float32 operations; matmuls and the sums over the
    batch, the vocabulary and the parameters run in other orders
    (measured <= 3e-7);
  * parameters and AdamW moments after 1-3 steps: 1e-4. The gradients
    agree to ~1e-6, but the update ``m / (sqrt(v) + eps)`` is ~lr · sign(g)
    for gradients near zero, whatever their size, so those elements carry
    the gradients' relative noise into the parameters undamped (measured
    1.9e-5 after three steps at lr 5e-3);
  * a Mamba1 block's gradients, pallas path against xla path: 1e-5 (both
    the same float32 recurrence on the CPU; only the scan's sums over the
    states differ in order); against the reference's gradients, 1e-4;
  * microbatches 2 against 1: the reference's own test's bounds (2e-4
    absolute on parameters, 1e-3 relative on the loss).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import state as jstate
from repro.data import tokens as jtokens
from repro.models import build as jax_build
from repro.models import ssm as jax_ssm
from repro.models import zoo as jzoo
from repro.train import OptConfig as JOptConfig
from repro.train import build_train_step as jax_build_train_step
from repro.train import init_state as jax_init_state
from repro.train import optimizer as jopt
from repro_torch.configs import ArchConfig, ShapeConfig, get
from repro_torch.core import state as tstate
from repro_torch.data import tokens
from repro_torch.models import build, convert, ssm, zoo
from repro_torch.train import (OptConfig, abstract_state, build_train_step,
                               init_state)
from repro_torch.train import optimizer as topt
from tests.helpers.torch_parity import one_torch_thread  # noqa: F401

SCALARS, PARAMS, BLOCK, BLOCK_REF = 1e-5, 1e-4, 1e-5, 1e-4
SHAPE = (2, 64)                           # batch, sequence length
OPT = dict(lr=5e-3, warmup_steps=1, total_steps=100)


def _close(got, want, tol, what=""):
    got = got.detach().to(torch.float32).numpy() \
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    assert err <= tol * scale, f"{what}: max abs {err} > {tol} * {scale}"


def _jcfg(**kw):
    return dataclasses.replace(jax_get("falcon_mamba_7b", reduced=True),
                               param_dtype="float32",
                               compute_dtype="float32", ssm_impl="pallas",
                               **kw)


def _port(jcfg):
    return ArchConfig(**dataclasses.asdict(jcfg))


def _batches(cfg, step):
    """The step's batch from both packages' ``train_batch``."""
    B, T = SHAPE
    jb = jtokens.train_batch(cfg, JShapeConfig("t", T, B, "train"), step)
    return ({k: jnp.asarray(v) for k, v in jb.items()},
            {k: torch.from_numpy(v) for k, v in jb.items()})


# -- state algebra, data, schedule --------------------------------------------


@pytest.mark.parametrize("axis", [None, 1])
def test_moments_of_batch_and_merge_match_reference(axis):
    rng = np.random.default_rng(axis or 0)
    v = rng.normal(50.0, 3.0, (4, 37)).astype(np.float32)
    m = rng.random((4, 37)) < 0.6
    m[2] = False                           # an empty row
    got = tstate.moments_of_batch(torch.from_numpy(v), torch.from_numpy(m),
                                  axis=axis)
    want = jstate.moments_of_batch(jnp.asarray(v), jnp.asarray(m), axis=axis)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SCALARS)
    got2 = tstate.moments_of_batch(torch.from_numpy(v[::-1].copy()),
                                   axis=axis)
    want2 = jstate.moments_of_batch(jnp.asarray(v[::-1].copy()), axis=axis)
    for g, w in zip(tstate.merge_moments(got, got2),
                    jstate.merge_moments(want, want2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SCALARS)


@pytest.mark.parametrize("step", [0, 7])
def test_train_batch_matches_reference(step):
    jcfg = jax_get("falcon_mamba_7b", reduced=True)
    want = jtokens.train_batch(jcfg, JShapeConfig("t", 48, 3, "train"), step,
                               seed=5)
    got = tokens.train_batch(_port(jcfg), ShapeConfig("t", 48, 3, "train"),
                             step, seed=5)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_lr_schedule_matches_reference():
    ocfg = dict(lr=3e-4, warmup_steps=20, total_steps=200)
    for step in (0, 1, 10, 20, 21, 100, 199, 200, 500):
        want = jopt.lr_at(JOptConfig(**ocfg), jnp.asarray(step, jnp.int32))
        got = topt.lr_at(OptConfig(**ocfg), torch.tensor(step))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- the Mamba1 block and the loss --------------------------------------------


def test_mamba1_apply_grads_pallas_vs_xla_and_reference():
    """test_mamba1_pallas_path_is_differentiable on the port: gradients of
    one block, through the scan's backward (``pallas``) and through
    autograd of the plain recurrence (``xla``), on the reference's
    weights; both against the reference's ``pallas`` gradients."""
    jcfg = dataclasses.replace(_jcfg(), d_model=64, ssm_state=8)
    p = jax_ssm.mamba1_init(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(0).normal(0, 1, (2, 64, 64)).astype(np.float32)
    want = jax.grad(lambda q: (jax_ssm.mamba1_apply(
        q, jcfg, jnp.asarray(x)) ** 2).mean())(p)
    grads = {}
    for impl in ("pallas", "xla"):
        cfg = _port(dataclasses.replace(jcfg, ssm_impl=impl))
        blk = ssm.mamba1_init(cfg, torch.Generator().manual_seed(0))
        blk.load_state_dict(convert.params_from_jax(
            jax.tree.map(np.asarray, p), cfg))
        (ssm.mamba1_apply(blk, cfg, torch.from_numpy(x)) ** 2).mean() \
            .backward()
        grads[impl] = {k: t.grad for k, t in blk.named_parameters()}
    assert grads["pallas"].keys() == want.keys()
    for k, w in want.items():
        _close(grads["pallas"][k], grads["xla"][k].numpy(), BLOCK, k)
        _close(grads["pallas"][k], w, BLOCK_REF, k)


@pytest.fixture(scope="module")
def lm_pair():
    """The reduced LM in both packages on the reference's weights."""
    jcfg = _jcfg()
    cfg = _port(jcfg)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build(cfg)
    lm = m.init(0, device="cpu")
    lm.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                               cfg))
    return jcfg, jm, jp, m, lm


def test_model_loss_matches_reference(lm_pair):
    """Loss, metrics and the per-token loss CI state; targets carry the
    ignored -1 of train_batch's first position."""
    jcfg, jm, jp, m, lm = lm_pair
    jb, tb = _batches(jcfg, 3)
    assert (tb["targets"] < 0).any()
    want, wmet = jm.loss(jp, jb)
    got, gmet = m.loss(lm, tb)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=SCALARS)
    for k in ("loss", "z_loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(gmet[k]), float(wmet[k]),
                                   rtol=SCALARS, atol=1e-12, err_msg=k)
    for f, g, w in zip(tstate.MomentState._fields, gmet["loss_ci_state"],
                       wmet["loss_ci_state"]):
        np.testing.assert_allclose(float(g), float(w), rtol=SCALARS,
                                   err_msg=f)
    assert zoo.Z_LOSS_COEF == jzoo.Z_LOSS_COEF
    assert zoo.MOE_AUX_COEF == jzoo.MOE_AUX_COEF


def test_remat_changes_no_gradient(lm_pair):
    """Per-layer rematerialisation recomputes each layer (the scan
    kernel twice a layer) and changes neither the loss nor a gradient."""
    jcfg, _, _, m, lm = lm_pair
    _, tb = _batches(jcfg, 1)
    out = []
    for remat in (True, False):
        mr = build(dataclasses.replace(m.cfg, remat=remat))
        loss, _ = mr.loss(lm, tb)
        out.append((loss, torch.autograd.grad(loss, list(lm.parameters()))))
    (l1, g1), (l0, g0) = out
    assert torch.equal(l1, l0)
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)


# -- train steps --------------------------------------------------------------


def _ref_state_after_one_step(jcfg, ocfg):
    """The reference's state after its first step (step 0: lr 0), so the
    steps compared move every parameter and moment."""
    jm = jax_build(jcfg)
    st = jax_init_state(jm, jax.random.PRNGKey(0), ocfg)
    st, _ = jax.jit(jax_build_train_step(jm, ocfg))(st, _batches(jcfg, 0)[0])
    return jm, st


@pytest.mark.parametrize("steps,micro", [(1, 1), (3, 1), (1, 2)])
def test_train_steps_match_reference(steps, micro):
    """From the reference's state carried across by train_state_from_jax:
    each step's loss, grad norm, lr and the loss CI state, and after the
    last step every parameter, AdamW moment and the step counter."""
    jcfg = _jcfg(microbatches=micro)
    cfg = _port(jcfg)
    jocfg, ocfg = JOptConfig.for_arch(jcfg, **OPT), OptConfig.for_arch(
        cfg, **OPT)
    jm, js = _ref_state_after_one_step(jcfg, jocfg)
    jstep = jax.jit(jax_build_train_step(jm, jocfg))
    m = build(cfg)
    st = convert.train_state_from_jax(jax.tree.map(np.asarray, js), cfg,
                                      m.init(0, device="cpu"))
    assert int(st["step"]) == 1
    step = build_train_step(m, ocfg)
    for i in range(1, steps + 1):
        jb, tb = _batches(jcfg, i)
        js, wmet = jstep(js, jb)
        st, gmet = step(st, tb)
        for k in ("loss", "z_loss", "grad_norm", "lr", "total_loss",
                  "tokens"):
            np.testing.assert_allclose(float(gmet[k]), float(wmet[k]),
                                       rtol=SCALARS, err_msg=f"{k} @ {i}")
        for g, w in zip(gmet["loss_ci_state"], wmet["loss_ci_state"]):
            np.testing.assert_allclose(float(g), float(w), rtol=SCALARS)
    assert int(st["step"]) == int(js["step"]) == steps + 1
    want = jax.tree.map(np.asarray, js)
    for part, got in (("params", dict(st["params"].named_parameters())),
                      ("m", st["opt"]["m"]), ("v", st["opt"]["v"])):
        tree = want["params"] if part == "params" else want["opt"][part]
        ref = convert.params_from_jax(tree, cfg)
        assert got.keys() == ref.keys()
        for name, t in got.items():
            _close(t, ref[name].numpy(), PARAMS, f"{part}.{name}")


def test_microbatches_match_full():
    """test_microbatched_grads_match_full on the port: one step with the
    batch in 2 microbatches (float32 gradient accumulation) against one
    pass over the whole batch."""
    cfg = _port(_jcfg())
    ocfg = OptConfig.for_arch(cfg, **OPT)
    _, tb = _batches(cfg, 1)
    out = []
    for micro in (1, 2):
        model = build(dataclasses.replace(cfg, microbatches=micro))
        st = init_state(model, 0, ocfg, device="cpu")
        st["step"] += 1                   # lr > 0
        st, met = build_train_step(model, ocfg)(st, tb)
        out.append((st, met))
    (s1, m1), (s2, m2) = out
    worst = max(float((a - b).detach().abs().max()) for a, b in zip(
        s1["params"].parameters(), s2["params"].parameters()))
    assert worst < 2e-4, worst
    assert np.isclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-3)
    assert float(m2["loss_ci_state"].count) == float(
        m1["loss_ci_state"].count)


def test_adafactor_one_step_matches_reference():
    """Two Adafactor updates of the port against the reference's
    ``optimizer.apply`` on the reference's leaves: each scan-stacked layer
    parameter as one ``(n_layers, ...)`` leaf (``optimizer.leaves``),
    the rest as they are. Parameters, the factored and unfactored second
    moments (a layer vector factored across layers), grad norm and lr."""
    cfg = _port(_jcfg(optimizer="adafactor"))
    lm = build(cfg).init(0, device="cpu")
    rng = np.random.default_rng(0)
    params = {k: p.detach().numpy().copy() for k, p in lm.named_parameters()}
    grads = [{k: rng.normal(0, s, p.shape).astype(np.float32)
              for k, p in params.items()} for s in (1e-2, 3e-2)]
    groups = topt.leaves(params)
    assert any(len(ms) == cfg.n_layers > 1 for ms in groups.values())

    def stacked(tree):
        return {leaf: jnp.asarray(np.stack([tree[n] for n in ms])
                                  if len(ms) > 1 or ms[0] != leaf
                                  else tree[ms[0]])
                for leaf, ms in groups.items()}
    ocfg = dict(name="adafactor", **OPT)
    jp = stacked(params)
    js = jopt.init(jp, JOptConfig(**ocfg))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.init(tp, OptConfig(**ocfg))
    for part in ("vr", "vc"):
        assert {k: tuple(v.shape) for k, v in ts[part].items()} == \
            {k: tuple(v.shape) for k, v in js[part].items()}
    japply = jax.jit(jopt.apply, static_argnames="ocfg")
    for step, g in enumerate(grads):
        jp, js, wmet = japply(jp, stacked(g), js,
                              jnp.asarray(step, jnp.int32),
                              ocfg=JOptConfig(**ocfg))
        tp, ts, gmet = topt.apply(tp, {k: torch.from_numpy(v) for k, v in
                                       g.items()}, ts, torch.tensor(step),
                                  OptConfig(**ocfg))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(gmet[k]), float(wmet[k]),
                                       rtol=SCALARS)
    for leaf, ms in groups.items():
        got = torch.stack([tp[n] for n in ms]) if ms[0] != leaf else tp[leaf]
        _close(got, jp[leaf], PARAMS, leaf)
        _close(ts["vr"][leaf], js["vr"][leaf], PARAMS, f"vr.{leaf}")
        _close(ts["vc"][leaf], js["vc"][leaf], PARAMS, f"vc.{leaf}")


def _adafactor_pair():
    """The reduced config (4 scan-stacked layers) under Adafactor: the
    reference's model and fresh state, and the port's model."""
    jcfg = _jcfg(optimizer="adafactor")
    jocfg = JOptConfig.for_arch(jcfg, **OPT)
    jm = jax_build(jcfg)
    js = jax_init_state(jm, jax.random.PRNGKey(0), jocfg)
    return jcfg, jocfg, jm, js, _port(jcfg)


def _check_adafactor_state(st, js, cfg):
    """Every stacked ``vr`` / ``vc`` of the port's state against the
    reference's tree, by leaf name."""
    want = jax.tree.map(np.asarray, js)["opt"]
    for part in ("vr", "vc"):
        ref = dict(convert._flatten(want[part]))
        assert st["opt"][part].keys() == ref.keys(), part
        for leaf, w in ref.items():
            _close(st["opt"][part][leaf], w, PARAMS, f"{part}.{leaf}")


@pytest.mark.parametrize("moved", [False, True])
def test_adafactor_stacked_state_converts(moved):
    """The reference's stacked Adafactor state (fresh from ``init_state``,
    and after one step, when the moments are no longer zero) converts:
    a layer vector's moments keep their ``(n_layers,)`` / ``(d,)``
    shapes, and every ``vr`` / ``vc`` equals the reference's."""
    jcfg, jocfg, jm, js, cfg = _adafactor_pair()
    assert cfg.n_layers >= 2
    if moved:
        js, _ = jax.jit(jax_build_train_step(jm, jocfg))(
            js, _batches(jcfg, 0)[0])
    st = convert.train_state_from_jax(jax.tree.map(np.asarray, js), cfg,
                                      build(cfg).init(0, device="cpu"))
    assert tuple(st["opt"]["vr"]["layers.mamba.D"].shape) == \
        (cfg.n_layers,)
    assert tuple(st["opt"]["vc"]["layers.mamba.D"].shape) == \
        (cfg.d_inner,)
    _check_adafactor_state(st, js, cfg)
    if moved:
        assert float(st["opt"]["vr"]["layers.mamba.D"].abs().max()) > 0


def test_adafactor_train_steps_match_reference():
    """Two reference ``train_step``s against two port steps from the
    reference's stacked Adafactor ``init_state`` and the same batches:
    loss, grad norm and lr at each step, then every parameter and every
    stacked ``vr`` / ``vc``."""
    jcfg, jocfg, jm, js, cfg = _adafactor_pair()
    m = build(cfg)
    st = convert.train_state_from_jax(jax.tree.map(np.asarray, js), cfg,
                                      m.init(0, device="cpu"))
    jstep = jax.jit(jax_build_train_step(jm, jocfg))
    step = build_train_step(m, OptConfig.for_arch(cfg, **OPT))
    for i in range(2):
        jb, tb = _batches(jcfg, i)
        js, wmet = jstep(js, jb)
        st, gmet = step(st, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(gmet[k]), float(wmet[k]),
                                       rtol=SCALARS, atol=1e-12,
                                       err_msg=f"{k} @ {i}")
    assert int(st["step"]) == int(js["step"]) == 2
    ref = convert.params_from_jax(jax.tree.map(np.asarray, js)["params"],
                                  cfg)
    got = dict(st["params"].named_parameters())
    assert got.keys() == ref.keys()
    for name, t in got.items():
        _close(t, ref[name].numpy(), PARAMS, name)
    _check_adafactor_state(st, js, cfg)


def test_abstract_state_allocates_nothing_and_matches_init():
    cfg = get("falcon_mamba_7b", reduced=True)
    model = build(cfg)
    ocfg = OptConfig.for_arch(cfg)
    ab = abstract_state(model, ocfg)
    real = init_state(model, 0, ocfg, device="cpu")
    assert {p.device.type for p in ab["params"].parameters()} == {"meta"}
    for (k, a), (_, r) in zip(ab["params"].named_parameters(),
                              real["params"].named_parameters()):
        assert a.shape == r.shape and a.dtype == r.dtype, k
    for part in ("m", "v"):
        assert {k: (v.shape, v.dtype) for k, v in ab["opt"][part].items()} \
            == {k: (v.shape, v.dtype) for k, v in real["opt"][part].items()}
    assert ab["step"].dtype == real["step"].dtype == torch.int32
