"""Training of the dense, MoE, hybrid and enc-dec families, and the
``"dots"`` remat policy, on the CPU against the JAX package.

Reduced configs in float32 (4 layers, d_model 128, vocab 512; zamba2 7
layers, seamless 2 + 2), the reference's weights and optimizer state
carried across by ``train_state_from_jax``, the same ``train_batch``
tokens in both packages.

Tolerances (``max |port - ref| <= tol * max |ref|``), those of
``tests/test_torch_train.py`` and for its reasons:
  * loss, z-loss, grad norm, lr, tokens and the loss CI state: 1e-5;
  * optimizer moments after three steps: 1e-4;
  * parameters after three steps: 1e-4, Adafactor's; AdamW's plus what
    its unit-size update carries over from each element's own first
    moment (``tests/helpers/torch_train_parity.py``). Measured at lr
    5e-3: qwen2.5's key biases, whose gradient is a small difference of
    large sums (the score shift a bias adds is nearly the same for every
    key), reach 1.3e-4 of the leaf's largest where that element's first
    moment is 7.6e-5 off; three embedding elements of seamless 6.4e-4;
  * the remat policies against no remat: bit for bit (the same
    operations on the same inputs; remat only chooses what is kept).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro.configs import get as jax_get
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import tokens as jtokens
from repro.models import build as jax_build
from repro.train import OptConfig as JOptConfig
from repro.train import build_train_step as jax_build_train_step
from repro.train import init_state as jax_init_state
from repro.train import optimizer as jopt
from repro_torch.configs import ArchConfig, ShapeConfig, get
from repro_torch.data import tokens
from repro_torch.models import build, convert
from repro_torch.train import OptConfig, build_train_step
from repro_torch.train import optimizer as topt
from tests.helpers.torch_parity import one_torch_thread  # noqa: F401
from tests.helpers.torch_train_parity import (close_adamw_params,
                                              moments_of)

SCALARS, PARAMS = 1e-5, 1e-4
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


def _jcfg(arch_id, **kw):
    return dataclasses.replace(jax_get(arch_id, reduced=True),
                               param_dtype="float32",
                               compute_dtype="float32", **kw)


def _batches(cfg, step):
    B, T = SHAPE
    jb = jtokens.train_batch(cfg, JShapeConfig("t", T, B, "train"), step)
    return ({k: jax.numpy.asarray(v) for k, v in jb.items()},
            {k: torch.from_numpy(v) for k, v in jb.items()})


# -- (c) three training steps a family -----------------------------------------


@pytest.mark.parametrize("arch_id", ["qwen2_5_3b", "dbrx_132b", "zamba2_7b",
                                     "seamless_m4t_large_v2"])
def test_train_steps_match_reference(arch_id):
    """From the reference's state after its first step (lr 0 at step 0),
    three steps in both packages on the same batches, with the config's
    own optimizer (dbrx: Adafactor over its stacked ``(n_layers, E, d,
    ff)`` experts): each step's metrics, then every parameter and every
    optimizer moment."""
    jcfg = _jcfg(arch_id)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    jocfg = JOptConfig.for_arch(jcfg, **OPT)
    jm = jax_build(jcfg)
    jstep = jax.jit(jax_build_train_step(jm, jocfg))
    js = jax_init_state(jm, jax.random.PRNGKey(0), jocfg)
    js, _ = jstep(js, _batches(jcfg, 0)[0])
    m = build(cfg)
    st = convert.train_state_from_jax(jax.tree.map(np.asarray, js), cfg,
                                      m.init(0, device="cpu"))
    step = build_train_step(m, OptConfig.for_arch(cfg, **OPT))
    trace = []                  # AdamW: (lr, port moments, ref moments)
    for i in range(1, 4):
        jb, tb = _batches(jcfg, i)
        js, wmet = jstep(js, jb)
        st, gmet = step(st, tb)
        if cfg.optimizer == "adamw":
            wo = jax.tree.map(np.asarray, js["opt"])
            trace.append((float(wmet["lr"]), moments_of(st["opt"]),
                          {k: convert.params_from_jax(wo[k], cfg)
                           for k in ("m", "v")}))
        for k in ("loss", "z_loss", "aux_loss", "grad_norm", "lr",
                  "total_loss", "tokens"):
            np.testing.assert_allclose(float(gmet[k]), float(wmet[k]),
                                       rtol=SCALARS, atol=1e-12,
                                       err_msg=f"{k} @ {i}")
        for g, w in zip(gmet["loss_ci_state"], wmet["loss_ci_state"]):
            np.testing.assert_allclose(float(g), float(w), rtol=SCALARS)
    assert int(st["step"]) == int(js["step"]) == 4
    want = jax.tree.map(np.asarray, js)
    ref = convert.params_from_jax(want["params"], cfg)
    got = dict(st["params"].named_parameters())
    assert got.keys() == ref.keys()
    if cfg.optimizer == "adamw":
        for name, t in got.items():
            close_adamw_params(t, ref[name].numpy(), [
                (lr, *mine[name][:1], ref_m["m"][name].numpy(),
                 *mine[name][1:], ref_m["v"][name].numpy())
                for lr, mine, ref_m in trace], PARAMS, name)
    else:
        for name, t in got.items():
            _close(t, ref[name].numpy(), PARAMS, name)
    if cfg.optimizer == "adafactor":
        assert tuple(st["opt"]["vr"]["layers.moe.w_up"].shape) == (
            cfg.n_layers, cfg.n_experts, cfg.d_model)
        for part in ("vr", "vc"):
            wp = dict(convert._flatten(want["opt"][part]))
            assert st["opt"][part].keys() == wp.keys(), part
            for leaf, w in wp.items():
                _close(st["opt"][part][leaf], w, PARAMS, f"{part}.{leaf}")
        return
    for part in ("m", "v"):
        wp = convert.params_from_jax(want["opt"][part], cfg)
        assert st["opt"][part].keys() == wp.keys(), part
        for name, t in st["opt"][part].items():
            _close(t, wp[name].numpy(), PARAMS, f"{part}.{name}")


@pytest.mark.parametrize("arch_id", ["zamba2_7b", "seamless_m4t_large_v2"])
def test_adafactor_update_on_every_layer_layout(arch_id):
    """Two Adafactor updates of the port against the reference's
    ``optimizer.apply`` on the reference's own parameter tree, from
    seeded gradients: the leaves are the reference's stacks (the
    hybrid's ``(n_groups, period, ...)`` layers and its tail, the
    enc-dec's encoder and decoder stacks; dbrx's experts are held by
    :func:`test_train_steps_match_reference`), so every ``vr`` / ``vc``
    and every parameter must match."""
    jcfg = _jcfg(arch_id, optimizer="adafactor")
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    lm = build(cfg).init(0, device="cpu")
    lm.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                               cfg))
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda p: rng.normal(0, s, p.shape).astype(
        np.float32), jax.tree.map(np.asarray, jp)) for s in (1e-2, 3e-2)]
    ocfg = dict(name="adafactor", **OPT)
    js = jopt.init(jp, JOptConfig(**ocfg))
    tp = dict(lm.named_parameters())
    ts = topt.init(tp, OptConfig(**ocfg))
    for part in ("vr", "vc"):
        want = {k: v.shape for k, v in convert._flatten(js[part])}
        assert {k: tuple(v.shape) for k, v in ts[part].items()} == want
    japply = jax.jit(jopt.apply, static_argnames="ocfg")
    for step, g in enumerate(grads):
        jp, js, wmet = japply(jp, g, js, jnp.asarray(step, jnp.int32),
                              ocfg=JOptConfig(**ocfg))
        tp, ts, gmet = topt.apply(tp, convert.params_from_jax(g, cfg), ts,
                                  torch.tensor(step), OptConfig(**ocfg))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(gmet[k]), float(wmet[k]),
                                       rtol=SCALARS)
    ref = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    for name, t in tp.items():
        _close(t, ref[name].numpy(), PARAMS, name)
    for part in ("vr", "vc"):
        for leaf, w in convert._flatten(jax.tree.map(np.asarray,
                                                     js[part])):
            _close(ts[part][leaf], w, PARAMS, f"{part}.{leaf}")


# -- (b) the "dots" remat policy ---------------------------------------------------


class _Matmuls(TorchDispatchMode):
    """Counts the unbatched matrix products dispatched under it: ``mm``,
    ``addmm`` and a ``bmm`` of batch 1."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        if func in (aten.mm.default, aten.addmm.default) or (
                func is aten.bmm.default and args[0].shape[0] == 1):
            self.count += 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(cfg, lm, batch):
    """Loss, gradients, and the unbatched matmuls of the forward and of
    the backward. The checkpoint's early stop is off, so that a
    recompute runs its layer to the end."""
    m = build(cfg)
    fwd, bwd = _Matmuls(), _Matmuls()
    with set_checkpoint_early_stop(False):
        with fwd:
            loss, _ = m.loss(lm, batch)
        with bwd:
            grads = torch.autograd.grad(loss, list(lm.parameters()))
    return loss, grads, fwd.count, bwd.count


@pytest.mark.parametrize("batch", [2, 1])
@pytest.mark.parametrize("arch_id", ["falcon_mamba_7b", "qwen2_5_3b",
                                     "dbrx_132b"])
def test_remat_policies_change_no_gradient(arch_id, batch):
    """Gradients under ``"dots"``, ``"nothing"`` and no remat are bit for
    bit equal; the backward under ``"nothing"`` recomputes every forward
    matmul, under ``"dots"`` none (it keeps their outputs, the
    reference's ``dots_with_no_batch_dims_saveable``). Batch 1 gives
    the einsums of batch 1 that lower to ``bmm``."""
    base = dataclasses.replace(get(arch_id, reduced=True),
                               param_dtype="float32",
                               compute_dtype="float32")
    shape = ShapeConfig("t", SHAPE[1], batch, "train")
    tb = {k: torch.from_numpy(v) for k, v in
          tokens.train_batch(base, shape, 0).items()}
    lm = build(base).init(0, device="cpu")
    runs = {name: _loss_and_grads(dataclasses.replace(base, **kw), lm, tb)
            for name, kw in (("none", dict(remat=False)),
                             ("nothing", dict(remat=True,
                                              remat_policy="nothing")),
                             ("dots", dict(remat=True,
                                           remat_policy="dots")))}
    loss0, g0, fwd, bwd = runs["none"]
    assert fwd > 0
    for name in ("nothing", "dots"):
        loss, grads, f, _ = runs[name]
        assert f == fwd, name
        assert torch.equal(loss, loss0), name
        for a, b in zip(grads, g0):
            assert torch.equal(a, b), name
    # every forward matmul but the output head's, which is outside the
    # layers
    assert runs["nothing"][3] == bwd + fwd - 1
    assert runs["dots"][3] == bwd
